"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: skips where ``torch.cuda.is_available()`` is False. It
imports no JAX, so it also runs on a GPU machine without it:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from xgboost_tpu_torch.ops.walk import walk_packed_reference
from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
from xgboost_tpu_torch.testing import make_forest


@pytest.mark.cuda
def test_cuda_kernel_matches_reference_on_the_card():
    """The Hopper kernel against its plain version on the card: equal
    leaf indices, margins within the f32 reassociation bound of a
    64-tree sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n_groups, cats in ((1, ()), (3, ()), (2, (1,))):
        trees, info = make_forest(64, 6, 7, n_groups=n_groups,
                                  cat_features=cats, seed=9)
        pf = PackedForest.from_trees(trees, info, n_groups)
        X = np.random.RandomState(10).randn(333, 7).astype(np.float32)
        X[:, 1] = np.floor(X[:, 1] * 8)
        X[::7, 2] = np.nan
        Xd = torch.from_numpy(X).to(dev)
        base = torch.linspace(-0.5, 0.5, n_groups, device=dev)
        got, gl = pf.margin(Xd, base, leaf_index=True)
        d = pf.device_arrays(dev)
        want, wl = walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], Xd, base, d.get("cat_words"),
            max_depth=pf.max_depth, tree_chunk=tree_step(333),
            leaf_index=True)
        torch.cuda.synchronize()
        assert torch.equal(gl, wl)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _hist_inputs(n, F, B, N, dev, seed):
    rng = np.random.RandomState(seed)
    dtype = torch.uint8 if B <= 256 else torch.uint16
    bins = torch.from_numpy(rng.randint(0, B, (n, F)).astype(np.int32)).to(
        dtype)
    g = rng.randn(n, 2).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1])
    rel = rng.randint(0, N, n).astype(np.int32)
    rel[rng.rand(n) < 0.1] = N                     # inactive rows
    return (bins.to(dev), torch.from_numpy(g).to(dev),
            torch.from_numpy(rel).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("N,B", [(1, 256), (4, 256), (16, 256), (128, 256),
                                 (64, 257), (4, 17)])
def test_hist_kernels_match_plain_versions_on_the_card(N, B):
    """K2, K3 and K4 against their plain versions on the card: equal bit
    for bit, on two launches. N = 1 and 4 (K3) and N = 16 (K2) take the
    shared-memory tiles, N = 128 the global atomics, N = 4 at 17 bins a
    tile of several nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    bins, g, rel = _hist_inputs(200_003, 28, B, N, dev, seed=N + B)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, N, B)
    assert torch.equal(H.build_hist_scan_reference(bins, q, rel, inv, N, B),
                       want)
    qs, inv3 = H.fixed_point_scale(g)
    want3 = H.build_hist_f32_reference(bins, g, rel, qs, inv3, N, B)
    for _ in range(2):
        a = K.hist_int8x2_cuda(bins, q, rel, inv, N, B)
        b = K.hist_f32_cuda(bins, g, rel, qs, inv3, N, B)
        c = K.hist_scan_cuda(bins, q, rel, inv, N, B)
        torch.cuda.synchronize()
        assert torch.equal(a, want)
        assert torch.equal(b, want3)
        assert torch.equal(c, want)


@pytest.mark.cuda
def test_training_on_the_card_equals_training_on_the_cpu():
    """The same rounds on the card and on the CPU. The first round sees
    equal gradients (margin 0) and equal integer histograms, so its tree
    agrees; later rounds' gradients differ by the devices' exp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(5)
    X = rng.randn(70000, 28).astype(np.float32)
    y = (X[:, :4].sum(1) + rng.randn(70000) > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 6,
              "base_score": 0.5}
    for n in (20000, 70000):                 # K2 levels, then K4 levels
        gpu = xt.train(params, xt.DMatrix(X[:n], label=y[:n]), 3,
                       verbose_eval=False)
        cpu = xt.train(dict(params, device="cpu"),
                       xt.DMatrix(X[:n], label=y[:n]), 3, verbose_eval=False)
        a, b = gpu.gbm.trees[0], cpu.gbm.trees[0]
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(gpu.predict(xt.DMatrix(X[:n])),
                                   cpu.predict(xt.DMatrix(X[:n])), atol=1e-3)
