"""The Hopper kernels against their plain versions, on the card, and
training on the card against training on the CPU.

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


def _level_inputs(n, F, B, n_prev, dev, seed):
    """A level boundary: bins (u8, or u16 with the missing slot B - 1 for
    B = 257), gpair, int64 positions at the previous level of ``n_prev``
    nodes with strays above it, and that level's splits (20% of its nodes
    do not split)."""
    from xgboost_tpu_torch.ops.partition import LevelSplits

    bins, g, _ = _hist_inputs(n, F, B, 1, dev, seed)
    rng = np.random.RandomState(seed + 1)
    lo_prev = n_prev - 1
    pos = rng.randint(lo_prev, lo_prev + n_prev, n)
    pos[rng.rand(n) < 0.1] = rng.randint(0, max(lo_prev, 1))   # strays
    cs = rng.rand(n_prev) < 0.8
    prev = LevelSplits(
        lo_prev,
        torch.from_numpy(np.where(cs, rng.randint(0, F, n_prev), -1)).to(dev),
        torch.from_numpy(np.where(cs, rng.randint(0, B - 1, n_prev),
                                  0)).to(dev),
        torch.from_numpy(cs & (rng.rand(n_prev) < 0.5)).to(dev),
        torch.from_numpy(cs).to(dev))
    return bins, g, torch.from_numpy(pos).to(dev), prev


@pytest.mark.cuda
@pytest.mark.parametrize("n_prev,B", [(1, 256), (8, 256), (64, 256),
                                      (32, 257)])
def test_fused_advance_coarse_matches_plain_version_on_the_card(n_prev, B):
    """K5 against its plain version on the card: positions and coarse
    histogram equal bit for bit on two launches, and the histogram equal
    to K2 over the coarse ids of the advanced rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    dev = torch.device("cuda")
    bins, g, pos, prev = _level_inputs(200_003, 28, B, n_prev, dev,
                                       seed=n_prev + B)
    lo, N = 2 * n_prev - 1, 2 * n_prev
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(g)
    want_pos, want = H.fused_advance_coarse_reference(
        bins, q, inv, pos, prev, lo, N, missing)
    for _ in range(2):
        got_pos, got = K.fused_advance_coarse_cuda(bins, q, inv, pos, prev,
                                                   lo, N, missing)
        torch.cuda.synchronize()
        assert torch.equal(got_pos, want_pos)
        assert torch.equal(got, want)
    k2 = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q,
                            level_rel(want_pos, lo, N), inv, N, COARSE_B)
    assert torch.equal(k2, want)


@pytest.mark.cuda
@pytest.mark.parametrize("N,B", [(1, 256), (128, 256), (64, 257)])
def test_coarse_fold_matches_plain_version_on_the_card(N, B):
    """K4's int32 accumulators equal the plain ones, so their fold does;
    the folded coarse histogram equals K2's direct build over the coarse
    ids bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    dev = torch.device("cuda")
    bins, g, rel = _hist_inputs(200_003, 28, B, N, dev, seed=3 * N + B)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(g)
    fine, acc = K.hist_scan_cuda(bins, q, rel, inv, N, B, with_acc=True)
    want = H.scan_acc_reference(bins, q, rel, N, B)
    torch.cuda.synchronize()
    assert torch.equal(acc, want)
    assert torch.equal(fine, H.dequant_int8x2(want, inv))
    folded = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    direct = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q, rel, inv,
                                N, COARSE_B)
    assert torch.equal(folded, direct)


@pytest.mark.cuda
def test_two_level_training_on_the_card():
    """``fused`` on the card equals ``fused`` on the CPU in its first tree
    (equal gradients, equal integer histograms); on the card ``coarse``,
    ``fused`` and ``scan`` save the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(6)
    X = rng.randn(70000, 28).astype(np.float32)
    y = (X[:, :4].sum(1) + rng.randn(70000) > 0).astype(np.float32)
    X[rng.rand(70000, 28) < 0.05] = np.nan
    params = {"objective": "binary:logistic", "max_depth": 6,
              "base_score": 0.5}
    raws = []
    for method in ("coarse", "fused", "scan"):
        bst = xt.train(dict(params, hist_method=method),
                       xt.DMatrix(X, label=y), 3, verbose_eval=False)
        bst.set_param({"hist_method": "scan"})
        raws.append(bytes(bst.save_raw("ubj")))
        if method == "fused":
            gpu = bst
    assert raws[0] == raws[1] == raws[2]
    cpu = xt.train(dict(params, hist_method="fused", device="cpu"),
                   xt.DMatrix(X, label=y), 3, verbose_eval=False)
    a, b = gpu.gbm.trees[0], cpu.gbm.trees[0]
    np.testing.assert_array_equal(a.split_feature, b.split_feature)
    np.testing.assert_array_equal(a.split_bin, b.split_bin)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gpu.predict(xt.DMatrix(X)),
                               cpu.predict(xt.DMatrix(X)), atol=1e-3)
