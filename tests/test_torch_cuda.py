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
    for bit, on two launches. For K2 and K3, N = 1 and N = 4 at 17 bins
    fit one tile (rows in their own order, split over many blocks); the
    others take one node a tile over rows sorted by node."""
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
    """K4's coarse fold, taken in the kernel from each node's integer
    sums, equals the plain fold of the plain accumulators and K2's direct
    build over the coarse ids bit for bit, at u8/256 and u16/257 with the
    missing slot; the fine histogram beside it equals the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    dev = torch.device("cuda")
    bins, g, rel = _hist_inputs(200_003, 28, B, N, dev, seed=3 * N + B)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(g)
    acc = H.scan_acc_reference(bins, q, rel, N, B)
    want = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    for _ in range(2):
        fine, coarse = K.hist_scan_cuda(bins, q, rel, inv, N, B,
                                        with_coarse=True, missing_bin=missing)
        torch.cuda.synchronize()
        assert torch.equal(fine, H.dequant_int8x2(acc, inv))
        assert torch.equal(coarse, want)
    direct = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q, rel, inv,
                                N, COARSE_B)
    assert torch.equal(coarse, direct)


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


def _level(n, N, B, seed, skew):
    """Rows at a level of N nodes over B slots (u8 ids, or u16 with a
    missing slot at 257). ``skew``: node 1 holds 55% of the rows and nodes
    0, 2 and 5 none; at 20 and 36 slots, 85% of the ids on the last slot
    (the missing slot, or the refine ids' slot for rows outside their
    window)."""
    dev = torch.device("cuda")
    bins, g, rel = _hist_inputs(n, 28, B, N, dev, seed)
    if skew:
        rng = np.random.RandomState(seed + 1)
        r = rel.cpu().numpy()
        r[np.isin(r, (0, 2, 5)) & (r < N)] = 3 % N
        r[rng.rand(n) < 0.55] = 1 % N
        rel = torch.from_numpy(r).to(dev)
        if B in (20, 36):
            b = bins.cpu().numpy()
            b[rng.rand(*b.shape) < 0.85] = B - 1
            bins = torch.from_numpy(b).to(dev)
    return bins, g, rel


@pytest.mark.cuda
@pytest.mark.parametrize("n,N,B,skew", [
    (200_003, 256, 256, False), (200_003, 512, 256, False),
    (200_003, 256, 257, False), (200_003, 512, 257, False),
    (1_000_000, 512, 256, True), (10, 512, 256, False),
    (10, 256, 257, True)])
def test_k3_matches_plain_version_on_the_card(n, N, B, skew):
    """K3 at the levels of 256 and 512 nodes (u8 and 257-slot u16), a
    skewed level whose big node spans many blocks, and levels of 10 rows:
    equal to ``build_hist_f32_reference`` bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    bins, g, rel = _level(n, N, B, 7 * N + B + n % 97, skew)
    qs, inv = H.fixed_point_scale(g)
    want = H.build_hist_f32_reference(bins, g, rel, qs, inv, N, B)
    for _ in range(2):
        got = K.hist_f32_cuda(bins, g, rel, qs, inv, N, B)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
@pytest.mark.parametrize("n,N,B,skew", [
    (200_003, 512, 256, False), (200_003, 512, 257, True),
    (1_000_000, 128, 256, False), (1_000_000, 128, 256, True),
    (1_000_000, 1, 256, False), (10, 4, 256, False)])
def test_k3_rounded_precisions_match_plain_versions_on_the_card(
        precision, n, N, B, skew):
    """K3's bf16 and bf16x2 precisions: each row's (g, h) rounded to
    bfloat16 on the card as the plain version rounds it on the card,
    and the sums equal ``build_hist_f32_reference(precision=)`` bit for
    bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    bins, g, rel = _level(n, N, B, 11 * N + B + n % 89, skew)
    qs, inv = H.fixed_point_scale(g)
    want = H.build_hist_f32_reference(bins, g, rel, qs, inv, N, B,
                                      precision=precision)
    cpu = H.build_hist_f32_reference(bins.cpu(), g.cpu(), rel.cpu(),
                                     qs.cpu(), inv.cpu(), N, B,
                                     precision=precision)
    for _ in range(2):
        got = K.hist_f32_cuda(bins, g, rel, qs, inv, N, B,
                              precision=precision)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(want.cpu(), cpu)


@pytest.mark.cuda
def test_multiclass_sampled_training_on_the_card_equals_the_cpu():
    """A 5-class forest with row and column sampling: the masks and row
    samples are drawn on the card with the same bits as on the CPU, so
    the first round's trees agree split for split. The root's gradient
    sum is an f32 reduction taken in another order on each device, and a
    right child's sum is its parent's minus the left one, so a leaf of a
    class whose sums nearly cancel carries that difference (measured on
    the card: 1.4e-4, 0.13% of its leaf): leaves are held at rtol 1e-3
    plus 1e-4, predictions within 1e-3 as in the binary test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.tree.grow import draw_feature_masks
    from xgboost_tpu_torch.tree.param import TrainParam
    from xgboost_tpu_torch.utils import random as xrandom

    keys = [xrandom.fold_in(xrandom.key(3), i) for i in range(7)]
    p = TrainParam(colsample_bytree=0.8, colsample_bylevel=0.9,
                   colsample_bynode=0.7)
    base = torch.ones(54, dtype=torch.bool)
    base[[4, 9]] = False
    on_card = draw_feature_masks(keys, base.cuda(), p, 8)
    on_cpu = draw_feature_masks(keys, base, p, 8)
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
    u = xrandom.uniform(keys[0], (1 << 20,), device="cuda")
    assert torch.equal(u.cpu(), xrandom.uniform(keys[0], (1 << 20,)))
    rng = np.random.RandomState(8)
    X = rng.randn(70000, 20).astype(np.float32)
    y = np.argmax(X[:, :5] + rng.randn(70000, 5), axis=1).astype(np.float32)
    params = {"objective": "multi:softprob", "num_class": 5, "max_depth": 5,
              "subsample": 0.8, "colsample_bytree": 0.8,
              "colsample_bynode": 0.8}
    gpu = xt.train(params, xt.DMatrix(X, label=y), 2, verbose_eval=False)
    cpu = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y), 2,
                   verbose_eval=False)
    for a, b in zip(gpu.gbm.trees[:5], cpu.gbm.trees[:5]):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-3,
                                   atol=1e-4)
    np.testing.assert_allclose(
        gpu.predict(xt.DMatrix(X), iteration_range=(0, 1)),
        cpu.predict(xt.DMatrix(X), iteration_range=(0, 1)), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 16, 128])
@pytest.mark.parametrize("B", [256, 20, 36])
@pytest.mark.parametrize("n,skew", [(1_000_000, False), (1_000_000, True),
                                    (10, False)])
def test_k2_matches_plain_version_on_the_card(n, skew, B, N):
    """K2 at N = 1, 16 and 128 over 256 slots, the 20 coarse slots and the
    36 refine slots; on evenly spread and on skewed levels (one node with
    55% of the rows, three empty, 85% of the ids on the last slot) and on
    a level of 10 rows: equal to ``build_hist_int8x2_reference`` bit for
    bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    bins, g, rel = _level(n, N, B, 11 * N + B + n % 89, skew)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, N, B)
    for _ in range(2):
        got = K.hist_int8x2_cuda(bins, q, rel, inv, N, B)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 16, 128])
@pytest.mark.parametrize("B", [256, 257])
@pytest.mark.parametrize("n,skew", [(1_000_000, False), (1_000_000, True),
                                    (10, False)])
def test_k4_matches_plain_version_on_the_card(n, skew, B, N):
    """K4 at N = 1, 16 and 128 over u8/256 and u16/257 slots, on evenly
    spread and skewed levels (one node with 55% of the rows, three empty)
    and on a level of 10 rows: the fine histogram equal to
    ``build_hist_scan_reference`` and, with the fold, the coarse one equal
    to the plain fold of the plain accumulators, bit for bit on two
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    bins, g, rel = _level(n, N, B, 13 * N + B + n % 83, skew)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(g)
    acc = H.scan_acc_reference(bins, q, rel, N, B)
    want = H.dequant_int8x2(acc, inv)
    want_c = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    for _ in range(2):
        fine = K.hist_scan_cuda(bins, q, rel, inv, N, B)
        fine2, coarse = K.hist_scan_cuda(bins, q, rel, inv, N, B,
                                         with_coarse=True,
                                         missing_bin=missing)
        torch.cuda.synchronize()
        assert torch.equal(fine, want)
        assert torch.equal(fine2, want)
        assert torch.equal(coarse, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("n_prev,B", [(2, 256), (4, 257), (64, 256),
                                      (64, 257)])
@pytest.mark.parametrize("n", [1_000_000, 10])
def test_fused_advance_coarse_skewed_level_on_the_card(n, n_prev, B):
    """K5 below a skewed level (55% of the rows at node 1 of the previous
    level, nodes 0 and 2 empty), so that one new node holds most rows and
    several none: at one group (N = 4, 8) and sorted (N = 128), u8/256 and
    u16/257, and on 10 rows; positions and coarse histogram equal the
    plain version bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    bins, g, pos, prev = _level_inputs(n, 28, B, n_prev, dev,
                                       seed=5 * n_prev + B + n % 7)
    rng = np.random.RandomState(n_prev + B)
    p = pos.cpu().numpy()
    lo_prev = n_prev - 1
    big = lo_prev + 1 % n_prev
    p[(p == lo_prev) | (p == lo_prev + 2)] = big    # empty nodes 0 and 2
    p[rng.rand(n) < 0.55] = big
    pos = torch.from_numpy(p).to(dev)
    prev = prev._replace(can_split=torch.ones_like(prev.can_split),
                         feat=prev.feat.clamp(min=0))
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


def _k1_forest(kind, seed=21):
    """(forest, X, base) at a small size: ``one`` group, ``three`` groups,
    ``cat`` (categorical splits on features 1 and 4), ``deep`` (depth 15:
    its trees overflow the staged schedule's chunk buffer), ``wide``
    (1,100 features, read from global memory in both schedules),
    ``single`` (one tree, Tp = 1, the training's eval walk)."""
    n_trees, depth, F, G, cats = {
        "one": (70, 6, 7, 1, ()), "three": (45, 5, 7, 3, ()),
        "cat": (40, 6, 7, 2, (1, 4)), "deep": (6, 15, 9, 1, ()),
        "wide": (33, 6, 1100, 1, ()), "single": (1, 8, 7, 1, ())}[kind]
    trees, info = make_forest(n_trees, depth, F, n_groups=G,
                              cat_features=cats, seed=seed)
    pf = PackedForest.from_trees(trees, info, G)
    rng = np.random.RandomState(seed + 1)
    X = rng.randn(10_000, F).astype(np.float32)
    for c in cats:
        X[:, c] = rng.randint(-2, 20, 10_000)
        X[rng.rand(10_000) < 0.1, c] = rng.choice([-0.5, 1e10, 16.0, 15.7],
                                                1)
    X[rng.rand(10_000, F) < 0.1] = np.nan
    return pf, X, np.linspace(-0.5, 0.5, G).astype(np.float32)


def _k1_check(pf, X, base, schedule):
    """K1 on ``schedule`` against the plain walk's leaf indices and, bit
    for bit, against the kernel-order fold of their leaf values."""
    from xgboost_tpu_torch.ops.walk import walk_fold_kernel_order

    dev = X.device
    d = pf.device_arrays(dev)
    got, gl = pf.margin(X, base, leaf_index=True, schedule=schedule)
    _, wl = walk_packed_reference(
        d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
        d["group_onehot"], X, base, d.get("cat_words"),
        max_depth=pf.max_depth, tree_chunk=tree_step(X.shape[0]),
        leaf_index=True)
    want = walk_fold_kernel_order(d["values"][wl.long()], d["tree_weight"],
                                  d["tree_group"], base)
    torch.cuda.synchronize()
    assert torch.equal(gl, wl)
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one", "three", "cat", "wide", "single"])
@pytest.mark.parametrize("schedule", ["spread", "staged"])
def test_k1_schedules_equal_the_fold_replica_on_the_card(kind, schedule):
    """Each schedule of K1: leaf indices equal the plain walk's, margins
    equal ``walk_fold_kernel_order`` bit for bit, at 1, 33 and 10,000
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops.cuda import walk as W

    pf, X, base = _k1_forest(kind)
    dev = torch.device("cuda")
    Xd, bd = torch.from_numpy(X).to(dev), torch.from_numpy(base).to(dev)
    before = W.SCHEDULE_LAUNCHES[schedule]
    for n in (1, 33, 10_000):
        _k1_check(pf, Xd[:n].contiguous(), bd, schedule)
    assert W.SCHEDULE_LAUNCHES[schedule] - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one", "three", "cat"])
def test_k1_row_margin_does_not_depend_on_the_batch_on_the_card(kind):
    """A row's margin has the same bits alone, inside 64 rows (spread),
    inside 10,000 (the plan's staged schedule) and forced onto either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pf, X, base = _k1_forest(kind, seed=31)
    dev = torch.device("cuda")
    Xd, bd = torch.from_numpy(X).to(dev), torch.from_numpy(base).to(dev)
    row = 17
    alone = pf.margin(Xd[row:row + 1].contiguous(), bd)
    for n, schedule in ((64, None), (10_000, None), (10_000, "spread"),
                        (64, "staged")):
        m = pf.margin(Xd[:n].contiguous(), bd, schedule=schedule)
        torch.cuda.synchronize()
        assert torch.equal(m[row], alone[0]), (n, schedule)


@pytest.mark.cuda
def test_k1_plan_routes_on_the_card():
    """The plan's schedule is the one launched: 10,000 rows staged, 64
    rows spread, the deep forest spread at 10,000 rows (its trees do not
    fit a chunk buffer, and forcing staged raises), the one-tree eval
    walk staged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops.cuda import walk as W

    dev = torch.device("cuda")
    for kind, n, want in (("one", 10_000, "staged"), ("one", 64, "spread"),
                          ("deep", 10_000, "spread"),
                          ("single", 10_000, "staged")):
        pf, X, base = _k1_forest(kind, seed=41)
        Xd, bd = torch.from_numpy(X[:n]).to(dev), torch.from_numpy(
            base).to(dev)
        before = dict(W.SCHEDULE_LAUNCHES)
        _k1_check(pf, Xd, bd, None)
        after = W.SCHEDULE_LAUNCHES
        assert after[want] - before[want] == 1, (kind, n)
        assert sum(after.values()) - sum(before.values()) == 1
    pf, X, base = _k1_forest("deep", seed=41)
    with pytest.raises(ValueError, match="does not fit"):
        pf.margin(torch.from_numpy(X).to(dev), torch.from_numpy(base).to(dev),
                  schedule="staged")


def _u4_level(n, F, N, dev, seed, skew=False, B=16):
    """A level over u4-packed pages: bins < B, packed as the paged tier
    packs them (``PagedBinnedMatrix._pack_host``), and the unpacked ids."""
    from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    g = rng.randn(n, 2).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1])
    rel = rng.randint(0, N, n).astype(np.int32)
    if skew:
        rel[np.isin(rel, (0, 2, 5))] = 3 % N
        rel[rng.rand(n) < 0.55] = 1 % N
        bins[rng.rand(n, F) < 0.6] = B - 1
    rel[rng.rand(n) < 0.1] = N                     # inactive rows
    packed = PagedBinnedMatrix._pack_host(bins)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (packed, bins, g, rel))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [27, 28])
@pytest.mark.parametrize("N", [1, 16, 128, 512])
@pytest.mark.parametrize("skew", [False, True])
def test_u4_bodies_match_plain_versions_on_the_card(F, N, skew):
    """K2's and K3's ``packed_u4`` bodies (K3 in f32, bf16x2 and bf16)
    over a u4-packed page of odd and even F: equal bit for bit to their
    plain versions (unpack, then the plain build) and to the same kernel
    on the unpacked ids, on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    packed, bins, g, rel = _u4_level(200_003, F, N, dev, 13 * N + F, skew)
    assert torch.equal(H.unpack_u4(packed, F), bins)
    B = 16
    if N <= 128:
        q, inv = H.quantise_int8x2(g)
        want = H.build_hist_int8x2_u4_reference(packed, F, q, rel, inv, N, B)
        before = K.LAUNCHES["hist_int8x2_u4"]
        for _ in range(2):
            got = K.hist_int8x2_cuda(packed, q, rel, inv, N, B, packed_u4=F)
            flat = K.hist_int8x2_cuda(bins, q, rel, inv, N, B)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(flat, want)
        assert K.LAUNCHES["hist_int8x2_u4"] == before + 2
    qs, inv3 = H.fixed_point_scale(g)
    for precision in ("f32", "bf16x2", "bf16"):
        want = H.build_hist_f32_u4_reference(packed, F, g, rel, qs, inv3, N,
                                             B, precision=precision)
        for _ in range(2):
            got = K.hist_f32_cuda(packed, g, rel, qs, inv3, N, B,
                                  precision=precision, packed_u4=F)
            flat = K.hist_f32_cuda(bins, g, rel, qs, inv3, N, B,
                                   precision=precision)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(flat, want)


def _batches(X, y, n_batches, cache_prefix):
    """A ``DataIter`` over a fixed matrix in batches."""
    import xgboost_tpu_torch as xt

    class Batches(xt.DataIter):
        def __init__(self):
            super().__init__(cache_prefix)
            self.parts = np.array_split(np.arange(len(X)), n_batches)
            self.i = 0

        def next(self, input_data):
            if self.i >= len(self.parts):
                return 0
            idx = self.parts[self.i]
            input_data(data=X[idx], label=y[idx])
            self.i += 1
            return 1

        def reset(self):
            self.i = 0

    return Batches()


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [15, 64])
def test_paged_training_on_the_card_equals_the_cpu(max_bin, tmp_path,
                                                   monkeypatch):
    """External-memory training on the card (pages of 19,999 rows, so
    that every other page's gradients start off a 16-byte boundary; K2 or
    K2-u4 per page; a budget of two pages, so that pages are both cached
    and streamed through the ring) against the same on the CPU: the
    first tree's structure bit for bit, predictions at 1e-3; the budget
    of 0 saves the same bytes on the card. The first tree's leaves are
    held to 1e-5: the root sum is ``gpair.sum``, an f32 reduction in a
    different order on each device, and every node's sum is the root's
    less its siblings', so the leaves may differ in their last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    monkeypatch.setenv("XTPU_PAGE_ROWS", "19999")
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    rng = np.random.RandomState(8)
    X = rng.randn(90000, 27).astype(np.float32)
    y = (X[:, :4].sum(1) + rng.randn(90000) > 0).astype(np.float32)
    X[rng.rand(90000, 27) < 0.05] = np.nan
    params = {"objective": "binary:logistic", "max_depth": 6,
              "base_score": 0.5, "max_bin": max_bin}
    raws = {}
    for budget in (2, 0):
        monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES",
                           str(budget * 20000 * (14 if max_bin < 16 else 27)))
        dm = xt.QuantileDMatrix(
            _batches(X, y, 4, str(tmp_path / f"c{budget}")), max_bin=max_bin)
        paged = dm.binned(max_bin, torch.device("cuda"))
        assert paged.is_paged and paged.packed == (max_bin < 16)
        gpu = xt.train(params, dm, 3, verbose_eval=False)
        raws[budget] = bytes(gpu.save_raw("ubj"))
        assert paged.cached_pages(torch.device("cuda")) == budget
        if budget == 2:
            first = gpu
    assert raws[0] == raws[2]
    dm = xt.QuantileDMatrix(_batches(X, y, 4, str(tmp_path / "cpu")),
                            max_bin=max_bin)
    cpu = xt.train(dict(params, device="cpu"), dm, 3, verbose_eval=False)
    a, b = first.gbm.trees[0], cpu.gbm.trees[0]
    np.testing.assert_array_equal(a.split_feature, b.split_feature)
    np.testing.assert_array_equal(a.split_bin, b.split_bin)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(first.predict(xt.DMatrix(X)),
                               cpu.predict(xt.DMatrix(X)), atol=1e-3)


def _covtype_codes(n, seed):
    """[n, 12] f32 rows of 10 N(0, 1) columns and two category codes (4
    and 40 categories, NaN missing in a few), and 3-class labels."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 12).astype(np.float32)
    X[:, 10] = rng.randint(0, 4, n)
    soil = rng.randint(0, 40, n)
    X[:, 11] = soil
    X[rng.rand(n) < 0.02, 11] = np.nan
    score = X[:, 0] + rng.randn(40)[soil] + 0.5 * X[:, 10] \
        + 0.3 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, [0.4, 0.7])).astype(np.float32)
    return X, y


CODES_TYPES = ["q"] * 10 + ["c", "c"]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 16, 128])
def test_k2_over_category_codes_matches_plain_version_on_the_card(N):
    """K2 over a categorical matrix's bins (bin == category code: 4 and
    40 of the 257 slots beside 10 numeric features, a missing slot)
    against its plain version, bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    X, _ = _covtype_codes(300_007, seed=N)
    bm = xt.DMatrix(X, feature_types=CODES_TYPES,
                    enable_categorical=True).binned(256, dev)
    assert bm.cuts.n_real_bins()[10:].tolist() == [4, 40]
    rng = np.random.RandomState(N)
    g = torch.from_numpy(rng.randn(X.shape[0], 2).astype(np.float32)).to(dev)
    rel = torch.from_numpy(rng.randint(0, N + 1, X.shape[0]).astype(
        np.int32)).to(dev)
    q, inv = H.quantise_int8x2(g)
    B = bm.max_nbins
    want = H.build_hist_int8x2_reference(bm.bins, q, rel, inv, N, B)
    for _ in range(2):
        assert torch.equal(K.hist_int8x2_cuda(bm.bins, q, rel, inv, N, B),
                           want)


@pytest.mark.cuda
def test_k1_over_a_trained_categorical_dart_forest_on_the_card():
    """A categorical dart forest trained on the CPU (tree weights below
    1, left sets over 8 words) walked by K1 on both schedules: leaf
    indices equal the plain walk's, margins the kernel-order fold's bit
    for bit; Booster.predict on the card within 1e-6 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    X, y = _covtype_codes(20_000, seed=3)
    kw = dict(feature_types=CODES_TYPES, enable_categorical=True)
    params = {"objective": "multi:softprob", "num_class": 3,
              "max_depth": 6, "booster": "dart", "rate_drop": 0.5}
    cpu = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y, **kw),
                   6, verbose_eval=False)
    card = xt.Booster(model_file=cpu.save_raw("ubj"))
    pf = card.packed_forest()
    assert pf.has_cat and float(pf.tree_weight[:pf.n_trees].min()) < 1.0
    dev = torch.device("cuda")
    Xd = torch.from_numpy(X).to(dev)
    base = torch.from_numpy(card._base_np()).to(dev)
    for schedule in ("spread", "staged"):
        for n in (1, 512, 20_000):
            _k1_check(pf, Xd[:n].contiguous(), base, schedule)
    dm = xt.DMatrix(X, **kw)
    np.testing.assert_allclose(card.predict(dm), cpu.predict(dm), rtol=1e-6,
                               atol=1e-6)


def _ranking_inputs(seed):
    """Labels 0-4, scores and offsets of 60 queries of 1 to 300
    documents."""
    rng = np.random.RandomState(seed)
    sizes = np.concatenate([[1, 300], rng.randint(2, 120, 58)])
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(ptr[-1])
    y = rng.choice(5, n, p=(0.42, 0.33, 0.15, 0.07, 0.03)).astype(np.float32)
    return y, rng.randn(n).astype(np.float32), ptr


@pytest.mark.cuda
@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("method", ["mean", "topk"])
def test_ranking_gradient_on_the_card_equals_the_cpu(method, unbiased):
    """The LambdaRank gradient of two rounds on the card: the same bits in
    two runs (the rivals' sums go through ``ordered_scatter_sum``), and
    within rtol 1e-5 plus 4e-6 of the column's largest |value| of the
    CPU's (the rivals are the same draws; the sums' order differs), ti+ /
    tj- to rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.objective import get_objective

    y, s, ptr = _ranking_inputs(21)
    params = {"lambdarank_pair_method": method,
              "lambdarank_unbiased": str(unbiased).lower()}
    out = {}
    for run, dev in (("cpu", "cpu"), ("card", "cuda"), ("again", "cuda")):
        obj = get_objective("rank:ndcg", dict(params))
        yt = torch.from_numpy(y).to(dev)
        grads = []
        for it in range(2):
            st = torch.from_numpy(s + 0.5 * it).to(dev)[:, None]
            grads.append(obj.get_gradient(st, yt, None, it,
                                          group_ptr=ptr).cpu())
        out[run] = (grads, obj.ti_plus, obj.tj_minus)
    for a, b in zip(out["card"][0], out["again"][0]):
        assert torch.equal(a, b)
    for a, b in zip(out["card"][0], out["cpu"][0]):
        scale = b.abs().amax(dim=0, keepdim=True)
        assert ((a - b).abs() <= 1e-5 * b.abs() + 4e-6 * scale).all()
    if unbiased:
        np.testing.assert_allclose(out["card"][1], out["cpu"][1], rtol=1e-6)
        np.testing.assert_allclose(out["card"][2], out["cpu"][2], rtol=1e-6)


@pytest.mark.cuda
def test_ordered_scatter_sum_is_deterministic_on_the_card():
    """Rows summed at repeated targets on the card: two calls the same
    bits, and within f32 rounding of the CPU's sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.objective.ranking import ordered_scatter_sum

    rng = np.random.RandomState(22)
    idx = torch.from_numpy(rng.zipf(1.5, 2_000_000) % 50_000)
    vals = torch.from_numpy(rng.randn(2_000_000, 4).astype(np.float32))
    cpu = ordered_scatter_sum(idx, vals, 50_000)
    a = ordered_scatter_sum(idx.cuda(), vals.cuda(), 50_000)
    b = ordered_scatter_sum(idx.cuda(), vals.cuda(), 50_000)
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), cpu, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_ranking_training_on_the_card_equals_the_cpu():
    """Three rounds of ``rank:ndcg`` on the card: one model in two runs,
    predictions within 1e-5 plus 1e-4 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    y, _, ptr = _ranking_inputs(23)
    X = np.random.RandomState(24).randn(len(y), 12).astype(np.float32)
    X[:, 0] += y
    params = {"objective": "rank:ndcg", "max_depth": 5,
              "eval_metric": "ndcg@10"}
    dm = xt.DMatrix(X, label=y, group=np.diff(ptr))
    raws = [bytes(xt.train(params, dm, 3, verbose_eval=False).save_raw())
            for _ in range(2)]
    assert raws[0] == raws[1]
    cpu = xt.train(dict(params, device="cpu"), dm, 3, verbose_eval=False)
    card = xt.Booster(model_file=raws[0])
    np.testing.assert_allclose(card.predict(dm), cpu.predict(dm), rtol=1e-5,
                               atol=1e-4)


def _agaricus_files(tmp_path):
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    y, idx = agaricus_rows(6513 + 1611, seed=6)
    paths = []
    for name, s in (("train", slice(0, 6513)), ("test", slice(6513, None))):
        p = str(tmp_path / f"agaricus.txt.{name}")
        write_libsvm(p, y[s], idx[s])
        paths.append(p + "?format=libsvm")
    return paths


@pytest.mark.cuda
def test_agaricus_model_on_the_card_equals_the_cpu(tmp_path):
    """BASELINE config #1 (``reg:squarederror``, depth 2, ``eta`` 1) and
    the demo's ``binary:logistic`` from agaricus-shaped libsvm files: the
    card's trees are the CPU port's node for node (splits, bins, default
    directions), their float fields within rtol 1e-5 (the f32 sums over
    rows run in another order on each device, so the bytes may differ),
    the predictions within 1e-5; ``pred_leaf`` on the card equals the
    CPU's on the same model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    train, test = _agaricus_files(tmp_path)
    dtr, dte = xt.DMatrix(train), xt.DMatrix(test)
    for objective in ("reg:squarederror", "binary:logistic"):
        p = {"objective": objective, "max_depth": 2, "eta": 1.0}
        card = xt.train(p, dtr, 2, verbose_eval=False)
        cpu = xt.train(dict(p, device="cpu"), dtr, 2, verbose_eval=False)
        for a, b in zip(card.gbm.trees, cpu.gbm.trees):
            for f in ("is_leaf", "split_feature", "split_bin",
                      "default_left", "left_child", "right_child"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            for f in ("leaf_value", "split_value", "sum_hess", "gain",
                      "base_weight"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(card.predict(dte), cpu.predict(dte),
                                   rtol=1e-5, atol=1e-6)
        raw = card.save_raw("json")
        on_cpu = xt.Booster({"device": "cpu"}, model_file=raw)
        leaf = card.predict(dte, pred_leaf=True)
        assert leaf.shape == (1611, 2) and leaf.dtype == np.int32
        np.testing.assert_array_equal(leaf, on_cpu.predict(dte,
                                                           pred_leaf=True))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2])
def test_k2_at_the_agaricus_shape_on_the_card(tmp_path, N):
    """K2 over agaricus-shaped bins (F = 127, two slots: the one value and
    the missing slot) at the levels of a depth-2 tree: equal to
    ``build_hist_int8x2_reference`` bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    bm = xt.DMatrix(_agaricus_files(tmp_path)[0]).binned(256, dev)
    assert bm.max_nbins == 2 and bm.bins.shape == (6513, 127)
    _, g, rel = _hist_inputs(6513, 1, 2, N, dev, seed=40 + N)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bm.bins, q, rel, inv, N, 2)
    for _ in range(2):
        got = K.hist_int8x2_cuda(bm.bins, q, rel, inv, N, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.5, 0.02])
@pytest.mark.parametrize("B", [256, 257])
def test_k2_k4_at_the_lossguide_pair_on_the_card(share, B):
    """A lossguide split's build: N = 2 over every row, only ``share`` of
    them in the pair (the rest inactive, rel 2). K2 and K4 equal their
    plain version bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    dev = torch.device("cuda")
    bins, g, rel = _hist_inputs(1_000_000, 28, B, 2, dev, seed=B)
    keep = torch.rand(rel.shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    rel = torch.where(keep < share, rel % 2, torch.full_like(rel, 2))
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, 2, B)
    for _ in range(2):
        a = K.hist_int8x2_cuda(bins, q, rel, inv, 2, B)
        c = K.hist_scan_cuda(bins, q, rel, inv, 2, B)
        torch.cuda.synchronize()
        assert torch.equal(a, want)
        assert torch.equal(c, want)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["spread", "staged"])
def test_k1_on_a_deep_lossguide_forest_on_the_card(schedule):
    """K1 walks a leaf-wise forest (no depth limit, chains deeper than a
    heap of its leaves) bit for bit against the fold replica."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(11)
    X = rng.randn(20_000, 12).astype(np.float32)
    X[rng.rand(20_000, 12) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) ** 2 + np.nan_to_num(X[:, 1])
         > 1).astype(np.float32)
    bst = xt.train({"objective": "binary:logistic", "grow_policy":
                    "lossguide", "max_leaves": 64, "max_depth": 0,
                    "device": "cpu"}, xt.DMatrix(X, label=y), 8,
                   verbose_eval=False)
    assert max(t.max_depth() for t in bst.gbm.trees) > 8
    dev = torch.device("cuda")
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    Xd = torch.from_numpy(X).to(dev)
    for n in (1, 512, 20_000):
        _k1_check(pf, Xd[:n].contiguous(), base, schedule)


@pytest.mark.cuda
def test_lossguide_and_constraints_on_the_card_equal_the_cpu():
    """The first round's trees on the card equal the CPU's (equal
    gradients, equal integer histograms): lossguide through K4 and K2,
    and depthwise with both constraints."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(6)
    X = rng.randn(70_000, 10).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] + rng.randn(70_000) > 0).astype(
        np.float32)
    for n, extra in ((70_000, {"grow_policy": "lossguide", "max_leaves": 31,
                               "max_depth": 0}),
                     (20_000, {"grow_policy": "lossguide", "max_leaves": 31,
                               "max_depth": 0}),
                     (70_000, {"max_depth": 5,
                               "monotone_constraints": "(1,0,1)",
                               "interaction_constraints": "[[0, 1], [2]]"})):
        params = dict({"objective": "binary:logistic", "base_score": 0.5},
                      **extra)
        gpu = xt.train(params, xt.DMatrix(X[:n], label=y[:n]), 1,
                       verbose_eval=False)
        cpu = xt.train(dict(params, device="cpu"),
                       xt.DMatrix(X[:n], label=y[:n]), 1, verbose_eval=False)
        a, b = gpu.gbm.trees[0], cpu.gbm.trees[0]
        np.testing.assert_array_equal(a.left_child, b.left_child)
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 32])
@pytest.mark.parametrize("B", [256, 257])
def test_k2_at_the_mediamill_shape_on_the_card(N, B):
    """K2 at a MediaMill level (30,993 x 120; N = 32 is depth 6's last
    level) equals its plain version bit for bit on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    bins, g, rel = _hist_inputs(30_993, 120, B, N, torch.device("cuda"),
                                seed=N + B)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, N, B)
    for _ in range(2):
        got = K.hist_int8x2_cuda(bins, q, rel, inv, N, B)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["spread", "staged"])
def test_k1_at_101_groups_on_the_card(schedule):
    """K1 over a 101-group forest (one tree a label and round) at the
    12,914 MediaMill held-out rows, on both schedules, bit for bit
    against the fold replica."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    trees, info = make_forest(303, 6, 120, n_groups=101, seed=13)
    pf = PackedForest.from_trees(trees, info, 101)
    X = np.random.RandomState(14).randn(12_914, 120).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    base = torch.linspace(-2.0, 0.0, 101, device=dev)
    for n in (1, 512, 12_914):
        _k1_check(pf, Xd[:n].contiguous(), base, schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"multi_strategy": "multi_output_tree", "max_depth": 5},
    {"multi_strategy": "multi_output_tree", "grow_policy": "lossguide",
     "max_leaves": 16, "max_depth": 0},
    {"max_depth": 5}])
def test_multi_target_training_on_the_card_equals_the_cpu(extra):
    """A label matrix's first round on the card equals the CPU's (equal
    gradients, equal integer histograms): vector-leaf trees depthwise
    (K2 below 65,536 rows, K4 above) and leaf-wise, node for node with
    each target's weight, and one tree a target; the card's predictions
    [n, K] walk as the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(8)
    X = rng.randn(70_000, 10).astype(np.float32)
    Y = (X[:, :4] + rng.randn(70_000, 4) > 0.5).astype(np.float32)
    for n in (70_000, 20_000):
        params = dict({"objective": "binary:logistic", "base_score": 0.5},
                      **extra)
        gpu = xt.train(params, xt.DMatrix(X[:n], label=Y[:n]), 1,
                       verbose_eval=False)
        cpu = xt.train(dict(params, device="cpu"),
                       xt.DMatrix(X[:n], label=Y[:n]), 1, verbose_eval=False)
        assert len(gpu.gbm.trees) == len(cpu.gbm.trees)
        for a, b in zip(gpu.gbm.trees, cpu.gbm.trees):
            np.testing.assert_array_equal(a.left_child, b.left_child)
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            np.testing.assert_array_equal(a.split_bin, b.split_bin)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=1e-6)
        dm = xt.DMatrix(X[:2000])
        np.testing.assert_allclose(gpu.predict(dm), cpu.predict(dm),
                                   rtol=1e-5, atol=1e-6)


def _quantile_rows(n, weighted, seed=0):
    """Heteroscedastic regression rows (tests/test_torch_adaptive.py's
    shape): X [n, 6], y, weights or None."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + (0.5 + np.abs(X[:, 1])) * rng.normal(size=n)).astype(
        np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32) if weighted else None
    return X, y, w


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_leaf_refresh_on_the_card(weighted):
    """The adaptive leaf refresh on the card against the CPU port: the
    unweighted quantiles are the same float64 bits (every step its own
    op); the weighted running sums add in a scan's order on the card, so
    the f32 leaves are held within 1 ulp. Then a 3-alpha quantile model
    on both devices: the same trees, leaves within rtol 1e-5 plus
    1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.objective.adaptive import segment_quantiles

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 3000
    pos = rng.choice(np.asarray([1, 3, 4, 8, 11, 12]), n)
    res = rng.normal(size=n)
    w = rng.choice(np.asarray([0.1, 0.5, 1.0, 2.0, 0.3]), n) \
        if weighted else None
    args = [torch.from_numpy(pos), torch.from_numpy(res),
            None if w is None else torch.from_numpy(w),
            torch.from_numpy(np.asarray([1, 3, 4, 7, 8, 11, 12]))]
    for alpha in (0.05, 0.5, 0.95):
        cpu = segment_quantiles(*args, alpha)
        card = segment_quantiles(*[None if a is None else a.to(dev)
                                   for a in args], alpha).cpu()
        if weighted:
            np.testing.assert_array_max_ulp(card.float().numpy(),
                                            cpu.float().numpy(), maxulp=1)
        else:
            assert torch.equal(card, cpu)
    X, y, wt = _quantile_rows(3000, weighted)
    p = {"objective": "reg:quantileerror",
         "quantile_alpha": [0.05, 0.5, 0.95], "max_depth": 3, "eta": 0.3}
    bc = xt.train(p, xt.DMatrix(X, label=y, weight=wt), 3,
                  verbose_eval=False)
    bp = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y, weight=wt),
                  3, verbose_eval=False)
    for a, b in zip(bc.gbm.trees, bp.gbm.trees):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_survival_gradients_on_the_card():
    """AFT (three distributions, the four kinds of censoring) and Cox
    gradients on the card against the CPU port: AFT at rtol 1e-5 plus
    1e-6 (the card's f32 ``erf`` / ``exp``; left-censored rows far in
    the tail cancel, so an absolute floor of 1e-4 of the column's
    scale), Cox at rtol 1e-6 (float64 sums in a scan's order, cast to
    f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.objective import get_objective

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 4000
    t = np.exp(0.4 * rng.normal(size=n)).astype(np.float32)
    kind = np.arange(n) % 4
    lo, hi = t.copy(), t.copy()
    hi[kind == 1] = np.inf
    lo[kind == 2] = 0.0
    lo[kind == 3] *= 0.7
    hi[kind == 3] *= 1.6
    m = torch.from_numpy(rng.uniform(-1, 1, (n, 1)).astype(np.float32))
    b = (torch.from_numpy(lo), torch.from_numpy(hi))
    for dist in ("normal", "logistic", "extreme"):
        obj = get_objective("survival:aft", {"aft_loss_distribution": dist})
        cpu = obj.get_gradient(m, None, bounds=b)
        card = obj.get_gradient(m.to(dev), None,
                                bounds=tuple(x.to(dev) for x in b)).cpu()
        for c in range(2):
            scale = float(cpu[..., c].abs().max())
            torch.testing.assert_close(card[..., c], cpu[..., c], rtol=1e-5,
                                       atol=1e-4 * scale)
    y = torch.from_numpy(np.where(kind == 1, -t, t).astype(np.float32))
    cox = get_objective("survival:cox")
    torch.testing.assert_close(cox.get_gradient(m.to(dev), y.to(dev)).cpu(),
                               cox.get_gradient(m, y), rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["logistic", "integer"])
def test_device_sketch_equals_the_host_sketch_on_the_card(kind):
    """``WeightedSketch`` on the card (one sort when built, none a call)
    gives the host sketch's cuts bit for bit, on 200,000 rows with ties,
    NaNs, a constant and a categorical column; re-binning on the card
    equals ``BinnedMatrix.from_dense``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgboost_tpu_torch.data.binned import ApproxSource, BinnedMatrix
    from xgboost_tpu_torch.data.quantile import WeightedSketch, sketch_matrix

    rng = np.random.RandomState(12)
    n = 200_000
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 1] = rng.randint(0, 40, n)
    X[rng.rand(n) < 0.2, 2] = np.nan
    X[:, 3] = 1.5
    X[:, 4] = rng.randint(0, 9, n)
    types = ["q"] * 4 + ["c", "q"]
    if kind == "logistic":
        p = 1.0 / (1.0 + np.exp(-2 * rng.randn(n)))
        w = (p * (1 - p)).astype(np.float32)
    else:
        w = rng.randint(0, 4, n).astype(np.float32)
    dev = torch.device("cuda")
    Xd = torch.from_numpy(X).to(dev)
    wd = torch.from_numpy(w).to(dev)
    for max_bin in (16, 256):
        want = sketch_matrix(X, max_bin, w.astype(np.float64), types)
        got = WeightedSketch(Xd, max_bin, types).cuts(wd)[0]
        for k in ("values", "ptrs", "min_vals"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        bm = ApproxSource(Xd, max_bin, types).binned(wd)
        ref = BinnedMatrix.from_dense(X, bm.cuts, dev)
        assert bm.bins.dtype == ref.bins.dtype
        assert torch.equal(bm.bins, ref.bins)


@pytest.mark.cuda
def test_approx_and_exact_on_the_card_equal_the_cpu():
    """The first round's trees of ``approx`` (K4 over the re-binned
    matrix) and of ``exact`` on the card equal the CPU port's: the same
    cuts and splits, leaves at the f32 reassociation of their sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    rng = np.random.RandomState(13)
    X = rng.randn(70_000, 8).astype(np.float32)
    X[rng.rand(70_000, 8) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + rng.randn(70_000) > 0).astype(np.float32)
    for n, tm, depth in ((70_000, "approx", 6), (20_000, "approx", 6),
                         (5_000, "exact", 4)):
        params = {"objective": "binary:logistic", "base_score": 0.5,
                  "tree_method": tm, "max_depth": depth}
        gpu = xt.train(params, xt.DMatrix(X[:n], label=y[:n]), 1,
                       verbose_eval=False)
        cpu = xt.train(dict(params, device="cpu"),
                       xt.DMatrix(X[:n], label=y[:n]), 1, verbose_eval=False)
        a, b = gpu.gbm.trees[0], cpu.gbm.trees[0]
        np.testing.assert_array_equal(a.left_child, b.left_child)
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_value, b.split_value)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical",
                                  "dart", "lossguide"])
def test_shap_on_the_card_equals_the_cpu(name):
    """``Booster.predict``'s contributions, Saabas contributions and
    interactions computed on the card (``ops/shap.py`` in float64 there)
    against the same functions on the CPU: float64 sums in another
    order (cuBLAS's), so 1e-10 apart at most; f32 outputs within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops import shap as shap_ops

    rng = np.random.RandomState(15)
    X = rng.randn(1500, 7).astype(np.float32)
    X[:, 6] = rng.randint(0, 30, 1500)
    y = X[:, 0] * X[:, 1] + X[:, 2] + rng.randn(30)[X[:, 6].astype(int)]
    X[rng.rand(1500, 7) < 0.08] = np.nan
    params = {"objective": "binary:logistic", "max_depth": 4,
              "device": "cpu"}
    kw = {}
    if name == "multiclass":
        y = np.digitize(y, [-1.0, 1.0])
        params.update(objective="multi:softprob", num_class=3)
    elif name == "categorical":
        kw = {"feature_types": ["q"] * 6 + ["c"], "enable_categorical": True}
    elif name == "dart":
        params.update(booster="dart", rate_drop=0.5)
    elif name == "lossguide":
        params.update(grow_policy="lossguide", max_leaves=24, max_depth=0)
    if name != "multiclass":
        y = y > 0
    cpu = xt.train(params, xt.DMatrix(X, label=y.astype(np.float32), **kw),
                   4, verbose_eval=False)
    X = X[:200]
    gpu = xt.Booster(model_file=cpu.save_raw("json"))
    assert gpu.device.type == "cuda"
    for flags in ({"pred_contribs": True},
                  {"pred_contribs": True, "approx_contribs": True},
                  {"pred_interactions": True}):
        got = gpu.predict(xt.DMatrix(X, **kw), **flags)
        want = cpu.predict(xt.DMatrix(X, **kw), **flags)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pack = gpu._shap_pack(None)
    Xv = np.asarray(xt.DMatrix(X, **kw).values(), np.float32)
    base = gpu._base_np()
    for fn in (shap_ops.contribs, shap_ops.saabas, shap_ops.interactions):
        d = fn(pack, torch.from_numpy(Xv).cuda(), base)
        assert d.device.type == "cuda" and d.dtype == torch.float64
        h = fn(pack, torch.from_numpy(Xv), base)
        np.testing.assert_allclose(d.cpu().numpy(), h.numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("updater", ["shotgun", "coord_descent"])
def test_gblinear_on_the_card_equals_the_cpu(updater):
    """Ten rounds of each linear updater on the card (f32 products, no
    TF32) against the CPU: weights within 5e-6, relative and absolute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import xgboost_tpu_torch as xt

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(14)
    X = rng.randn(20_000, 28).astype(np.float32)
    X[rng.rand(20_000, 28) < 0.05] = np.nan
    y = (np.nan_to_num(X) @ rng.randn(28) > 0).astype(np.float32)
    p = {"booster": "gblinear", "objective": "binary:logistic",
         "updater": updater, "lambda": 1.0, "alpha": 0.0001, "eta": 0.5}
    gpu = xt.train(p, xt.DMatrix(X, label=y), 10, verbose_eval=False)
    cpu = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 10,
                   verbose_eval=False)
    assert gpu.gbm.W.device.type == "cuda"
    np.testing.assert_allclose(gpu.gbm.W.cpu().numpy(), cpu.gbm.W.numpy(),
                               rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(gpu.predict(xt.DMatrix(X)),
                               cpu.predict(xt.DMatrix(X)), rtol=5e-6,
                               atol=5e-6)
