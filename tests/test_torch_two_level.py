"""The port's pieces of the two-level coarse -> refine histogram schedules
(``hist_method`` ``coarse``, ``fused``, ``scan``) against the JAX
package, on the CPU, on inputs made from a seed with numpy: the split
helpers, the per-level advance, the plain version of kernel K5
(``fused_advance_coarse``) and K4's coarse fold.

Integer results are held bit for bit: coarse and refine ids, windows,
synthetic layouts, decoded bins, positions. The int8x2 histograms are
exact integer sums, so the plain K5 equals the JAX package's ``prehot``
build over the coarse ids bit for bit at any size, and the fold equals
the TPU's sorted kernel's (interpret mode), which sums in int32 too. The
TPU's fused kernel adds 2048-row (here 256-row) blocks of each coarse
bin's sums in f32: the plain K5 equals it bit for bit while those sums
stay below 2^24 quanta, and one input here shows the block adds round
above that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.ops import split as jsplit
from xgboost_tpu.ops.histogram import build_hist as jax_build_hist
from xgboost_tpu.ops.histogram import (
    fused_advance_coarse as jax_fused_advance_coarse)
from xgboost_tpu.ops.pallas.histogram import (fused_advance_coarse_pallas,
                                              scan_hist_pallas)
from xgboost_tpu.ops.partition import (advance_positions_level,
                                       update_positions as jax_update)
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.ops import split
from xgboost_tpu_torch.ops.histogram import (build_hist, coarse_fold,
                                             fused_advance_coarse,
                                             fused_advance_coarse_reference,
                                             int8x2_acc_reference,
                                             quantise_int8x2,
                                             scan_level_hists)
from xgboost_tpu_torch.ops.partition import (LevelSplits, advance_level,
                                             level_rel)
from xgboost_tpu_torch.tree.param import TrainParam

F = 5


def _bins(n, B, seed):
    """(bins, missing_bin): u8 without a missing slot for B <= 256, u16
    with the missing slot B - 1 (5% of the values) above."""
    rng = np.random.RandomState(seed)
    if B <= 256:
        return rng.randint(0, B, (n, F)).astype(np.uint8), B
    bins = rng.randint(0, B - 1, (n, F)).astype(np.uint16)
    bins[rng.rand(n, F) < 0.05] = B - 1
    return bins, B - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- split helpers ----------------------------------------------------------

@pytest.mark.parametrize("B", [64, 256, 257])
def test_coarse_and_refine_ids_match_jax(B):
    bins, missing = _bins(3000, B, seed=B)
    rng = np.random.RandomState(1)
    span = rng.randint(0, 15, (3000, F)).astype(np.int32)
    want = np.asarray(jsplit.coarse_bin_ids(jnp.asarray(bins, jnp.int32),
                                            missing))
    got = split.coarse_bin_ids(_t(bins), missing).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jsplit.refine_bin_ids(jnp.asarray(bins, jnp.int32),
                                            jnp.asarray(span), missing))
    got = split.refine_bin_ids(_t(bins), _t(span), missing).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,has_missing", [(256, False), (257, True),
                                           (65, True)])
def test_refine_from_fine_matches_jax(B, has_missing):
    rng = np.random.RandomState(B)
    N = 3
    fine = rng.randn(N, F, B, 2).astype(np.float32)
    window = rng.randint(0, 15, (N, F)).astype(np.int32)
    missing = B - 1 if has_missing else B
    want = np.asarray(jsplit.refine_from_fine(jnp.asarray(fine),
                                              jnp.asarray(window), missing))
    got = split.refine_from_fine(_t(fine), _t(window), missing).numpy()
    np.testing.assert_array_equal(got, want)


def _small_int_coarse(N, seed, has_missing):
    """A coarse histogram of small-integer (g, h) sums, so every
    cumulative sum is exact in f32 and both packages see equal gains up
    to the rounding of the gain formula itself."""
    rng = np.random.RandomState(seed)
    h = np.zeros((N, F, split.COARSE_B, 2), np.float32)
    h[:, :, :16, 0] = rng.randint(-20, 21, (N, F, 16))
    h[:, :, :16, 1] = rng.randint(0, 12, (N, F, 16))
    if has_missing:
        h[:, :, 19, 0] = rng.randint(-20, 21, (N, F))
        h[:, :, 19, 1] = rng.randint(0, 12, (N, F))
    return h, h[:, 0].sum(axis=1)                     # feature 0's total


@pytest.mark.parametrize("has_missing", [False, True])
def test_choose_refine_window_matches_jax(has_missing):
    N = 16
    hist_c, parent = _small_int_coarse(N, seed=int(has_missing),
                                       has_missing=has_missing)
    n_real = np.asarray([256, 40, 17, 16, 5], np.int64)
    for mcw, lam in ((1.0, 1.0), (0.0, 0.5), (6.0, 2.0)):
        jp = JaxTrainParam(min_child_weight=mcw, reg_lambda=lam)
        tp = TrainParam(min_child_weight=mcw, reg_lambda=lam)
        want = np.asarray(jsplit.choose_refine_window(
            jnp.asarray(hist_c), jnp.asarray(parent), jnp.asarray(n_real),
            jp, has_missing))
        got = split.choose_refine_window(_t(hist_c), _t(parent), _t(n_real),
                                         tp, has_missing).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.max() <= 14


@pytest.mark.parametrize("has_missing", [False, True])
def test_assemble_and_decode_match_jax(has_missing):
    rng = np.random.RandomState(5 + has_missing)
    N = 4
    hist_c = rng.randn(N, F, split.COARSE_B, 2).astype(np.float32)
    hist_r = rng.randn(N, F, split.WINDOW, 2).astype(np.float32)
    window = rng.randint(0, 15, (N, F)).astype(np.int32)
    n_real = np.asarray([256, 40, 17, 16, 5], np.int64)
    ws, wn = jsplit.assemble_two_level(
        jnp.asarray(hist_c), jnp.asarray(hist_r), jnp.asarray(window),
        jnp.asarray(n_real), has_missing)
    gs, gn = split.assemble_two_level(_t(hist_c), _t(hist_r), _t(window),
                                      _t(n_real), has_missing)
    assert gs.shape == (N, F, split.SYN_B + has_missing, 2)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    slot = np.arange(split.SYN_B).repeat(15)
    wsel = np.tile(np.arange(15), split.SYN_B)
    want = np.asarray(jsplit.decode_two_level_bin(jnp.asarray(slot),
                                                  jnp.asarray(wsel)))
    got = split.decode_two_level_bin(_t(slot), _t(wsel)).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the level advance and K5's plain version -------------------------------

def _level(n, B, n_prev, seed):
    """Rows at the previous level of ``n_prev`` nodes with strays above
    it, gradients, and that level's splits (some nodes do not split)."""
    bins, missing = _bins(n, B, seed)
    rng = np.random.RandomState(seed + 1)
    lo_prev = n_prev - 1
    pos = rng.randint(lo_prev, lo_prev + n_prev, n).astype(np.int32)
    stray = rng.rand(n) < 0.1
    pos[stray] = rng.randint(0, max(lo_prev, 1), int(stray.sum()))
    gpair = rng.randn(n, 2).astype(np.float32)
    gpair[:, 1] = np.abs(gpair[:, 1])
    cs = rng.rand(n_prev) < 0.8
    feat = np.where(cs, rng.randint(0, F, n_prev), -1).astype(np.int32)
    thr = np.where(cs, rng.randint(0, B - 1, n_prev), 0).astype(np.int32)
    dleft = cs & (rng.rand(n_prev) < 0.5)
    return bins, missing, gpair, pos, (feat, thr, dleft, cs)


def _port_prev(lo_prev, arrs):
    feat, thr, dleft, cs = arrs
    return LevelSplits(lo_prev, _t(feat.astype(np.int64)),
                       _t(thr.astype(np.int64)), _t(dleft), _t(cs))


@pytest.mark.parametrize("B,n_prev", [(64, 2), (256, 8), (257, 64)])
def test_advance_level_matches_both_jax_forms(B, n_prev):
    """The port's gather over the level's payload equals the TPU's
    one-hot matmul form and the per-row walk over the whole heap."""
    n = 4000
    bins, missing, _, pos, arrs = _level(n, B, n_prev, seed=B + n_prev)
    lo_prev = n_prev - 1
    got = advance_level(_t(bins), _t(pos.astype(np.int64)),
                        _port_prev(lo_prev, arrs), missing).numpy()
    rel = np.where((pos >= lo_prev) & (pos < lo_prev + n_prev),
                   pos - lo_prev, n_prev).astype(np.int32)
    dense = np.asarray(advance_positions_level(
        jnp.asarray(bins.astype(np.float32)), jnp.asarray(pos),
        jnp.asarray(rel), *(jnp.asarray(a) for a in arrs), missing))
    np.testing.assert_array_equal(got, dense)
    max_nodes = 4 * n_prev - 1
    heap = [np.zeros(max_nodes, a.dtype) for a in arrs]
    heap[0][:] = -1
    for h, a in zip(heap, arrs):
        h[lo_prev:lo_prev + n_prev] = a
    walk = np.asarray(jax_update(jnp.asarray(bins), jnp.asarray(pos),
                                 *(jnp.asarray(h) for h in heap), missing))
    np.testing.assert_array_equal(got, walk)
    assert (got != pos).any()


@pytest.mark.parametrize("kind", ["dense", "walk"])
@pytest.mark.parametrize("n,B,n_prev", [(3001, 64, 2), (30000, 257, 16)])
def test_k5_plain_matches_jax_advance_and_prehot(kind, n, B, n_prev):
    """Positions: bit-equal to the JAX package's ``fused_advance_coarse``
    (its XLA body, either payload). Histogram: bit-equal to ``prehot``
    over the coarse ids at the new level, at any number of rows."""
    bins, missing, gpair, pos, arrs = _level(n, B, n_prev, seed=n)
    lo_prev, lo, N = n_prev - 1, 2 * n_prev - 1, 2 * n_prev
    if kind == "dense":
        jarrs = tuple(jnp.asarray(a) for a in arrs)
    else:
        heap = [np.zeros(2 * N - 1, a.dtype) for a in arrs]
        heap[0][:] = -1
        for h, a in zip(heap, arrs):
            h[lo_prev:lo_prev + n_prev] = a
        jarrs = tuple(jnp.asarray(h) for h in heap)
    want_pos, _ = jax_fused_advance_coarse(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(pos),
        {"kind": kind, "lo": lo_prev, "n_level": n_prev, "arrs": jarrs},
        lo, N, missing)
    want_pos = np.asarray(want_pos)
    q, inv = quantise_int8x2(_t(gpair))
    got_pos, got = fused_advance_coarse_reference(
        _t(bins), q, inv, _t(pos.astype(np.int64)), _port_prev(lo_prev, arrs),
        lo, N, missing)
    np.testing.assert_array_equal(got_pos.numpy(), want_pos)
    rel = np.where((want_pos >= lo) & (want_pos < lo + N), want_pos - lo,
                   N).astype(np.int32)
    cb = jsplit.coarse_bin_ids(jnp.asarray(bins, jnp.int32), missing)
    prehot = np.asarray(jax_build_hist(cb, jnp.asarray(gpair),
                                       jnp.asarray(rel), N, split.COARSE_B,
                                       method="prehot"))
    assert got.shape == (N, F, split.COARSE_B, 2)
    np.testing.assert_array_equal(got.numpy(), prehot)
    # the dispatch takes the plain K5 here, and the unfused composition
    # (plain advance, then K2 over the coarse ids) gives the same bits
    p2, h2 = fused_advance_coarse(
        _t(bins), _t(gpair), _t(pos.astype(np.int64)),
        _port_prev(lo_prev, arrs), lo, N, missing)
    np.testing.assert_array_equal(p2.numpy(), want_pos)
    np.testing.assert_array_equal(h2.numpy(), prehot)
    p3 = advance_level(_t(bins), _t(pos.astype(np.int64)),
                       _port_prev(lo_prev, arrs), missing)
    h3 = build_hist(split.coarse_bin_ids(_t(bins), missing), _t(gpair),
                    level_rel(p3, lo, N), N, split.COARSE_B,
                    method="prehot")
    np.testing.assert_array_equal(p3.numpy(), want_pos)
    np.testing.assert_array_equal(h3.numpy(), prehot)


@pytest.mark.parametrize("n,n_prev,n_level", [(700, 2, 4), (1500, 4, 8)])
def test_k5_plain_matches_pallas_interpret(n, n_prev, n_level):
    """The TPU kernel in interpret mode, at the shapes of
    ``tests/test_fused_hist.py``: coarse-bin sums stay below 2^24 quanta,
    so its f32 block adds are exact and the bits are equal."""
    bins, missing, gpair, pos, arrs = _level(n, 64, n_prev, seed=n)
    missing = 63                                   # as the TPU test has it
    lo_prev, lo = n_prev - 1, 2 * n_prev - 1
    want_pos, want = fused_advance_coarse_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(pos),
        *(jnp.asarray(a) for a in arrs), lo_prev=lo_prev, n_prev=n_prev,
        lo=lo, n_level=n_level, missing_bin=missing, block_rows=256,
        interpret=True)
    q, inv = quantise_int8x2(_t(gpair))
    got_pos, got = fused_advance_coarse_reference(
        _t(bins), q, inv, _t(pos.astype(np.int64)), _port_prev(lo_prev, arrs),
        lo, n_level, missing)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k5_against_pallas_where_its_block_adds_round():
    """20,000 rows of positive gradients in one coarse bin: the sums pass
    2^24 quanta, so the TPU kernel's f32 adds of its 256-row blocks round
    (held to rtol (number of blocks) * 2^-24), while the plain K5 keeps
    the exact integers of ``prehot``."""
    n, n_prev, N = 20000, 1, 2
    rng = np.random.RandomState(8)
    bins = rng.randint(0, 16, (n, F)).astype(np.uint8)   # coarse slot 0
    gpair = np.abs(rng.randn(n, 2)).astype(np.float32)
    pos = np.zeros(n, np.int32)
    arrs = (np.asarray([2], np.int32), np.asarray([7], np.int32),
            np.asarray([False]), np.asarray([True]))
    want_pos, want = fused_advance_coarse_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(pos),
        *(jnp.asarray(a) for a in arrs), lo_prev=0, n_prev=n_prev, lo=1,
        n_level=N, missing_bin=16, block_rows=256, interpret=True)
    q, inv = quantise_int8x2(_t(gpair))
    got_pos, got = fused_advance_coarse_reference(
        _t(bins), q, inv, _t(pos.astype(np.int64)), _port_prev(0, arrs), 1,
        N, 16)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    got, want = got.numpy(), np.asarray(want)
    assert (got != want).any()                 # the block adds did round
    np.testing.assert_allclose(got, want, rtol=-(-n // 256) * 2.0 ** -24,
                               atol=0)
    rel = np.asarray(want_pos) - 1
    cb = jsplit.coarse_bin_ids(jnp.asarray(bins, jnp.int32), 16)
    prehot = np.asarray(jax_build_hist(cb, jnp.asarray(gpair),
                                       jnp.asarray(rel.astype(np.int32)), N,
                                       split.COARSE_B, method="prehot"))
    np.testing.assert_array_equal(got, prehot)


# ---- K4's coarse fold -------------------------------------------------------

@pytest.mark.parametrize("N,B", [(1, 256), (4, 257), (128, 64), (5, 65)])
def test_coarse_fold_matches_sorted_pallas_with_coarse(N, B):
    """The fold of K4's int32 accumulators against the TPU's
    ``scan_hist_pallas(with_coarse=True)`` (interpret mode, many blocks):
    fine and coarse bit for bit, with and without a missing slot; and the
    folded integers are those of a direct build over the coarse ids."""
    n = 3001
    bins, missing = _bins(n, B, seed=N + B)
    rng = np.random.RandomState(N)
    gpair = rng.randn(n, 2).astype(np.float32)
    rel = rng.randint(0, N, n).astype(np.int32)
    rel[rng.rand(n) < 0.1] = N
    want_fine, want = scan_hist_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        missing_bin=missing, with_coarse=True, block_rows=256,
        interpret=True)
    fine, coarse = scan_level_hists(_t(bins), _t(gpair), _t(rel), N, B,
                                    missing)
    np.testing.assert_array_equal(fine.numpy(), np.asarray(want_fine))
    np.testing.assert_array_equal(coarse.numpy(), np.asarray(want))
    q, _ = quantise_int8x2(_t(gpair))
    acc = int8x2_acc_reference(_t(bins), q, _t(rel), N, B)
    direct = int8x2_acc_reference(split.coarse_bin_ids(_t(bins), missing),
                                  q, _t(rel), N, split.COARSE_B)
    np.testing.assert_array_equal(coarse_fold(acc, missing).numpy(),
                                  direct.numpy())


def test_scan_above_128_nodes_builds_fine_and_coarse_in_f32():
    """Above 128 nodes, as the TPU's f32 segment branch: K3's plain
    version builds the fine histogram and, directly, the coarse one."""
    n, N, B = 3000, 256, 257
    bins, missing = _bins(n, B, seed=2)
    rng = np.random.RandomState(3)
    gpair = rng.randn(n, 2).astype(np.float32)
    rel = rng.randint(0, N + 1, n).astype(np.int32)
    fine, coarse = scan_level_hists(_t(bins), _t(gpair), _t(rel), N, B,
                                    missing)
    np.testing.assert_array_equal(
        fine.numpy(), build_hist(_t(bins), _t(gpair), _t(rel), N, B,
                                 method="segment").numpy())
    np.testing.assert_array_equal(
        coarse.numpy(),
        build_hist(split.coarse_bin_ids(_t(bins), missing), _t(gpair),
                   _t(rel), N, split.COARSE_B, method="segment").numpy())


def test_fused_dispatch_above_128_nodes_advances_then_builds_in_f32():
    """At a boundary into a level of 256 nodes K5 does not run: the
    dispatch advances the rows as ``advance_level`` does and builds the
    coarse histogram with K3's plain version over the coarse ids, as the
    TPU's fused schedule builds such a level in f32."""
    n, n_prev, B = 4000, 128, 257
    bins, missing, gpair, pos, arrs = _level(n, B, n_prev, seed=9)
    lo_prev, lo, N = n_prev - 1, 2 * n_prev - 1, 2 * n_prev
    prev = _port_prev(lo_prev, arrs)
    got_pos, got = fused_advance_coarse(
        _t(bins), _t(gpair), _t(pos.astype(np.int64)), prev, lo, N, missing)
    want_pos = advance_level(_t(bins), _t(pos.astype(np.int64)), prev,
                             missing)
    np.testing.assert_array_equal(got_pos.numpy(), want_pos.numpy())
    assert (got_pos.numpy() != pos).any()
    want = build_hist(split.coarse_bin_ids(_t(bins), missing), _t(gpair),
                      level_rel(want_pos, lo, N), N, split.COARSE_B,
                      method="segment")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
