"""The port's training path against the JAX package, on the CPU.

Integer results are held bit for bit: cuts, the bin matrix, row
positions. Float results are held to stated tolerances, because three
sums round differently in the two packages (the cumulative sum of
``evaluate_splits``, XLA's ``exp`` in the sigmoid, and the JAX f32
``segment`` histogram) and boosting feeds each round's rounding into the
next round's gradients:

- the int8x2 quantum is ``max|g| / 32512`` per row (3.1e-5 for the
  logistic gradient); a gradient that moves by one ulp can move its
  quantised value by one, and a leaf ``-eta * G / (H + lambda)`` moves
  with G. Measured on the CPU: leaves drift by at most 6.3e-5 (depth 8,
  10 rounds, end to end) and 3.9e-5 (any one round from the same
  margin), so they are held at rtol 1e-5 plus ``LEAF_ATOL`` = 1e-4;
- a split whose two best candidates are closer than those roundings can
  go either way. Trees are compared node by node from the root; where
  the two packages chose different splits, the test requires the gap
  between their two gains to be within the rounding bound (a near tie),
  prints it, and skips the subtree below that node.

Each configuration is compared twice: end to end (both packages train
10 rounds; after the first round with a near tie the margins differ, so
the comparison stops there, and the number of trees compared in full is
asserted as measured on the CPU), and round by round (the port grows each
round from the JAX model's margin before that round, given as
``base_margin``, so that a tie in one round does not end the
comparison: every round is compared).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.data.binned import BinnedMatrix as JaxBinned
from xgboost_tpu.data.quantile import sketch_matrix as jax_sketch
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu.ops.partition import (advance_positions_level,
                                       update_positions as jax_update)
from xgboost_tpu.ops.split import evaluate_splits as jax_evaluate
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.data.binned import BinnedMatrix
from xgboost_tpu_torch.data.quantile import sketch_matrix
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.ops.partition import update_positions
from xgboost_tpu_torch.ops.split import evaluate_splits
from xgboost_tpu_torch.tree.param import TrainParam

CPU = torch.device("cpu")

# Under pytest-xdist every worker process collects this module, and each
# would otherwise run torch's CPU ops on as many threads as the machine
# has cores: six workers on eight cores then spend most of their time
# waiting on each other's spinning threads (the port's largest training
# test took 357 s instead of 38 s, six copies at once on an eight-core
# CPU). Each worker gets its share of the cores instead.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROUNDS = 10
# leaf values and predictions: rtol 1e-5 plus a few int8x2 quanta (module
# docstring)
LEAF_ATOL = 1e-4
# gains, and the near-tie certificate: relative to the node's own scale
# (its parent term G^2/(H+lambda) plus its gain); measured at most 5.2e-5
GAIN_RTOL = 2e-4


def _higgs_like(n=10000, F=28, seed=0, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = rng.randn(F).astype(np.float32)
    logit = X @ w + 0.5 * rng.randn(n)
    y = (logit > 0).astype(np.float32)
    y_reg = (0.1 * logit).astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return X, y, y_reg


@pytest.fixture(scope="module")
def higgs():
    return _higgs_like()


# ---- data --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["nan_257", "dense_256", "small_16",
                                  "sampled"])
def test_cuts_and_bins_bit_for_bit(higgs, case):
    X, _, _ = higgs
    X = X[:3000]
    max_bin, kw = 256, {}
    if case == "dense_256":
        X = _higgs_like(n=3000, missing=0.0)[0]
    elif case == "small_16":
        max_bin = 16
    elif case == "sampled":
        kw = {"sample_rows": 1000}        # the strided sample of big inputs
    cj = jax_sketch(X, max_bin, **kw)
    cp = sketch_matrix(X, max_bin, **kw)
    np.testing.assert_array_equal(cp.values, cj.values)
    np.testing.assert_array_equal(cp.ptrs, cj.ptrs)
    np.testing.assert_array_equal(cp.min_vals, cj.min_vals)
    assert cp.to_json() == cj.to_json()
    bj = JaxBinned.from_dense(X, cj)
    bp = BinnedMatrix.from_dense(X, cp, CPU)
    assert (bp.max_nbins, bp.has_missing, bp.missing_bin) == \
        (bj.max_nbins, bj.has_missing, bj.missing_bin)
    want = np.asarray(bj.bins)
    got = bp.bins.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case == "nan_257":
        assert bp.max_nbins == 257 and bp.bins.dtype == torch.uint16
    if case == "dense_256":
        assert bp.max_nbins == 256 and bp.bins.dtype == torch.uint8


# ---- gradients ---------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_gradients(higgs, objective):
    """rtol 1e-6: XLA's exp is its own approximation. p - y cancels, so
    the gradient is held to 1e-6 of the sigmoid's scale (atol), not of
    itself. Both packages are also held to a float64 evaluation of the
    same formula, so that a run where one side moves says which: a
    process's first CPU torch.exp split over threads once returned whole
    thread chunks off by 3.3e-5 here (the port now makes that first call
    on one element, ``objective/regression.py``)."""
    X, y, y_reg = higgs
    labels = y if objective == "binary:logistic" else y_reg
    rng = np.random.RandomState(1)
    margin = rng.randn(len(labels), 1).astype(np.float32)
    weights = rng.rand(len(labels)).astype(np.float32)

    class Info:
        pass

    info = Info()
    info.labels, info.weights = labels, weights
    want = np.asarray(jax_objective(objective).get_gradient(
        jnp.asarray(margin), info))
    got = get_objective(objective).get_gradient(
        torch.from_numpy(margin), torch.from_numpy(labels),
        torch.from_numpy(weights)).numpy()
    assert got.shape == want.shape == (len(labels), 1, 2)
    m = margin.astype(np.float64)
    w = weights.astype(np.float64)[:, None]
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-m))
        exact = np.stack([(p - labels[:, None]) * w,
                          np.maximum(p * (1.0 - p), 1e-16) * w], axis=-1)
    else:
        exact = np.stack([(m - labels[:, None]) * w,
                          np.ones_like(m) * w], axis=-1)
    np.testing.assert_allclose(want, exact, rtol=1e-6, atol=1e-6,
                               err_msg="the JAX package")
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6,
                               err_msg="the port")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    bad = margin.copy()
    bad[5] = np.nan
    with pytest.raises(RuntimeError, match="non-finite"):
        get_objective(objective).get_gradient(
            torch.from_numpy(bad), torch.from_numpy(labels))


# ---- split evaluation and partitioning -----------------------------------------

@pytest.mark.parametrize("has_missing", [True, False])
def test_evaluate_splits_same_histogram(higgs, has_missing):
    """Both packages evaluate the same histogram (a level of 8 nodes over
    real rows): equal (feature, bin, default_left); gains to rtol 1e-6 of
    the node's scale, since each package's cumulative sum rounds in its
    own order."""
    X, y, _ = higgs
    X = X[:4000] if has_missing else np.nan_to_num(X[:4000])
    cuts = jax_sketch(X, 64)
    binned = JaxBinned.from_dense(X, cuts)
    assert binned.has_missing == has_missing
    rng = np.random.RandomState(2)
    gpair = np.stack([rng.randn(len(X)), rng.rand(len(X))], 1).astype(
        np.float32)
    N = 8
    rel = rng.randint(0, N, len(X)).astype(np.int32)
    from xgboost_tpu.ops.histogram import build_hist_segment
    hist = np.array(build_hist_segment(
        binned.bins, jnp.asarray(gpair), jnp.asarray(rel), N,
        binned.max_nbins))                      # a writable copy
    parent = hist[:, 0].sum(axis=1)
    n_real = cuts.n_real_bins()
    jp = JaxTrainParam(min_child_weight=0.5, reg_lambda=1.5)
    tp = TrainParam(min_child_weight=0.5, reg_lambda=1.5)
    want = jax_evaluate(jnp.asarray(hist), jnp.asarray(parent),
                        jnp.asarray(n_real), jp, has_missing=has_missing)
    got = evaluate_splits(torch.from_numpy(hist), torch.from_numpy(parent),
                          torch.from_numpy(n_real.astype(np.int64)), tp,
                          has_missing=has_missing)
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(want.feature))
    np.testing.assert_array_equal(got.bin.numpy(), np.asarray(want.bin))
    np.testing.assert_array_equal(got.default_left.numpy(),
                                  np.asarray(want.default_left))
    scale = parent[:, 0] ** 2 / (parent[:, 1] + 1.5) + np.abs(want.gain)
    assert (np.abs(got.gain.numpy() - np.asarray(want.gain))
            <= 1e-6 * scale).all()
    np.testing.assert_allclose(got.left_sum.numpy(),
                               np.asarray(want.left_sum), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got.right_sum.numpy(),
                               np.asarray(want.right_sum), rtol=1e-6,
                               atol=1e-5)


def test_update_positions_bit_for_bit():
    rng = np.random.RandomState(3)
    n, F, B, depth = 5000, 7, 257, 3
    bins = rng.randint(0, B, (n, F)).astype(np.uint16)
    max_nodes = 2 ** (depth + 2) - 1
    lo, n_level = 2 ** depth - 1, 2 ** depth
    positions = rng.randint(lo, lo + n_level, n).astype(np.int32)
    positions[::9] = rng.randint(0, lo, len(positions[::9]))  # earlier leaves
    sf = rng.randint(0, F, max_nodes).astype(np.int32)
    sb = rng.randint(0, B - 1, max_nodes).astype(np.int32)
    dl = rng.rand(max_nodes) < 0.5
    is_split = np.zeros(max_nodes, bool)
    is_split[lo:lo + n_level] = rng.rand(n_level) < 0.7
    want = np.asarray(jax_update(
        jnp.asarray(bins), jnp.asarray(positions), jnp.asarray(sf),
        jnp.asarray(sb), jnp.asarray(dl), jnp.asarray(is_split), B - 1))
    got = update_positions(
        torch.from_numpy(bins), torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(sf.astype(np.int64)),
        torch.from_numpy(sb.astype(np.int64)), torch.from_numpy(dl),
        torch.from_numpy(is_split), B - 1).numpy()
    np.testing.assert_array_equal(got, want)
    # the TPU's matmul form of the same level advance agrees too
    rel = np.where((positions >= lo) & (positions < lo + n_level),
                   positions - lo, n_level).astype(np.int32)
    cs = is_split[lo:lo + n_level]
    dense = np.asarray(advance_positions_level(
        jnp.asarray(bins.astype(np.float32)), jnp.asarray(positions),
        jnp.asarray(rel), jnp.asarray(np.where(cs, sf[lo:lo + n_level], -1)),
        jnp.asarray(np.where(cs, sb[lo:lo + n_level], 0)),
        jnp.asarray(cs & dl[lo:lo + n_level]), jnp.asarray(cs), B - 1))
    np.testing.assert_array_equal(got, dense)


# ---- the whole slice ----------------------------------------------------------

def _parent_term(t, i, eta, lam):
    w = t.base_weight[i] / eta                   # -G / (H + lambda)
    if np.ndim(w):
        # a vector leaf: the sum over its K targets, each taken at an even
        # share of the node's target-summed hessian (the model keeps no
        # per-target hessians)
        return float(np.sum(np.square(w, dtype=np.float64))
                     * (float(t.sum_hess[i]) / w.size + lam))
    return float(w * w * (t.sum_hess[i] + lam))


def _node_sums(t, i, eta, lam):
    """(G, H) of node ``i``: H its cover, G from its weight -G / (H +
    lambda), in float64."""
    h = float(t.sum_hess[i])
    return -float(t.base_weight[i]) / eta * (h + lam), h


def root_gap(a, b, eta, lam=1.0):
    """(|dG|, |dH|): how far the two trees' root sums lie apart. Each
    package sums the root's (g, h) in f32 in its own order."""
    if np.ndim(a.base_weight[0]):
        return 0.0, 0.0         # vector leaves: no per-target root sums
    ga, ha = _node_sums(a, 0, eta, lam)
    gb, hb = _node_sums(b, 0, eta, lam)
    return abs(ga - gb), abs(ha - hb)


def root_carry(t, i, eta, lam, gap):
    """How far the gain of node ``i``'s split in tree ``t`` can move when
    the node's (G, H) moves by the root's gap (|dG|, |dH|). A node on the
    right-hand path from the root carries that gap whole: its sums, and
    its right child's, are the parent's less the left child's, and the
    left children's come from the histograms. The gain formula
    ``GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)`` (GR = G - GL, HR = H - HL)
    is evaluated at the corners of the gap's box."""
    if np.ndim(t.base_weight[i]):
        return 0.0      # a vector leaf's per-target sums are not in the model
    g, h = _node_sums(t, i, eta, lam)
    gl, hl = _node_sums(t, t.left_child[i], eta, lam)

    def gain(g, h):
        return (gl * gl / (hl + lam) + (g - gl) ** 2 / (h - hl + lam)
                - g * g / (h + lam))

    base = gain(g, h)
    return max(abs(gain(g + sg * gap[0], h + sh * gap[1]) - base)
               for sg in (-1.0, 1.0) for sh in (-1.0, 1.0))


def compare_tree(a, b, eta, lam=1.0, r=0, capped=False):
    """Node-by-node from the root of JAX tree ``a`` and port tree ``b``
    (nodes paired through their children, not their ids); returns
    (near-tie nodes, largest leaf drift). Asserts everything it
    compares; a near tie skips the subtree below it. The certificate of a
    node's gain: ``GAIN_RTOL`` of its scale, and for a node on the
    right-hand path from the root what the root's measured sum gap moves
    its gain by (:func:`root_carry`; for a near tie the larger of the two
    trees' splits).

    Vector-leaf trees (``leaf_value`` [n, K]) compare the same way: each
    target's leaf weight at the stated rtol, the gain summed over the
    targets under the same certificate, whose scale sums the targets'
    parent terms; the model keeps no per-target sums, so there is no
    root carry.

    ``capped``: leaf-wise trees whose ``max_leaves`` bound. There a node
    that one tree splits and the other leaves a leaf is a near tie of the
    greedy order when its gain lies within ``GAIN_RTOL`` of its scale
    (plus that of the other tree's gain) of the smallest gain the other
    tree's loop popped: both loops stopped at the cap with the two
    candidates that close."""
    drift = 0.0
    ties = []
    gap = root_gap(a, b, eta, lam)
    stack = [(0, 0, True)]
    while stack:
        i, j, right_path = stack.pop()
        scale = _parent_term(a, i, eta, lam) + abs(float(a.gain[i]))
        if a.is_leaf[i] and b.is_leaf[j]:
            np.testing.assert_allclose(b.leaf_value[j], a.leaf_value[i],
                                       rtol=1e-5, atol=LEAF_ATOL)
            drift = max(drift, float(np.max(np.abs(
                np.asarray(b.leaf_value[j], np.float64)
                - a.leaf_value[i]))))
            continue
        if capped and a.is_leaf[i] != b.is_leaf[j]:
            split, other, k = (a, b, i) if b.is_leaf[j] else (b, a, j)
            g = float(split.gain[k])
            m = float(other.gain[~other.is_leaf].min())
            bound = GAIN_RTOL * (scale + abs(m))
            print(f"round {r} node {i}: split in one tree only (gain {g}), "
                  f"the other's smallest popped gain {m}: gap {abs(g - m)}, "
                  f"bound {bound:.3e}")
            assert abs(g - m) <= bound, "a capped split is no near tie"
            ties.append(int(i))
            continue
        same = (not a.is_leaf[i] and not b.is_leaf[j]
                and a.split_feature[i] == b.split_feature[j]
                and a.split_bin[i] == b.split_bin[j]
                and a.default_left[i] == b.default_left[j])
        diff = abs(float(a.gain[i]) - float(b.gain[j]))
        carry = 0.0
        if right_path and not a.is_leaf[i]:
            carry = root_carry(a, i, eta, lam, gap)
        if right_path and not (same or b.is_leaf[j]):
            carry = max(carry, root_carry(b, j, eta, lam, gap))
        bound = GAIN_RTOL * scale + carry
        if not same:
            print(f"round {r} node {i}: near tie, JAX split "
                  f"(f{a.split_feature[i]}, bin {a.split_bin[i]}, "
                  f"gain {a.gain[i]}) vs port (f{b.split_feature[j]}, "
                  f"bin {b.split_bin[j]}, gain {b.gain[j]}): gap {diff}, "
                  f"{diff / scale:.3e} of the node's scale, root carry "
                  f"{carry:.3e}")
            assert diff <= bound, "a split differs by more than a near tie"
            ties.append(int(i))
            continue
        assert diff <= bound, (r, i, a.gain[i], b.gain[j], carry)
        stack.append((a.left_child[i], b.left_child[j], False))
        stack.append((a.right_child[i], b.right_child[j], right_path))
    return ties, drift


def compare_forests(jtrees, ttrees, eta, lam=1.0, capped=False):
    """Tree by tree until the first tree with a near tie (the margins
    differ after it); returns (trees compared in full, near ties of the
    tree that stopped the comparison, largest leaf drift)."""
    drift = 0.0
    for r, (a, b) in enumerate(zip(jtrees, ttrees)):
        ties, d = compare_tree(a, b, eta, lam, r, capped)
        drift = max(drift, d)
        if ties:
            return r, ties, drift
    return len(jtrees), [], drift


def _train_both(X, y, objective, depth, jax_method, port_method,
               jax_obj=None):
    params = {"objective": objective, "max_depth": depth, "eta": 0.3,
              "base_score": 0.5}
    jb = xgb.train(dict(params, hist_method=jax_method),
                   xgb.DMatrix(X, label=y), ROUNDS, verbose_eval=False,
                   obj=jax_obj)
    tb = xt.train(dict(params, hist_method=port_method, device="cpu"),
                  xt.DMatrix(X, label=y), ROUNDS, verbose_eval=False)
    return jb, tb


# (objective, depth, JAX hist_method, port hist_method, trees equal in
# full end to end, rounds with no near tie round by round), the last two
# as measured on the CPU
SLICE_CASES = [
    ("binary:logistic", 6, "prehot", "auto", 10, 10),
    ("binary:logistic", 8, "prehot", "auto", 10, 10),
    ("binary:logistic", 6, "segment", "segment", 5, 9),
    ("reg:squarederror", 6, "prehot", "auto", 5, 7),
]


@pytest.mark.parametrize("objective,depth,jax_method,port_method,full_min,"
                         "clean_min", SLICE_CASES)
def test_slice_matches_jax(higgs, objective, depth, jax_method, port_method,
                           full_min, clean_min, monkeypatch):
    # XTPU_BATCH_ROUNDS=1: one fused round program per config instead of
    # the 8- and 2-round scans (bit-identical models, one compile fewer)
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y, y_reg = higgs
    labels = y if objective == "binary:logistic" else y_reg
    check_slice_against_jax(X, labels, objective, depth, jax_method,
                            port_method, full_min, clean_min)


def check_slice_against_jax(X, labels, objective, depth, jax_method,
                            port_method, full_min, clean_min, jax_obj=None):
    """Both packages train ``ROUNDS`` rounds; trees compared end to end
    (at least ``full_min`` equal in full) and round by round (at least
    ``clean_min`` rounds without a near tie), leaves and predictions at
    rtol 1e-5 plus ``LEAF_ATOL``. ``jax_obj``: a custom objective for the
    JAX package's side."""
    jb, tb = _train_both(X, labels, objective, depth, jax_method,
                         port_method, jax_obj)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == ROUNDS
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees,
                                        eta=0.3)
    print(f"{objective} depth {depth} {jax_method}: {full} of {ROUNDS} "
          f"trees equal in full, near ties {ties}, largest leaf drift "
          f"{drift:.3e}")
    assert full >= full_min
    dj, dt = xgb.DMatrix(X), xt.DMatrix(X)
    np.testing.assert_allclose(
        tb.predict(dt, iteration_range=(0, full)),
        jb.predict(dj, iteration_range=(0, full)), rtol=1e-5,
        atol=LEAF_ATOL)
    assert max(t.max_depth() for t in tb.gbm.trees[:full]) == depth

    # round by round: the port grows round r from the JAX model's margin
    # before round r (walked by the port from the JAX model's bytes;
    # round 0 from base_score, as iteration_range (0, 0) means every tree)
    params = {"objective": objective, "max_depth": depth, "eta": 0.3,
              "base_score": 0.5, "hist_method": port_method,
              "device": "cpu"}
    jmodel = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    clean, drift = 0, 0.0
    for r in range(ROUNDS):
        margin = jmodel.predict(dt, output_margin=True,
                                iteration_range=(0, r)) if r else None
        one = xt.train(params, xt.DMatrix(X, label=labels,
                                          base_margin=margin), 1,
                       verbose_eval=False)
        ties, d = compare_tree(jb.gbm.trees[r], one.gbm.trees[0], 0.3, r=r)
        clean += not ties
        drift = max(drift, d)
    print(f"round by round: {clean} of {ROUNDS} rounds with no near tie, "
          f"largest leaf drift {drift:.3e}")
    assert clean >= clean_min


def test_auto_at_scale_runs_k4_and_grows_prehot_trees(monkeypatch):
    """At 70,000 rows ``auto`` builds every level with K4's plain version
    (the sorted build the TPU's ``auto`` takes there); its integer sums
    grow the same trees, bit for bit, as K2's (``prehot``)."""
    import xgboost_tpu_torch.ops.histogram as H

    calls = []
    sorted_build = H.build_hist_scan_reference
    monkeypatch.setattr(H, "build_hist_scan_reference",
                        lambda *a: calls.append(a[-2]) or sorted_build(*a))
    X, y, _ = _higgs_like(n=70_000, F=8, missing=0.0)
    params = {"objective": "binary:logistic", "max_depth": 4,
              "base_score": 0.5, "device": "cpu"}
    auto = xt.train(params, xt.DMatrix(X, label=y), 2, verbose_eval=False)
    assert calls == [1, 2, 4, 8] * 2
    prehot = xt.train(dict(params, hist_method="prehot"),
                      xt.DMatrix(X, label=y), 2, verbose_eval=False)
    assert len(calls) == 8
    for a, b in zip(auto.gbm.trees, prehot.gbm.trees):
        for field in ("split_feature", "split_bin", "default_left",
                      "leaf_value", "gain", "base_weight"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_port_model_loads_into_jax(higgs, tmp_path):
    X, y, _ = higgs
    X, y = X[:3000], y[:3000]
    tb = xt.train({"objective": "binary:logistic", "max_depth": 5,
                   "device": "cpu"}, xt.DMatrix(X, label=y), 5,
                  verbose_eval=False)
    for fmt in ("json", "ubj"):
        raw = tb.save_raw(fmt)
        jb = xgb.Booster(model_file=raw)
        np.testing.assert_allclose(jb.predict(xgb.DMatrix(X)),
                                   tb.predict(xt.DMatrix(X)), rtol=1e-6,
                                   atol=1e-7)
        assert jb.num_boosted_rounds() == 5
        # and back: the port saves the bytes the JAX package saves
        assert bytes(xt.Booster({"device": "cpu"},
                                model_file=jb.save_raw(fmt)).save_raw(fmt)) \
            == bytes(jb.save_raw(fmt))
    path = tmp_path / "m.json"
    tb.save_model(str(path))
    again = xt.Booster({"device": "cpu"}, model_file=str(path))
    np.testing.assert_array_equal(again.predict(xt.DMatrix(X)),
                                  tb.predict(xt.DMatrix(X)))


def test_train_evals_and_defaults(higgs):
    X, y, _ = higgs
    dtr = xt.DMatrix(X[:8000], label=y[:8000])
    dte = xt.DMatrix(X[8000:], label=y[8000:])
    res = {}
    bst = xt.train({"objective": "binary:logistic", "max_depth": 4,
                    "device": "cpu"}, dtr, 6, evals=[(dtr, "train"),
                                                     (dte, "test")],
                   evals_result=res, verbose_eval=False)
    assert list(res) == ["train", "test"]
    tr, te = res["train"]["logloss"], res["test"]["logloss"]
    assert len(tr) == len(te) == 6 and tr[-1] < tr[0] and te[-1] < te[0]
    # the eval-set margin cache walks new trees only; it equals predict
    p = bst.predict(dte)
    ll = -np.mean(y[8000:] * np.log(p) + (1 - y[8000:]) * np.log(1 - p))
    assert abs(ll - te[-1]) < 1e-5
    # no base_score: the stump estimate, as the JAX package fits it

    class Info:
        labels, weights = y[:8000], None

    want = np.asarray(jax_objective("binary:logistic").init_estimation(
        Info()))
    np.testing.assert_allclose(bst._base_np(), want, rtol=1e-5)


def test_training_continues_from_a_model(higgs):
    """xgb_model=: the margin cache starts from the existing trees (walked
    once), so 3 + 2 rounds grow the same trees as 5 rounds."""
    X, y, _ = higgs
    dm = xt.DMatrix(X[:3000], label=y[:3000])
    params = {"objective": "binary:logistic", "max_depth": 4,
              "base_score": 0.5, "device": "cpu"}
    five = xt.train(params, dm, 5, verbose_eval=False)
    three = xt.train(params, dm, 3, verbose_eval=False)
    more = xt.train(params, dm, 2, verbose_eval=False,
                    xgb_model=three.save_raw("json"))
    assert more.num_boosted_rounds() == 5
    for a, b in zip(five.gbm.trees, more.gbm.trees):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


def test_train_runs_on_the_card_unless_asked():
    X = np.zeros((4, 2), np.float32)
    dm = xt.DMatrix(X, label=np.zeros(4, np.float32))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        xt.train({"objective": "binary:logistic"}, dm, 1)


@pytest.mark.parametrize("params,item", [
    ({"grow_policy": "lossguide", "hist_method": "mega"}, "A.6"),
    ({"max_leaves": 4, "hist_method": "scan+sub"}, "A.6"),
    ({"hist_method": "mega"}, "A.6"),
    ({"hist_method": "scan+sub"}, "A.6"),
    ({"grow_policy": "lossguide", "hist_method": "scan+sub"}, "A.6"),
])
def test_unported_options_name_their_roadmap_item(params, item):
    rng = np.random.RandomState(4)
    X = rng.randn(50, 2).astype(np.float32)
    dm = xt.DMatrix(X, label=(X[:, 0] > 0).astype(np.float32))
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        xt.train(dict({"objective": "binary:logistic", "device": "cpu"},
                      **params), dm, 1)


@pytest.mark.parametrize("params", [
    {"booster": "gblinear", "data_split_mode": "col"},
    {"data_split_mode": "col"},
])
def test_column_split_needs_a_mesh_or_a_communicator(params):
    """Column split trains on a mesh or across vertical parties
    (``tests/test_torch_col_split.py``, ``tests/test_torch_vertical.py``);
    with neither it is refused with the JAX package's words."""
    rng = np.random.RandomState(4)
    X = rng.randn(50, 2).astype(np.float32)
    dm = xt.DMatrix(X, label=(X[:, 0] > 0).astype(np.float32))
    with pytest.raises(ValueError, match="data_split_mode=col requires a "
                                         "mesh"):
        xt.train(dict({"objective": "binary:logistic", "device": "cpu"},
                      **params), dm, 1)
