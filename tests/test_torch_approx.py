"""``tree_method="approx"`` in the port against the JAX package, on the
CPU.

- The weighted sketch: the port's host ``sketch_matrix`` and its device
  ``WeightedSketch`` against both of the JAX package's sketches (its
  native C++ one and its numpy one), bit for bit in ``values``, ``ptrs``
  and ``min_vals``: more and fewer distinct values than ``max_bin``,
  NaNs, a constant and an all-NaN column, integer columns, a
  categorical one; integer, logistic and row weights (their f64 sums are
  exact, so every summation order gives the same bits). The JAX numpy
  path keeps whichever of -0.0 / +0.0 its sort put first; the native
  one, and the port, +0.0.
- Trees: the port against ``xgb.train(..., tree_method="approx",
  hist_method="prehot")`` (the int8x2 arithmetic of the port's ``auto``)
  node by node under ``tests/test_torch_train.py``'s near-tie
  certificate: binary, three classes, lossguide with ``max_leaves``,
  dart, categorical codes, row and column sampling, row weights,
  monotone and interaction constraints, depthwise ``max_leaves`` and an
  iterator-built matrix. End to end the first round's cuts are held bit
  for bit (after a near tie, or a few rounds of leaf rounding, the
  margins, so the hessians, differ); round by round, each round grown
  from the JAX model's margin before it, every round's cuts.
- Model files load into the JAX package and predict the same; the
  refusals raise the JAX package's exceptions.

Small sizes (2,000 rows, depth 3-4, 4 rounds).
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.data import quantile as jax_quantile
from xgboost_tpu_torch.data.binned import ApproxSource, BinnedMatrix
from xgboost_tpu_torch.data.quantile import WeightedSketch, sketch_matrix

from test_data_iterator import BatchIter
from test_torch_paged import PortIter
from test_torch_train import LEAF_ATOL, compare_forests

CPU = torch.device("cpu")
ROUNDS = 4


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_cuts_equal(a, b, what=""):
    for k in ("values", "ptrs", "min_vals"):
        va, vb = getattr(a, k), getattr(b, k)
        assert va.shape == vb.shape, (what, k, va.shape, vb.shape)
        if not np.array_equal(_bits(va), _bits(vb)):
            i = int(np.flatnonzero(_bits(va) != _bits(vb))[0])
            f = int(np.searchsorted(a.ptrs, i, side="right") - 1)
            raise AssertionError(f"{what} {k} differs at {i} (feature {f}, "
                                 f"rank {i - a.ptrs[f]}): {va[i]} {vb[i]}")


def _sketch_input(seed=0, n=4000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 9).astype(np.float32)
    X[:, 1] = rng.randint(0, 5, n)            # fewer values than max_bin
    X[:, 2] = rng.randint(0, 700, n)          # integers, long tied runs
    X[rng.rand(n) < 0.1, 3] = np.nan
    X[:, 4] = 3.0                             # constant
    X[:, 5] = np.nan                          # all missing
    X[:, 6] = rng.randint(0, 30, n)           # categorical codes
    X[:, 7] = np.round(rng.randn(n) * 4) / 4  # ties between floats
    types = ["q"] * 6 + ["c", "q", "q"]
    return X, types


def _weights(kind, n, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "int":
        return rng.randint(0, 5, n).astype(np.float64)
    if kind == "logistic":
        # a late round's hessians: margins spread over +-4
        p = 1.0 / (1.0 + np.exp(-4 * rng.randn(n)))
        return (p * (1 - p)).astype(np.float32).astype(np.float64)
    # row weights folded into squared-error hessians (h = w)
    return rng.uniform(0.5, 2.0, n).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("max_bin", [16, 256])
@pytest.mark.parametrize("kind", ["int", "logistic", "rows"])
def test_weighted_sketch_matches_both_jax_sketches(kind, max_bin):
    X, types = _sketch_input()
    w = _weights(kind, len(X))
    native = jax_quantile._sketch_matrix_native(X, max_bin, w, types)
    assert native is not None, "the JAX package's native sketch is built"
    numpy_path = jax_quantile.cuts_from_summaries(
        [jax_quantile.FeatureSummary.from_data(X[:, f], w)
         for f in range(X.shape[1])], max_bin, types)
    host = sketch_matrix(X, max_bin, w, types)
    dev, table, count = WeightedSketch(torch.from_numpy(X), max_bin,
                                       types).cuts(torch.from_numpy(w))
    for name, got in (("host", host), ("torch", dev)):
        assert_cuts_equal(native, got, f"native vs {name}")
        assert_cuts_equal(numpy_path, got, f"numpy vs {name}")
    # the device table holds the same cuts
    assert np.array_equal(count.numpy(), host.n_real_bins())
    for f in range(X.shape[1]):
        lo, hi = host.ptrs[f], host.ptrs[f + 1]
        assert np.array_equal(_bits(table[f, :hi - lo].numpy()),
                              _bits(host.values[lo:hi]))


def test_weighted_sketch_counts_negative_zero_as_zero():
    """-0.0 and +0.0 are one value whose cut is +0.0, as the native
    sketch makes it."""
    rng = np.random.RandomState(2)
    X = rng.randint(-3, 4, (600, 2)).astype(np.float32)
    X[::3, 0] = -0.0
    w = rng.randint(1, 4, 600).astype(np.float64)
    native = jax_quantile._sketch_matrix_native(X, 4, w, None)
    assert_cuts_equal(native, sketch_matrix(X, 4, w))
    assert_cuts_equal(native, WeightedSketch(torch.from_numpy(X), 4).cuts(
        torch.from_numpy(w))[0])


def test_weighted_sketch_takes_every_row():
    """With weights the sketch samples no rows, whatever
    ``XTPU_SKETCH_SAMPLE_ROWS`` says (approx sketches every row)."""
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 2).astype(np.float32)
    w = np.ones(3000)
    full = sketch_matrix(X, 32, w, sample_rows=100)
    assert_cuts_equal(sketch_matrix(X, 32, w, sample_rows=0), full)
    assert_cuts_equal(WeightedSketch(torch.from_numpy(X), 32).cuts(
        torch.from_numpy(w))[0], full)


def test_approx_source_rebins_as_from_dense():
    """The device re-binning equals ``BinnedMatrix.from_dense`` under the
    same cuts: ids, dtype and slot count (uint16 from 256 real bins plus
    the missing slot)."""
    X, types = _sketch_input(4, n=3000)
    w = torch.from_numpy(_weights("logistic", 3000))
    for max_bin in (16, 256):
        got = ApproxSource(torch.from_numpy(X), max_bin, types).binned(w)
        want = BinnedMatrix.from_dense(X, got.cuts, CPU)
        assert got.bins.dtype == want.bins.dtype
        assert (got.max_nbins, got.has_missing) == (want.max_nbins, True)
        assert torch.equal(got.bins, want.bins)


# -- trees -----------------------------------------------------------------

def _data(seed, n=2000, F=8, classes=0, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.04] = np.nan
    X[:, 5] = np.round(X[:, 5] * 3)           # tied values
    if cat:
        X[:, 6] = rng.randint(0, 12, n)
        X[:, 7] = rng.randint(0, 3, n)
    if classes:
        y = np.argmax(np.nan_to_num(X[:, :classes])
                      + 0.7 * rng.randn(n, classes), 1)
    else:
        y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1] * X[:, 2])
             + 0.4 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


def relabel(kind, X, y):
    """The labels and matrix keywords of the objective families of
    ROADMAP C.5 on the same rows: ``rank`` (graded labels, queries of 20
    rows), ``adaptive`` (a continuous target for MAE), ``survival``
    (Cox's signed times, a third censored) and ``targets`` (a [n, 3]
    label matrix); None keeps ``y``."""
    rng = np.random.RandomState(len(X))
    Z = np.nan_to_num(X)
    t = Z[:, 0] + Z[:, 1] * Z[:, 2]
    if kind == "rank":
        g = np.clip(np.round(t + 0.5 * rng.randn(len(X)) + 1), 0, 4)
        return g.astype(np.float32), {"qid": np.arange(len(X)) // 20}
    if kind == "adaptive":
        return (t + 0.3 * rng.standard_t(3, len(X))).astype(np.float32), {}
    if kind == "survival":
        time = np.exp(0.5 * t + 0.3 * rng.randn(len(X))).astype(np.float32)
        return np.where(rng.rand(len(X)) < 0.3, -time, time), {}
    if kind == "targets":
        W = rng.randn(X.shape[1], 3)
        return (Z @ W + 0.3 * rng.randn(len(X), 3)).astype(np.float32), {}
    return y, {}


def _recorded_cuts(monkeypatch):
    """Record every sketch either package makes while training: the JAX
    package's ``sketch_matrix`` and the port's ``WeightedSketch.cuts``."""
    jax_cuts, port_cuts = [], []
    jax_sketch = jax_quantile.sketch_matrix

    def jax_rec(*a, **kw):
        out = jax_sketch(*a, **kw)
        jax_cuts.append(out)
        return out

    port_sketch = WeightedSketch.cuts

    def port_rec(self, w):
        out = port_sketch(self, w)
        port_cuts.append(out[0])
        return out

    monkeypatch.setattr(jax_quantile, "sketch_matrix", jax_rec)
    monkeypatch.setattr(WeightedSketch, "cuts", port_rec)
    return jax_cuts, port_cuts


def round_by_round(jb, jd, X, y, w, params, dm_kw, record):
    """The port grows each round r from the JAX model's margin before it
    (walked by the port from the JAX model's bytes; round 0 from
    ``base_score``) with round r's key (``Booster.update(dm, r)``) ->
    (rounds without a near tie, largest leaf drift, the port's cuts of
    each round, per class). Each tree is compared under the near-tie
    certificate."""
    from test_torch_train import compare_tree

    K = max(params.get("num_class", 1), 1)
    jmodel = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    dt = xt.DMatrix(X, **dm_kw)
    clean, drift, cuts = 0, 0.0, []
    for r in range(ROUNDS):
        margin = (jmodel.predict(dt, output_margin=True,
                                 iteration_range=(0, r)) if r else None)
        one = xt.Booster(dict(params, device="cpu"))
        del record[:]
        one.update(xt.DMatrix(X, label=y, weight=w, base_margin=margin,
                              **dm_kw), r)
        cuts.append(list(record))
        ties = []
        for k in range(K):
            t, d = compare_tree(jb.gbm.trees[r * K + k], one.gbm.trees[k],
                                0.3, r=r, capped=params.get(
                                    "grow_policy") == "lossguide")
            ties += t
            drift = max(drift, d)
        clean += not ties
    return clean, drift, cuts


# (name, params, data kwargs, weights, iterator, trees equal in full end to
# end, rounds without a near tie round by round), the last two as measured
# on the CPU; dart's and the iterator's are compared end to end only
APPROX_CASES = [
    ("binary", {"objective": "binary:logistic", "max_depth": 4}, {},
     False, False, 4, 4),
    ("3-class", {"objective": "multi:softprob", "num_class": 3,
                 "max_depth": 3}, {"classes": 3}, False, False, 12, 4),
    ("lossguide", {"objective": "binary:logistic", "grow_policy":
                   "lossguide", "max_leaves": 9, "max_depth": 0}, {},
     False, False, 4, 4),
    ("dart", {"objective": "binary:logistic", "max_depth": 3,
              "booster": "dart", "rate_drop": 0.5}, {}, False, False, 4,
     None),
    ("categorical", {"objective": "binary:logistic", "max_depth": 4},
     {"cat": True}, False, False, 4, 4),
    ("sampling", {"objective": "binary:logistic", "max_depth": 4,
                  "subsample": 0.7, "colsample_bynode": 0.6}, {},
     False, False, 2, 3),
    ("weights", {"objective": "reg:squarederror", "max_depth": 4}, {},
     True, False, 4, 4),
    ("constraints", {"objective": "binary:logistic", "max_depth": 4,
                     "monotone_constraints": "(1,1,0,0,-1,0,0,0)",
                     "interaction_constraints": "[[0, 1], [2, 3, 4]]"},
     {}, False, False, 4, 4),
    ("max_leaves", {"objective": "binary:logistic", "max_depth": 4,
                    "max_leaves": 7}, {}, False, False, 4, 4),
    ("iterator", {"objective": "binary:logistic", "max_depth": 4,
                  "max_bin": 64}, {}, False, True, 4, None),
    ("ranking", {"objective": "rank:ndcg", "max_depth": 4},
     {"kind": "rank"}, False, False, 4, None),
    ("adaptive", {"objective": "reg:absoluteerror", "max_depth": 4},
     {"kind": "adaptive"}, False, False, 4, None),
    ("survival", {"objective": "survival:cox", "max_depth": 4},
     {"kind": "survival"}, False, False, 4, None),
    ("label_matrix", {"objective": "reg:squarederror", "max_depth": 4},
     {"kind": "targets"}, False, False, 12, None),
]


@pytest.mark.parametrize(
    "name,params,data_kw,weighted,iterator,full_min,clean_min",
    APPROX_CASES, ids=[c[0] for c in APPROX_CASES])
def test_approx_trees_match_jax(name, params, data_kw, weighted, iterator,
                                full_min, clean_min, monkeypatch):
    kind = data_kw.get("kind")
    X, y = _data(11, **{k: v for k, v in data_kw.items() if k != "kind"})
    y, kw = relabel(kind, X, y)
    w = (np.random.RandomState(12).uniform(0.2, 3.0, len(X))
         .astype(np.float32) if weighted else None)
    if data_kw.get("cat"):
        kw = {"feature_types": ["q"] * 6 + ["c", "c"],
              "enable_categorical": True}
    p = dict({"eta": 0.3, "tree_method": "approx"}, **params)
    if kind is None:
        p["base_score"] = 0.5
    K = params.get("num_class", y.shape[1] if y.ndim == 2 else 1)
    jax_cuts, port_cuts = _recorded_cuts(monkeypatch)
    if iterator:
        jd = xgb.QuantileDMatrix(BatchIter(X, y, 3), max_bin=64)
        td = xt.QuantileDMatrix(PortIter(X, y, 3), max_bin=64)
    else:
        jd = xgb.DMatrix(X, label=y, weight=w, **kw)
        td = xt.DMatrix(X, label=y, weight=w, **kw)
    jb = xgb.train(dict(p, hist_method="prehot"), jd, ROUNDS,
                   verbose_eval=False)
    tb = xt.train(dict(p, device="cpu"), td, ROUNDS, verbose_eval=False)
    assert len(jax_cuts) == len(port_cuts) == ROUNDS * K
    full, ties, drift = compare_forests(
        jb.gbm.trees, tb.gbm.trees, 0.3,
        capped=params.get("grow_policy") == "lossguide")
    print(name, "end to end: trees equal in full:", full, "near ties:",
          ties, "leaf drift:", drift)
    assert full >= full_min
    # the first round's cuts (one margin in both packages)
    for k in range(K):
        assert_cuts_equal(jax_cuts[k], port_cuts[k], f"round 0 class {k}")
    # every tree's thresholds are its own round's cuts
    for t, tree in enumerate(tb.gbm.trees):
        cuts = port_cuts[t]
        split = ~tree.is_leaf
        f, b = tree.split_feature[split], tree.split_bin[split]
        want = cuts.values[cuts.ptrs[f] + b]
        assert np.array_equal(_bits(tree.split_value[split]), _bits(want))
    if full == len(jb.gbm.trees):
        pred = td if iterator else td if kind else xt.DMatrix(X, **kw)
        jpred = jd if iterator else jd if kind else xgb.DMatrix(X, **kw)
        np.testing.assert_allclose(tb.predict(pred), jb.predict(jpred),
                                   rtol=1e-5, atol=LEAF_ATOL)
    if clean_min is None:
        return
    clean, drift, cuts = round_by_round(jb, jd, X, y, w, p, kw, port_cuts)
    print(name, "round by round: rounds with no near tie:", clean,
          "leaf drift:", drift)
    assert clean >= clean_min
    for r in range(ROUNDS):
        for k in range(K):
            assert_cuts_equal(jax_cuts[r * K + k], cuts[r][k],
                              f"round {r} class {k}")


def test_approx_grower_swaps_cuts_and_reads_each_rounds_bins(monkeypatch):
    """The grower is kept across rounds while the bin slots are unchanged
    (its cuts swapped, its device copies of the real-bin counts
    dropped), and rebuilt when they change or a feature is
    categorical."""
    X, y = _data(13)
    made = []
    from xgboost_tpu_torch.tree import grow

    init = grow.TreeGrower.__init__

    def rec(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(grow.TreeGrower, "__init__", rec)
    p = {"objective": "binary:logistic", "max_depth": 3, "device": "cpu",
         "tree_method": "approx"}
    b = xt.train(p, xt.DMatrix(X, label=y), 3)
    assert len(made) == 1
    g = b.gbm._grower
    assert np.array_equal(g._n_real_on(CPU).numpy(),
                          g.cuts.n_real_bins())
    made.clear()
    Xc = X.copy()
    Xc[:, 6] = np.random.RandomState(0).randint(0, 5, len(X))
    xt.train(p, xt.DMatrix(Xc, label=y, feature_types=["q"] * 6 + ["c", "q"],
                           enable_categorical=True), 3)
    assert len(made) == 3


def test_approx_eval_sets_walk_raw_values():
    """Under approx the training entry keeps no binned matrix; an eval
    set's margin is the raw walk's, equal to ``predict``'s."""
    X, y = _data(14)
    dtr = xt.DMatrix(X[:1500], label=y[:1500])
    dte = xt.DMatrix(X[1500:], label=y[1500:])
    res = {}
    b = xt.train({"objective": "binary:logistic", "max_depth": 3,
                  "device": "cpu", "tree_method": "approx"}, dtr, 4,
                 evals=[(dtr, "train"), (dte, "test")], evals_result=res,
                 verbose_eval=False)
    st = b._caches[id(dtr)]
    assert st["binned"] is None and isinstance(st["source"], ApproxSource)
    assert b._caches[id(dte)]["binned"] is None
    np.testing.assert_allclose(
        b._caches[id(dte)]["margin"].numpy()[:, 0],
        b.predict(dte, output_margin=True), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        st["margin"].numpy()[:, 0], b.predict(dtr, output_margin=True),
        rtol=1e-5, atol=1e-5)
    assert res["test"]["logloss"][-1] < res["test"]["logloss"][0]


def test_approx_model_file_loads_into_jax():
    X, y = _data(15, classes=3)
    p = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
         "tree_method": "approx"}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 3)
    raw = tb.save_raw("json")
    jb = xgb.Booster(model_file=raw)
    assert jb.learner_params["tree_method"] == "approx"
    np.testing.assert_allclose(jb.predict(xgb.DMatrix(X)),
                               tb.predict(xt.DMatrix(X)), rtol=1e-6,
                               atol=1e-7)
    again = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    assert bytes(again.save_raw("json")) == bytes(raw)


@pytest.mark.parametrize("params", [
    {"hist_method": "coarse"}, {"hist_method": "fused"},
    {"hist_method": "scan"}, {"hist_method": "mega"},
    {"multi_strategy": "multi_output_tree", "objective": "multi:softprob",
     "num_class": 3},
])
def test_approx_refusals_match_jax(params):
    X, y = _data(16, n=300, classes=3)
    p = dict({"objective": "binary:logistic", "tree_method": "approx",
              "max_depth": 3}, **params)
    yy = y if "num_class" in p else (y > 0).astype(np.float32)
    for pkg, extra in ((xgb, {}), (xt, {"device": "cpu"})):
        with pytest.raises(NotImplementedError) as err:
            pkg.train(dict(p, **extra), pkg.DMatrix(X, label=yy), 1,
                      verbose_eval=False)
        if pkg is xgb:
            want = str(err.value)
        else:
            assert str(err.value) == want
