"""Leaf-wise growth (``grow_policy="lossguide"``, ``tree/lossguide.py``)
and depthwise ``max_leaves`` in the port against the JAX package, on the
CPU (ROADMAP A.5.6).

The JAX package runs ``hist_method="prehot"`` (its int8x2 integers in
XLA), the port its plain versions; trees are compared node by node,
paired through their children, under ``tests/test_torch_train.py
compare_tree`` with ``capped``: where ``max_leaves`` binds, a node that
one tree splits and the other does not is a near tie of the greedy
order only if its gain lies within the certificate of the smallest gain
the other loop popped. Every case below measured no such tie; the
counts asserted are the trees equal in full.

- exact, column-sampled and depth-capped lossguide (the column masks
  ``col_masks``' draws bit for bit), lossguide deeper than a heap of
  its leaves, depthwise ``max_leaves`` (``select_max_leaves`` bit for
  bit);
- ``coarse`` / ``fused`` / ``scan`` against the JAX package's on
  gradients on the int8x2 grid (``tests/test_torch_two_level_train.py``
  says why), and the port's three saving one set of bytes with the
  kernels ``chip_smoke.py`` counts on the card;
- multiclass, one-hot and partition categorical, and dart (the same
  drops at seed 0);
- models saved by either package load into the other and predict the
  same bits; dumps and ``pred_leaf`` equal; refresh and prune over
  lossguide trees;
- uncapped lossguide equals depthwise; ``mega`` trains scan's bytes
  and the two-level fall-back's warning (paged lossguide is
  ``tests/test_torch_paged_growers.py``).
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
import xgboost_tpu_torch.ops.histogram as H
from test_torch_train import compare_forests
from test_torch_two_level_train import (_jax_grid_objective,
                                        _port_grid_gradient)
from xgboost_tpu.tree import grow as jax_grow
from xgboost_tpu.tree import lossguide as jax_lossguide
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.objective.base import Objective
from xgboost_tpu_torch.tree import grow, lossguide
from xgboost_tpu_torch.tree.param import TrainParam

CPU = {"device": "cpu"}
LG = {"objective": "binary:logistic", "grow_policy": "lossguide",
      "max_leaves": 12, "max_depth": 0, "eta": 0.3, "base_score": 0.5}


def _data(n=3000, f=10, seed=0, missing=0.03):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < missing] = np.nan
    y = (np.nan_to_num(X[:, 0] * X[:, 1] + X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def binary():
    return _data()


def _train(pkg, params, X, y, rounds=3, dm_kw=None, **kw):
    extra = CPU if pkg is xt else {"hist_method": "prehot"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        return pkg.train(dict(extra, **params),
                         pkg.DMatrix(X, label=y, **(dm_kw or {})), rounds,
                         verbose_eval=False, **kw)


def _check(jb, tb, X, full_min, dm_kw=None, capped=True):
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3,
                                        capped=capped)
    print(f"{full} of {len(jb.gbm.trees)} trees equal in full, ties "
          f"{ties}, leaf drift {drift:.3e}")
    assert full >= full_min
    assert len(jb.gbm.trees) == len(tb.gbm.trees)
    np.testing.assert_allclose(
        tb.predict(xt.DMatrix(X, **(dm_kw or {}))),
        jb.predict(xgb.DMatrix(X, **(dm_kw or {}))), rtol=1e-5, atol=1e-4)


# (case, params beside LG, trees equal in full as measured)
EXACT_CASES = [
    ("capped", {}, 3),
    ("colsample", {"colsample_bytree": 0.5, "colsample_bylevel": 0.5,
                   "colsample_bynode": 0.5}, 3),
    ("depth", {"max_depth": 3, "max_leaves": 6}, 3),
    ("uncapped_depth", {"max_depth": 3, "max_leaves": 0}, 3),
    ("depthwise_max_leaves", {"grow_policy": "depthwise", "max_depth": 5,
                              "max_leaves": 9}, 3),
]


@pytest.mark.parametrize("case,extra,full_min", EXACT_CASES)
def test_lossguide_matches_jax(binary, case, extra, full_min):
    X, y = binary
    params = dict(LG, **extra)
    jb, tb = (_train(pkg, params, X, y) for pkg in (xgb, xt))
    _check(jb, tb, X, full_min)
    # the allocation order (parent before children) is the JAX package's
    if params["grow_policy"] == "lossguide":
        for a, b in zip(jb.gbm.trees, tb.gbm.trees):
            np.testing.assert_array_equal(a.left_child, b.left_child)
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            assert b.num_leaves() <= (params["max_leaves"]
                                      or 2 ** params["max_depth"])
    if params["max_depth"]:
        assert max(t.max_depth() for t in tb.gbm.trees) <= \
            params["max_depth"]


def test_lossguide_grows_deeper_than_a_heap_of_its_leaves():
    """``max_leaves`` 8 with no depth limit grows chains past depth 3 (the
    JAX package's ``test_lossguide_can_exceed_heap_depth``)."""
    X, y = _data(seed=3)
    params = dict(LG, max_leaves=8)
    jb, tb = (_train(pkg, params, X, y, 5) for pkg in (xgb, xt))
    _check(jb, tb, X, 5)
    assert max(t.max_depth() for t in tb.gbm.trees) >= 4
    assert all(t.num_leaves() == 8 for t in tb.gbm.trees)


@pytest.mark.parametrize("fracs", [(0.5, 1.0, 1.0), (0.7, 0.8, 0.5),
                                   (1.0, 1.0, 0.3), (1.0, 1.0, 1.0)])
def test_col_masks_bit_for_bit(fracs):
    """The column sampler draws the JAX package's masks in the same call
    order, over a base with columns missing."""
    kw = dict(colsample_bytree=fracs[0], colsample_bylevel=fracs[1],
              colsample_bynode=fracs[2])
    base = np.ones(13, bool)
    base[[2, 7]] = False
    depths = [0, 1, 1, 2, 2, 1, 3, 0, 2, 5, 5, 3]
    for seed in (0, 7, 2 ** 31 + 5, 3_000_000_017):
        mine = lossguide.col_masks(TrainParam(**kw), seed, 13, base)
        theirs = jax_lossguide.col_masks(JaxTrainParam(**kw), seed, 13, base)
        for d in depths:
            np.testing.assert_array_equal(mine(d), theirs(d))


@pytest.mark.parametrize("method", ["coarse", "fused", "scan"])
def test_two_level_lossguide_matches_jax(binary, method, monkeypatch):
    X, y = binary
    monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
    params = dict(LG, hist_method=method, max_leaves=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        jb = xgb.train(params, xgb.DMatrix(X, label=y), 3,
                       verbose_eval=False, obj=_jax_grid_objective)
    tb = xt.train(dict(params, **CPU), xt.DMatrix(X, label=y), 3,
                  verbose_eval=False)
    _check(jb, tb, X, 3)


def _count_builds(monkeypatch):
    calls = {"K2": 0, "K4": 0, "K3": 0}
    for key, name in (("K2", "build_hist_int8x2_reference"),
                      ("K4", "scan_acc_reference"),
                      ("K3", "build_hist_f32_reference")):
        def counted(*a, _key=key, _fn=getattr(H, name)):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(H, name, counted)
    return calls


def test_two_level_schedules_save_one_model(binary, monkeypatch):
    """``coarse`` / ``fused`` / ``scan`` grow the same lossguide model; a
    pair's search is two K2 builds (the coarse ids and the refine ids)
    under ``coarse`` and ``fused`` and one K4 build under ``scan``."""
    X, y = binary
    raws = {}
    for method, want in (("coarse", {"K2": 2, "K4": 0, "K3": 0}),
                         ("fused", {"K2": 2, "K4": 0, "K3": 0}),
                         ("scan", {"K2": 0, "K4": 1, "K3": 0})):
        calls = _count_builds(monkeypatch)
        b = xt.train(dict(LG, hist_method=method, **CPU),
                     xt.DMatrix(X, label=y), 3, verbose_eval=False)
        monkeypatch.undo()
        pairs = sum(t.num_leaves() for t in b.gbm.trees)   # root + pops
        assert calls == {k: v * pairs for k, v in want.items()}, method
        b.set_param({"hist_method": "scan"})
        raws[method] = bytes(b.save_raw("ubj"))
    assert raws["coarse"] == raws["fused"] == raws["scan"]


def test_auto_takes_k4_at_scale_and_k2_below(monkeypatch):
    """``auto``: the pair's build is K4 (the sorted build) from 65,536
    rows, K2 below; one build a pair."""
    X, y = _data(n=70_000, f=6, seed=4, missing=0.0)
    for n, kernel in ((70_000, "K4"), (60_000, "K2")):
        calls = _count_builds(monkeypatch)
        b = xt.train(dict(LG, max_leaves=5, **CPU),
                     xt.DMatrix(X[:n], label=y[:n]), 1, verbose_eval=False)
        monkeypatch.undo()
        assert calls[kernel] == b.gbm.trees[0].num_leaves() == 5
        assert sum(calls.values()) == 5


def test_uncapped_lossguide_equals_depthwise(binary):
    """A node's best split depends only on its rows, so lossguide with
    no binding cap grows depthwise's trees (the JAX package's
    ``test_lossguide_uncapped_equals_depthwise``)."""
    X, y = binary
    dm = xt.DMatrix(X, label=y)
    p_lg = xt.train(dict(LG, max_depth=4, max_leaves=0, **CPU), dm, 3,
                    verbose_eval=False).predict(dm)
    p_dw = xt.train({"objective": "binary:logistic", "max_depth": 4,
                     "eta": 0.3, "base_score": 0.5, **CPU}, dm, 3,
                    verbose_eval=False).predict(dm)
    assert np.abs(p_lg - p_dw).max() < 2e-5


def test_depthwise_max_leaves_is_the_truncated_heap(binary):
    """``select_max_leaves`` bit for bit on a grown heap, and the port's
    capped tree is that heap truncated."""
    X, y = binary
    binned = xt.DMatrix(X, label=y).binned(256, torch.device("cpu"))
    p = TrainParam(max_depth=5)
    g0 = torch.tensor(y - 0.5)
    gpair = torch.stack([g0, torch.full_like(g0, 0.25)], 1)
    full = grow.TreeGrower(p, binned.max_nbins, binned.cuts).grow(
        binned.bins, gpair, None)
    active, is_leaf = full.active.numpy(), full.is_leaf.numpy()
    for cap in (2, 5, 9, 40):
        got = grow.select_max_leaves(active, is_leaf, cap)
        want = jax_grow.select_max_leaves(active, is_leaf, cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        capped = grow.TreeGrower(TrainParam(max_depth=5, max_leaves=cap),
                                 binned.max_nbins, binned.cuts)
        g = capped.grow(binned.bins, gpair, None)
        exists, selected, _ = got
        np.testing.assert_array_equal(g.active.numpy(), exists)
        np.testing.assert_array_equal(g.split_feature.numpy() >= 0,
                                      selected)
        # every row's delta is the weight of its deepest kept node
        tree = capped.to_tree_model(g)
        assert tree.num_leaves() == min(cap, int((active & is_leaf).sum()))
        leaf = tree.heap_map[g.positions.numpy()]
        np.testing.assert_array_equal(g.delta.numpy(),
                                      tree.leaf_value[leaf])


def _cat_data(n=3000, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    X[:, 6] = rng.randint(0, 4, n)                 # one-hot (<= 4)
    X[:, 7] = rng.randint(0, 30, n)                # sorted partition
    X[rng.rand(n) < 0.02, 7] = np.nan
    eff = rng.randn(30)
    y = (X[:, 0] + eff[np.nan_to_num(X[:, 7]).astype(int)]
         + 0.5 * (X[:, 6] == 2) + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y, {"feature_types": ["q"] * 6 + ["c", "c"],
                  "enable_categorical": True}


@pytest.mark.parametrize("kind", ["multiclass", "categorical", "dart"])
def test_other_forests_grow_lossguide_as_jax(kind):
    dm_kw = None
    extra = {}
    if kind == "multiclass":
        X, _ = _data(seed=6)
        rng = np.random.RandomState(6)
        y = np.argmax(np.nan_to_num(X[:, :3]) + 0.5 * rng.randn(3000, 3),
                      1).astype(np.float32)
        extra = {"objective": "multi:softprob", "num_class": 3,
                 "base_score": 0.5}
    elif kind == "categorical":
        X, y, dm_kw = _cat_data()
    else:
        X, y = _data(seed=8)
        extra = {"booster": "dart", "rate_drop": 0.4, "skip_drop": 0.0}
    params = dict(LG, **extra)
    jb, tb = (_train(pkg, params, X, y, 3, dm_kw=dm_kw)
              for pkg in (xgb, xt))
    _check(jb, tb, X, 9 if kind == "multiclass" else 3, dm_kw=dm_kw)
    if kind == "categorical":
        cats = [t.split_feature[t.is_cat_split] for t in tb.gbm.trees]
        found = set(np.concatenate(cats).tolist())
        assert found == {6, 7}, found
        for a, b in zip(jb.gbm.trees, tb.gbm.trees):
            np.testing.assert_array_equal(a.is_cat_split, b.is_cat_split)
            w = min(a.cat_words.shape[1], b.cat_words.shape[1])
            np.testing.assert_array_equal(a.cat_words[:, :w],
                                          b.cat_words[:, :w])
    if kind == "dart":
        assert tb.gbm.weight_drop == pytest.approx(jb.gbm.weight_drop,
                                                   rel=1e-6)


@pytest.fixture(scope="module")
def lg_models(binary):
    X, y = binary
    params = dict(LG, max_leaves=10)
    return X, y, _train(xgb, params, X, y), _train(xt, params, X, y)


def test_lossguide_models_load_both_ways(lg_models):
    """A lossguide model saved by either package loads into the other and
    predicts the same margin bits (the probabilities to the two sigmoids'
    rounding); the dumps and ``pred_leaf`` are equal."""
    X, _, jb, tb = lg_models
    for fmt in ("json", "ubj"):
        into_jax = xgb.Booster(model_file=tb.save_raw(fmt))
        into_port = xt.Booster(CPU, model_file=jb.save_raw(fmt))
        for a, b in ((into_jax, tb), (jb, into_port)):
            np.testing.assert_array_equal(
                a.predict(xgb.DMatrix(X), output_margin=True),
                b.predict(xt.DMatrix(X), output_margin=True))
            np.testing.assert_allclose(a.predict(xgb.DMatrix(X)),
                                       b.predict(xt.DMatrix(X)), rtol=1e-6)
        assert bytes(into_port.save_raw(fmt)) == bytes(jb.save_raw(fmt))
    same = xt.Booster(CPU, model_file=jb.save_raw("json"))
    for fmt in ("text", "json"):
        assert same.get_dump(with_stats=True, dump_format=fmt) == \
            jb.get_dump(with_stats=True, dump_format=fmt)
    np.testing.assert_array_equal(
        same.predict(xt.DMatrix(X), pred_leaf=True),
        jb.predict(xgb.DMatrix(X), pred_leaf=True))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.json")
        xt.save_xgboost_model(tb, path)
        with open(path) as fh:
            trees = json.load(fh)["learner"]["gradient_booster"]["model"][
                "trees"]
        assert [int(t["tree_param"]["num_nodes"]) for t in trees] == \
            [t.num_nodes() for t in tb.gbm.trees]


@pytest.mark.parametrize("updater", ["refresh", "refresh,prune"])
def test_refresh_and_prune_over_lossguide_trees(lg_models, updater):
    X, y, jb, _ = lg_models
    p = {"objective": "binary:logistic", "process_type": "update",
         "updater": updater, "gamma": 25.0}
    raw = jb.save_raw("json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        jr = xgb.train(dict(p, hist_method="prehot"),
                       xgb.DMatrix(X, label=y), 3,
                       xgb_model=xgb.Booster(model_file=raw),
                       verbose_eval=False)
    tr = xt.train(dict(p, **CPU), xt.DMatrix(X, label=y), 3,
                  xgb_model=xt.Booster(CPU, model_file=raw),
                  verbose_eval=False)
    assert tr.num_boosted_rounds() == jr.num_boosted_rounds() == 3
    full, ties, _ = compare_forests(jr.gbm.trees, tr.gbm.trees, 0.3)
    assert full == 3 and not ties
    if "prune" in updater:
        assert sum(t.num_nodes() for t in tr.gbm.trees) < \
            sum(t.num_nodes() for t in jb.gbm.trees)


def test_lossguide_refusals_and_fall_back(binary):
    X, y = binary
    dm = xt.DMatrix(X[:500], label=y[:500])
    # mega is the scan search on the device's greedy loop
    # (tests/test_torch_mega.py): the same bytes once one method is
    # recorded
    raws = []
    for m in ("scan", "mega"):
        b = xt.train(dict(LG, hist_method=m, **CPU), dm, 1)
        b.set_param({"hist_method": "scan"})
        raws.append(bytes(b.save_raw("ubj")))
    assert raws[0] == raws[1]
    with pytest.raises(ValueError, match="max_leaves > 0 or max_depth > 0"):
        xt.train(dict(LG, max_leaves=0, **CPU), dm, 1)
    with pytest.raises(ValueError, match="unknown grow_policy"):
        xt.train(dict(LG, grow_policy="leafwise", **CPU), dm, 1)
    Xc, yc, kw = _cat_data(n=600)
    with pytest.warns(UserWarning, match="categorical.*falling back"):
        fb = xt.train(dict(LG, hist_method="coarse", **CPU),
                      xt.DMatrix(Xc, label=yc, **kw), 2, verbose_eval=False)
    auto = xt.train(dict(LG, **CPU), xt.DMatrix(Xc, label=yc, **kw), 2,
                    verbose_eval=False)
    np.testing.assert_array_equal(fb.predict(xt.DMatrix(Xc, **kw)),
                                  auto.predict(xt.DMatrix(Xc, **kw)))
