"""``tree_method="exact"`` in the port against the JAX package, on the
CPU.

Every distinct finite value of a feature is its own rank
(``tree/exact.py ExactQuantization``, the JAX package's encoding bit for
bit); the port's level loop scores one feature at a time with a
scatter-add and a cumulative sum, as the JAX package's ``lax.scan``
does. The f32 sums round in another order than XLA's, so trees are held
node by node under ``tests/test_torch_train.py``'s near-tie
certificate, leaves and predictions at rtol 1e-5 plus 1e-4. Also: the
thresholds are midpoints (the JAX package's anchors of
``tests/test_updaters.py``), missing values go each way, the advance
over int32 ranks wider than any bin dtype, model files and the
refusals. Small sizes (1,500 rows, depth 3-4, 4 rounds).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.ops.partition import update_positions as jax_update
from xgboost_tpu.tree.exact import ExactQuantization as JaxQuant
from xgboost_tpu_torch.ops.partition import update_positions
from xgboost_tpu_torch.tree.exact import ExactQuantization

from test_torch_approx import relabel, round_by_round
from test_torch_paged import PortIter
from test_torch_train import LEAF_ATOL, compare_forests

ROUNDS = 4


def _data(seed, n=1500, F=6, classes=0, nan=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[:, 3] = rng.randint(0, 9, n)                # tied values
    X[rng.rand(n, F) < nan] = np.nan
    Z = np.nan_to_num(X)
    if classes:
        y = np.argmax(Z[:, :classes] + 0.7 * rng.randn(n, classes), 1)
    else:
        y = Z[:, 0] + Z[:, 1] * Z[:, 2] + 0.3 * rng.randn(n) > 0
    return X, y.astype(np.float32)


def test_rank_encoding_is_the_jax_packages():
    X, _ = _data(1)
    X[:5, 4] = np.inf
    X[5:9, 4] = -0.0
    want = JaxQuant(X)
    got = ExactQuantization(X)
    assert got.n_ranks == want.n_ranks
    assert np.array_equal(got.ranks, np.asarray(want.ranks))
    assert np.array_equal(got.midpoints.view(np.uint32),
                          np.asarray(want.midpoints).view(np.uint32))
    assert np.array_equal(got.n_distinct, np.asarray(want.n_distinct))


# (name, params, data kwargs, trees equal in full end to end, rounds
# without a near tie round by round), as measured on the CPU; dart is
# compared end to end only
EXACT_CASES = [
    ("binary", {"objective": "binary:logistic", "max_depth": 4}, {}, 1, 3),
    ("regression", {"objective": "reg:squarederror", "max_depth": 4,
                    "min_child_weight": 3, "gamma": 0.1}, {}, 2, 3),
    ("3-class", {"objective": "multi:softprob", "num_class": 3,
                 "max_depth": 3}, {"classes": 3}, 4, 3),
    ("sampling", {"objective": "binary:logistic", "max_depth": 4,
                  "subsample": 0.7}, {}, 3, 3),
    ("dart", {"objective": "binary:logistic", "max_depth": 3,
              "booster": "dart", "rate_drop": 0.5}, {}, 4, None),
    ("weights", {"objective": "binary:logistic", "max_depth": 4}, {}, 0, 1),
    ("ranking", {"objective": "rank:ndcg", "max_depth": 4},
     {"kind": "rank"}, 4, None),
    ("adaptive", {"objective": "reg:absoluteerror", "max_depth": 4},
     {"kind": "adaptive"}, 4, None),
    ("survival", {"objective": "survival:cox", "max_depth": 4},
     {"kind": "survival"}, 0, None),
    ("label_matrix", {"objective": "reg:squarederror", "max_depth": 4},
     {"kind": "targets"}, 4, None),
]


@pytest.mark.parametrize("name,params,data_kw,full_min,clean_min",
                         EXACT_CASES, ids=[c[0] for c in EXACT_CASES])
def test_exact_trees_match_jax(name, params, data_kw, full_min, clean_min):
    kind = data_kw.get("kind")
    X, y = _data(2, **{k: v for k, v in data_kw.items() if k != "kind"})
    y, kw = relabel(kind, X, y)
    w = (np.random.RandomState(3).uniform(0.2, 3.0, len(X))
         .astype(np.float32) if name == "weights" else None)
    p = dict({"eta": 0.3, "tree_method": "exact"}, **params)
    if kind is None:
        p["base_score"] = 0.5
    jd = xgb.DMatrix(X, label=y, weight=w, **kw)
    jb = xgb.train(p, jd, ROUNDS, verbose_eval=False)
    tb = xt.train(dict(p, device="cpu"),
                  xt.DMatrix(X, label=y, weight=w, **kw), ROUNDS,
                  verbose_eval=False)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3)
    print(name, "end to end: trees equal in full:", full, "near ties:",
          ties, "leaf drift:", drift)
    assert full >= full_min
    for t in tb.gbm.trees:
        split = ~t.is_leaf
        vals = X[:, t.split_feature[split]]
        # every threshold lies strictly between two of its feature's values
        assert np.all(np.nanmin(vals, 0) < t.split_value[split])
        assert np.all(t.split_value[split] < np.nanmax(vals, 0))
    K = params.get("num_class", y.shape[1] if y.ndim == 2 else 1)
    np.testing.assert_allclose(
        tb.predict(xt.DMatrix(X), iteration_range=(0, full // K)),
        jb.predict(xgb.DMatrix(X), iteration_range=(0, full // K)),
        rtol=1e-5, atol=LEAF_ATOL)
    if clean_min is None:
        return
    clean, drift, _ = round_by_round(jb, jd, X, y, w, p, {}, [])
    print(name, "round by round: rounds with no near tie:", clean,
          "leaf drift:", drift)
    assert clean >= clean_min


def test_exact_thresholds_are_midpoints():
    """The JAX package's anchor (``tests/test_updaters.py``): a split
    between 2 and 5 at 3.5."""
    X = np.asarray([[1.0], [2.0], [5.0], [6.0]], np.float32)
    y = np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
    b = xt.train({"objective": "reg:squarederror", "max_depth": 1,
                  "tree_method": "exact", "lambda": 0.0, "device": "cpu"},
                 xt.DMatrix(X, label=y), 1)
    t = b.gbm.trees[0]
    assert t.split_feature[0] == 0
    assert t.split_value[0] == pytest.approx(3.5)


def test_three_methods_agree_on_separable_data():
    """The JAX package's anchor: on few distinct values hist, approx and
    exact find the same splits; the port's predictions equal each other
    and the JAX package's."""
    rng = np.random.RandomState(0)
    X = rng.randint(0, 8, (300, 4)).astype(np.float32)
    y = ((X[:, 0] > 3) ^ (X[:, 1] > 5)).astype(np.float32)
    preds = {}
    for tm in ("hist", "exact", "approx"):
        p = {"objective": "binary:logistic", "max_depth": 3,
             "tree_method": tm}
        preds[tm] = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y),
                             5).predict(xt.DMatrix(X))
        jp = xgb.train(p, xgb.DMatrix(X, label=y), 5, verbose_eval=False
                       ).predict(xgb.DMatrix(X))
        np.testing.assert_allclose(preds[tm], jp, atol=1e-5)
    np.testing.assert_allclose(preds["hist"], preds["exact"], atol=1e-5)
    np.testing.assert_allclose(preds["hist"], preds["approx"], atol=1e-5)


@pytest.mark.parametrize("side", ["left", "right"])
def test_missing_values_go_their_learned_way(side):
    """A feature whose missing rows behave like its low (or high) values:
    the root sends them that way, as the JAX package's does."""
    rng = np.random.RandomState(4)
    X = rng.randn(800, 2).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    miss = rng.rand(800) < 0.3
    y[miss] = 0.0 if side == "left" else 1.0
    X[miss, 0] = np.nan
    p = {"objective": "binary:logistic", "max_depth": 1,
         "tree_method": "exact"}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 1)
    jb = xgb.train(p, xgb.DMatrix(X, label=y), 1, verbose_eval=False)
    t, j = tb.gbm.trees[0], jb.gbm.trees[0]
    assert t.split_feature[0] == j.split_feature[0] == 0
    assert bool(t.default_left[0]) == bool(j.default_left[0]) == (
        side == "left")
    probe = np.asarray([[np.nan, 0.0]], np.float32)
    np.testing.assert_allclose(tb.predict(xt.DMatrix(probe)),
                               jb.predict(xgb.DMatrix(probe)), rtol=1e-5)


def test_advance_over_wide_int32_ranks():
    """``update_positions`` over int32 ranks above any bin dtype's range,
    the missing rank going the default way, equals the JAX package's."""
    rng = np.random.RandomState(5)
    n, F, R = 4000, 3, 100_000
    ranks = rng.randint(0, R, (n, F)).astype(np.int32)
    ranks[rng.rand(n, F) < 0.1] = R                 # missing
    max_nodes = 15
    positions = rng.randint(3, 7, n).astype(np.int64)
    feat = rng.randint(0, F, max_nodes).astype(np.int64)
    thr = rng.randint(0, R, max_nodes).astype(np.int64)
    dleft = rng.rand(max_nodes) < 0.5
    is_split = np.zeros(max_nodes, bool)
    is_split[3:6] = True
    got = update_positions(
        torch.from_numpy(ranks), torch.from_numpy(positions),
        torch.from_numpy(feat), torch.from_numpy(thr),
        torch.from_numpy(dleft), torch.from_numpy(is_split), R)
    want = jax_update(jnp.asarray(ranks), jnp.asarray(positions, jnp.int32),
                      jnp.asarray(feat, jnp.int32), jnp.asarray(thr,
                                                                jnp.int32),
                      jnp.asarray(dleft), jnp.asarray(is_split), R)
    assert np.array_equal(got.numpy(), np.asarray(want))
    moved = is_split[positions]
    assert np.all(got.numpy()[~moved] == positions[~moved])


def test_exact_model_file_loads_into_jax():
    X, y = _data(6)
    p = {"objective": "binary:logistic", "max_depth": 4,
         "tree_method": "exact"}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 3)
    raw = tb.save_raw("json")
    jb = xgb.Booster(model_file=raw)
    assert jb.learner_params["tree_method"] == "exact"
    np.testing.assert_allclose(jb.predict(xgb.DMatrix(X)),
                               tb.predict(xt.DMatrix(X)), rtol=1e-6)
    again = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    assert bytes(again.save_raw("json")) == bytes(raw)


@pytest.mark.parametrize("params,exc", [
    ({"grow_policy": "lossguide", "max_leaves": 4}, ValueError),
    ({"max_leaves": 4}, NotImplementedError),
    ({"hist_method": "coarse"}, NotImplementedError),
    ({"hist_method": "fused"}, NotImplementedError),
    ({"hist_method": "scan"}, NotImplementedError),
    ({"hist_method": "mega"}, NotImplementedError),
    ({"multi_strategy": "multi_output_tree", "objective": "multi:softprob",
      "num_class": 3}, NotImplementedError),
])
def test_exact_refusals_match_jax(params, exc):
    X, y = _data(7, n=300, classes=3)
    p = dict({"objective": "binary:logistic", "tree_method": "exact",
              "max_depth": 3}, **params)
    yy = y if "num_class" in p else (y > 0).astype(np.float32)
    msgs = []
    for pkg, extra in ((xgb, {}), (xt, {"device": "cpu"})):
        with pytest.raises(exc) as err:
            pkg.train(dict(p, **extra), pkg.DMatrix(X, label=yy), 1,
                      verbose_eval=False)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_exact_refuses_a_paged_matrix(tmp_path, monkeypatch):
    monkeypatch.setenv("XTPU_PAGE_ROWS", "200")
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    X, y = _data(8, n=600)
    tq = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / "e")), max_bin=16)
    with pytest.raises(NotImplementedError, match="paged"):
        xt.train({"objective": "binary:logistic", "max_bin": 16,
                  "tree_method": "exact", "device": "cpu"}, tq, 1)


def test_exact_refuses_categorical_data_where_jax_trains_codes():
    """Upstream ColMaker refuses categorical data; the JAX package ranks
    the codes as numbers and trains. The port refuses as upstream does
    (ROADMAP C, Decisions)."""
    X, y = _data(9, n=400)
    X[:, 5] = np.random.RandomState(10).randint(0, 6, 400)
    types = ["q"] * 5 + ["c"]
    p = {"objective": "binary:logistic", "tree_method": "exact",
         "max_depth": 3}
    xgb.train(p, xgb.DMatrix(X, label=y, feature_types=types,
                             enable_categorical=True), 1,
              verbose_eval=False)
    with pytest.raises(ValueError, match="categorical"):
        xt.train(dict(p, device="cpu"), xt.DMatrix(
            X, label=y, feature_types=types, enable_categorical=True), 1)
