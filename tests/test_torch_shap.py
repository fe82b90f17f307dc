"""SHAP contributions, interactions and Saabas contributions: the port's
per-leaf float64 path (``ops/shap.py``, run here on the CPU) and its
plain host recursion (``boosting/shap.py``) against the JAX package's
``Booster.predict`` (its native library: the recursion in float32,
sums in float64) and its pure-Python ``_tree_shap_py``.

Tolerances: the port's two float64 paths agree to ``F64_TOL``; against
the JAX package, whose recursion rounds in float32, ``JAX_TOL`` (rtol
and atol 1e-6; measured at most 3e-7 on these forests). Rows sum to
the margin to ``SUM_TOL`` (the margin is an f32 sum over the trees).
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.boosting import shap as jax_shap
from xgboost_tpu_torch.boosting import shap as plain
from xgboost_tpu_torch.ops import shap as shap_ops

F64_TOL = 1e-12
JAX_TOL = 1e-6
SUM_TOL = 1e-5


def _data(seed, n=1200, F=7, classes=0, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if cat:
        X[:, F - 2] = rng.randint(0, 4, n)
        X[:, F - 1] = rng.randint(0, 30, n)
    s = X[:, 0] * X[:, 1] + X[:, 2] + 0.3 * rng.randn(n)
    if cat:
        s = s + rng.randn(30)[X[:, F - 1].astype(int)]
    X[rng.rand(n, F) < 0.08] = np.nan
    if classes:
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3]))
    else:
        y = s > 0
    return X, y.astype(np.float32)


CASES = {
    "binary": ({"objective": "binary:logistic", "max_depth": 4}, {}, 6),
    "deep": ({"objective": "binary:logistic", "max_depth": 8,
              "min_child_weight": 0.1}, {}, 3),
    "multiclass": ({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 3}, {"classes": 3}, 3),
    "categorical": ({"objective": "binary:logistic", "max_depth": 4},
                    {"cat": True}, 4),
    "dart": ({"objective": "binary:logistic", "max_depth": 4,
              "booster": "dart", "rate_drop": 0.5}, {}, 5),
    "lossguide": ({"objective": "binary:logistic", "max_depth": 0,
                   "grow_policy": "lossguide", "max_leaves": 24}, {}, 3),
}
ROWS = 60


def _model(name):
    params, data_kw, rounds = CASES[name]
    X, y = _data(sum(map(ord, name)), **data_kw)
    kw = {}
    if data_kw.get("cat"):
        kw = {"feature_types": ["q"] * (X.shape[1] - 2) + ["c", "c"],
              "enable_categorical": True}
    tb = xt.train(dict(params, device="cpu", eta=0.5), xt.DMatrix(
        X, label=y, **kw), rounds, verbose_eval=False)
    jb = xgb.Booster(model_file=tb.save_raw("json"))
    Xq = X[:ROWS].copy()
    if data_kw.get("cat"):
        Xq[:5, -1] = [-1.0, 31.0, 1e9, 2.5, np.nan]   # codes out of range
    return tb, jb, Xq, kw


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    return (request.param,) + _model(request.param)


@pytest.mark.parametrize("kind", ["contribs", "approx", "interactions"])
def test_predict_matches_jax(model, kind):
    """``Booster.predict`` of each kind against the JAX package's, f32
    outputs of the same shape; each contribution row sums to the margin,
    each interaction row to the contribution."""
    name, tb, jb, X, kw = model
    flags = {"contribs": {"pred_contribs": True},
             "approx": {"pred_contribs": True, "approx_contribs": True},
             "interactions": {"pred_interactions": True}}[kind]
    got = tb.predict(xt.DMatrix(X, **kw), **flags)
    want = jb.predict(xgb.DMatrix(X, **kw), **flags)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
    margin = tb.predict(xt.DMatrix(X, **kw), output_margin=True)
    if kind == "interactions":
        contribs = tb.predict(xt.DMatrix(X, **kw), pred_contribs=True)
        np.testing.assert_allclose(got.sum(-1), contribs, rtol=0,
                                   atol=SUM_TOL)
    else:
        np.testing.assert_allclose(got.sum(-1), margin, rtol=0,
                                   atol=SUM_TOL)


def test_per_leaf_path_matches_the_plain_recursion(model):
    """The per-leaf float64 path (``ops/shap.py``) against the port's
    plain recursion, contributions, interactions and Saabas, and both
    against the JAX package's pure-Python recursion."""
    name, tb, jb, X, kw = model
    X = np.asarray(xt.DMatrix(X, **kw).values(), np.float32)
    trees, info, w = tb.gbm.forest_slice(None)
    base, G = tb._base_np(), tb.n_groups
    pack = tb._shap_pack(None)
    Xt = torch.from_numpy(X)
    host = plain.tree_shap(X, trees, info, G, base, w)
    dev = shap_ops.contribs(pack, Xt, base).numpy()
    np.testing.assert_allclose(dev, host, rtol=F64_TOL, atol=F64_TOL)
    n_int = 12
    host_i = plain.shap_interactions(X[:n_int], trees, info, G, base, w)
    dev_i = shap_ops.interactions(pack, Xt[:n_int], base).numpy()
    np.testing.assert_allclose(dev_i, host_i, rtol=F64_TOL, atol=F64_TOL)
    host_a = plain.approx_contribs(X, trees, info, G, base, w)
    dev_a = shap_ops.saabas(pack, Xt, base).numpy()
    np.testing.assert_allclose(dev_a, host_a, rtol=F64_TOL, atol=F64_TOL)
    # the JAX package's pure-Python mirror (numpy scalars keep parts of
    # it in float32)
    jt, ji, jw = jb.gbm.forest_slice(None)
    arr, T, M, W, tw, tg, bs = jax_shap._prepare(jt, ji, base, jw)
    out = np.zeros((len(X), G, X.shape[1] + 1))
    jpy = jax_shap._tree_shap_py(X, arr, T, M, W, tw, tg, G, bs, 0, 0, out)
    np.testing.assert_allclose(host, jpy, rtol=JAX_TOL, atol=JAX_TOL)
    jint = jax_shap.shap_interactions(X[:n_int], jt, ji, G, base, jw)
    np.testing.assert_allclose(host_i, jint, rtol=JAX_TOL, atol=JAX_TOL)


def test_iteration_range_and_strict_shape():
    tb, jb, X, _ = _model("multiclass")
    for rng in ((0, 1), (1, 3), (2, 0)):
        got = tb.predict(xt.DMatrix(X), pred_contribs=True,
                         iteration_range=rng)
        want = jb.predict(xgb.DMatrix(X), pred_contribs=True,
                          iteration_range=rng)
        np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
        np.testing.assert_allclose(got.sum(-1), tb.predict(
            xt.DMatrix(X), output_margin=True, iteration_range=rng),
            rtol=0, atol=SUM_TOL)
    tb1, jb1, X1, _ = _model("binary")
    for flags in ({"pred_contribs": True}, {"pred_interactions": True}):
        got = tb1.predict(xt.DMatrix(X1), strict_shape=True, **flags)
        want = jb1.predict(xgb.DMatrix(X1), strict_shape=True, **flags)
        assert got.shape == want.shape and got.shape[1] == 1
        np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)


def test_no_trees_in_range_gives_the_base():
    tb, jb, X, _ = _model("binary")
    got = tb.predict(xt.DMatrix(X), pred_contribs=True,
                     iteration_range=(3, 3))
    jbs = jb[3:3]
    want = jbs.predict(xgb.DMatrix(X), pred_contribs=True)
    np.testing.assert_array_equal(got, want)
    got_i = tb.predict(xt.DMatrix(X), pred_interactions=True,
                       iteration_range=(3, 3))
    assert (got_i[:, -1, -1] == tb._base_np()[0]).all()
    assert (got_i[:, :-1] == 0).all()


def test_refusals_match_jax():
    """Vector-leaf models refuse contributions and interactions, and
    approximate interactions are refused, in both packages."""
    rng = np.random.RandomState(3)
    X = rng.randn(300, 5).astype(np.float32)
    Y = X[:, :2] + 0.1 * rng.randn(300, 2).astype(np.float32)
    tb = xt.train({"objective": "reg:squarederror", "device": "cpu",
                   "multi_strategy": "multi_output_tree", "max_depth": 3},
                  xt.DMatrix(X, label=Y), 2, verbose_eval=False)
    jb = xgb.Booster(model_file=tb.save_raw("json"))
    for b, pkg in ((tb, xt), (jb, xgb)):
        for flags in ({"pred_contribs": True}, {"pred_interactions": True}):
            with pytest.raises(NotImplementedError, match="multi_output_tree"):
                b.predict(pkg.DMatrix(X), **flags)
    tb1, jb1, X1, _ = _model("binary")
    for b, pkg in ((tb1, xt), (jb1, xgb)):
        with pytest.raises(NotImplementedError, match="approx_contribs"):
            b.predict(pkg.DMatrix(X1), pred_interactions=True,
                      approx_contribs=True)


def test_pack_layout_of_a_known_tree():
    """A hand-made tree whose one path splits feature 0 twice: one slot
    for it, its zero fraction the product of both cover ratios, and the
    rows' one-fractions 1 only where they follow both edges."""
    from xgboost_tpu_torch.testing import make_forest

    trees, info = make_forest(3, 5, 4, seed=7)
    pack = shap_ops.build_shap_pack(trees, info, None, 1)
    a = pack.arrays
    assert pack.T == 3 and pack.D == 5 and 1 <= pack.K <= 4
    for t, tree in enumerate(trees):
        leaves = np.nonzero(tree.is_leaf)[0]
        assert a["leaf_valid"][t].sum() == len(leaves)
        for li, nid in enumerate(leaves):
            path, z = [], {}
            c = nid
            while tree.parent[c] >= 0:
                p = tree.parent[c]
                f = int(tree.split_feature[p])
                path.append(f)
                z[f] = z.get(f, 1.0) * (float(tree.sum_hess[c])
                                        / float(tree.sum_hess[p]))
                c = p
            valid = a["slot_valid"][t, li]
            feats = a["slot_feat"][t, li][valid]
            assert sorted(feats) == sorted(set(path))
            for k, f in zip(np.nonzero(valid)[0], feats):
                assert a["slot_z"][t, li, k] == pytest.approx(z[f],
                                                             rel=1e-15)
    X = torch.from_numpy(np.random.RandomState(8).randn(40, 4).astype(
        np.float32))
    host = plain.tree_shap(X.numpy(), trees, info, 1, np.zeros(1))
    np.testing.assert_allclose(shap_ops.contribs(pack, X, np.zeros(1)),
                               host, rtol=F64_TOL, atol=F64_TOL)


def test_chunking_does_not_change_the_result(monkeypatch):
    """Chunks of one tree and a few rows give the same values as one
    chunk (the sums are per tree, then over trees in order)."""
    tb, _, X, _ = _model("multiclass")
    pack = tb._shap_pack(None)
    Xt = torch.from_numpy(X)
    base = tb._base_np()
    whole = [fn(pack, Xt, base) for fn in (shap_ops.contribs,
                                           shap_ops.saabas)]
    whole_i = shap_ops.interactions(pack, Xt[:10], base)
    monkeypatch.setattr(shap_ops, "SHAP_TREE_CHUNK", 1)
    monkeypatch.setattr(shap_ops, "SHAP_CHUNK_BYTES", 4096)
    cut = [fn(pack, Xt, base) for fn in (shap_ops.contribs, shap_ops.saabas)]
    for a, b in zip(whole, cut):
        np.testing.assert_allclose(a, b, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(
        shap_ops.interactions(pack, Xt[:10], base), whole_i, rtol=F64_TOL,
        atol=F64_TOL)
