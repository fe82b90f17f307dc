"""The port's scikit-learn wrappers and ``cv`` against the JAX
package's, on the CPU, from the same seeded inputs.

The JAX package trains with ``hist_method="prehot"`` (the port's
``auto`` sums the same int8x2 integers), so the trees are the same node
by node (``test_torch_train.compare_forests``: every split the same,
leaves within its ``LEAF_ATOL``; each configuration here was picked
with no near tie, as measured on the CPU), predictions then agree to
``PRED_RTOL`` / ``LEAF_ATOL``, eval histories to ``EVAL_TOL`` and the
best round exactly. ``cv``'s folds are the same rows. The wrappers'
own layer is held tighter: a wrapper's model is ``train``'s with the
parameters it maps, byte for byte.
"""

import copy

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt

from test_torch_train import LEAF_ATOL, compare_forests

PRED_RTOL = 1e-5
EVAL_TOL = 1e-4
JAX = {"hist_method": "prehot"}
PORT = {"device": "cpu"}


def _data(seed=0, n=1600, F=8, classes=3):
    """Labels from a clear rule on the first features (few near ties)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.02] = np.nan
    s = 2.0 * np.nan_to_num(X[:, :3]) + 0.2 * rng.randn(n, 3)
    y = np.argmax(s, 1) if classes == 3 else (s[:, 0] > s[:, 1])
    return X, y


def _fit_both(cls_name, fit_kw=None, **params):
    X, y = _data(classes=params.pop("classes", 3))
    n = 1200
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        est = getattr(pkg, cls_name)(**params, **extra)
        est.fit(X[:n], y[:n], eval_set=[(X[:n], y[:n]), (X[n:], y[n:])],
                verbose=False, **(fit_kw or {}))
        out.append(est)
    return out[0], out[1], X


def _same_trees(j, t, eta=0.3, lam=1.0):
    """Both boosters' forests the same node by node, no near tie."""
    jt, tt = j.gbm.trees, t.gbm.trees
    full, ties, _ = compare_forests(jt, tt, eta, lam)
    assert len(jt) == len(tt) and (full, ties) == (len(jt), [])


def _assert_evals(a, b):
    assert a.keys() == b.keys()
    for d in a:
        assert a[d].keys() == b[d].keys()
        for m in a[d]:
            np.testing.assert_allclose(b[d][m], a[d][m], rtol=0,
                                       atol=EVAL_TOL)


def test_classifier_with_early_stopping_matches_jax():
    """Labels encoded from the classes, multi:softprob for three, eval
    sets, early stopping (the best round, and predictions cut at it),
    predict_proba / predict / score and gain importances."""
    je, te, X = _fit_both("XGBClassifier", n_estimators=40, max_depth=3,
                          learning_rate=0.5, early_stopping_rounds=3,
                          eval_metric="mlogloss")
    _same_trees(je.get_booster(), te.get_booster(), eta=0.5)
    assert te.best_iteration == je.best_iteration < 39
    assert te.get_booster().num_boosted_rounds() == \
        je.get_booster().num_boosted_rounds()
    _assert_evals(je.evals_result(), te.evals_result())
    np.testing.assert_allclose(te.predict_proba(X), je.predict_proba(X),
                               rtol=PRED_RTOL, atol=LEAF_ATOL)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert list(te.classes_) == list(je.classes_) == [0, 1, 2]
    assert te.score(X, _data()[1]) == je.score(X, _data()[1])
    np.testing.assert_allclose(te.feature_importances_,
                               je.feature_importances_, rtol=1e-4,
                               atol=1e-6)
    assert te.n_features_in_ == 8


def test_binary_classifier_on_string_labels_and_base_margin():
    X, y = _data(classes=2)
    labels = np.where(y, "yes", "no")
    margin = np.linspace(-0.5, 0.5, len(X)).astype(np.float32)
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        est = pkg.XGBClassifier(n_estimators=5, max_depth=3, **extra)
        est.fit(X, labels, base_margin=margin)
        out.append(est)
    je, te = out
    _same_trees(je.get_booster(), te.get_booster())
    assert list(te.classes_) == ["no", "yes"]
    np.testing.assert_array_equal(te.predict(X, base_margin=margin),
                                  je.predict(X, base_margin=margin))
    np.testing.assert_allclose(
        te.predict_proba(X, base_margin=margin),
        je.predict_proba(X, base_margin=margin), rtol=PRED_RTOL,
        atol=LEAF_ATOL)
    np.testing.assert_allclose(te.predict(X, output_margin=True),
                               je.predict(X, output_margin=True),
                               rtol=PRED_RTOL, atol=LEAF_ATOL)


def test_regressor_apply_and_linear_coefficients():
    X, y = _data(classes=2)
    target = np.nan_to_num(X[:, 0]) * 2.0 - np.nan_to_num(X[:, 3]) + 1.0
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        tree = pkg.XGBRegressor(n_estimators=4, max_depth=3, **extra)
        tree.fit(X, target)
        lin = pkg.XGBRegressor(booster="gblinear", n_estimators=6,
                               reg_lambda=1.0, **extra)
        lin.fit(X, target)
        out.append((tree, lin))
    (jt, jl), (tt, tl) = out
    _same_trees(jt.get_booster(), tt.get_booster())
    np.testing.assert_allclose(tt.predict(X), jt.predict(X), rtol=PRED_RTOL,
                               atol=LEAF_ATOL)
    np.testing.assert_array_equal(tt.apply(X), jt.apply(X))
    assert tl.coef_.shape == (8,) and tl.intercept_.shape == (1,)
    np.testing.assert_allclose(tl.coef_, jl.coef_, rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(tl.intercept_, jl.intercept_, rtol=5e-6,
                               atol=5e-6)
    np.testing.assert_allclose(tl.feature_importances_,
                               jl.feature_importances_, rtol=1e-4,
                               atol=1e-6)
    assert 1.5 < tl.coef_[0] < 2.0
    for est in (tt, jt):
        with pytest.raises(AttributeError, match="coef_"):
            est.coef_


def test_ranker_and_random_forests_match_jax():
    rng = np.random.RandomState(5)
    sizes = rng.randint(5, 20, 40)
    X = rng.randn(sizes.sum(), 6).astype(np.float32)
    y = np.clip(np.round(2.0 * X[:, 0] + 0.2 * rng.randn(len(X))), 0, 3)
    qid = np.repeat(np.arange(40), sizes)
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        rk = pkg.XGBRanker(n_estimators=4, max_depth=2, **extra)
        rk.fit(X, y, qid=qid)
        rf = pkg.XGBRFClassifier(n_estimators=3, max_depth=2,
                                 num_parallel_tree=4, **extra)
        rf.fit(X, y > 1)
        rr = pkg.XGBRFRegressor(max_depth=3, num_parallel_tree=4, **extra)
        rr.fit(X, y)
        out.append((rk, rf, rr))
    for j, t in zip(*out):
        _same_trees(j.get_booster(), t.get_booster(),
                    *((0.3, 1.0) if j is out[0][0] else (1.0, 1e-5)))
        np.testing.assert_allclose(t.predict(X), j.predict(X),
                                   rtol=PRED_RTOL, atol=LEAF_ATOL)
    assert out[1][1].get_booster().num_boosted_rounds() == 1
    assert len(out[1][1].get_booster().gbm.trees) == 4
    with pytest.raises(ValueError, match="group"):
        xt.XGBRanker(device="cpu").fit(X, y)


def test_params_round_trip_and_save_load(tmp_path):
    est = xt.XGBClassifier(n_estimators=3, max_depth=2, device="cpu",
                           foo_param=1)
    assert est.get_params()["max_depth"] == 2
    assert est.get_params()["foo_param"] == 1
    est.set_params(max_depth=3, other=2)
    assert est.get_xgb_params()["max_depth"] == 3
    assert est.get_xgb_params()["other"] == 2
    assert est.get_xgb_params()["device"] == "cpu"
    X, y = _data(classes=2)
    est = xt.XGBClassifier(n_estimators=3, max_depth=2, device="cpu")
    est.fit(X, y)
    path = str(tmp_path / "m.json")
    est.save_model(path)
    other = xt.XGBClassifier(device="cpu")
    other.load_model(path)
    np.testing.assert_array_equal(other.get_booster().predict(
        xt.DMatrix(X)), est.get_booster().predict(xt.DMatrix(X)))
    twin = copy.deepcopy(est)
    np.testing.assert_array_equal(twin.predict(X), est.predict(X))


def test_clone_and_grid_search():
    sklearn = pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV

    assert sklearn.__version__
    X, y = _data(classes=2, n=600)
    est = xt.XGBClassifier(n_estimators=3, device="cpu")
    c = clone(est)
    assert c.get_params()["device"] == "cpu" and c is not est
    gs = GridSearchCV(xt.XGBClassifier(n_estimators=3, device="cpu"),
                      {"max_depth": [2, 3]}, cv=2)
    gs.fit(X, y)
    assert gs.best_params_["max_depth"] in (2, 3)
    assert 0.5 < gs.best_score_ <= 1.0


def _same_fold_trees(params, X, y, rounds, stratified, folds, seed):
    """The folds of both packages' ``mknfold`` hold the same rows and
    grow the same trees round by round (no near tie)."""
    from xgboost_tpu.training import mknfold as jax_mknfold
    from xgboost_tpu_torch.training import mknfold

    jf = jax_mknfold(xgb.DMatrix(X, label=y), 3, dict(params, **JAX), seed,
                     stratified, True, folds)
    tf = mknfold(xt.DMatrix(X, label=y), 3, dict(params, **PORT), seed,
                 stratified, True, folds)
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.dtest.X, a.dtest.X)
        for i in range(rounds):
            a.update(i, None)
            b.update(i, None)
        _same_trees(a.bst, b.bst, eta=params.get("eta", 0.3))


@pytest.mark.parametrize("kind", ["plain", "stratified", "folds"])
def test_cv_matches_jax(kind):
    """The same folds (``RandomState(seed)`` shuffles, plain and
    stratified, or the caller's), the same mean / std history."""
    X, y = _data(classes=2, n=900)
    y = y.astype(np.float32)
    folds = None
    if kind == "folds":
        idx = np.random.RandomState(9).permutation(len(X))
        folds = [(idx[300:], idx[:300]), (idx[:600], idx[600:])]
    p = {"objective": "binary:logistic", "max_depth": 3,
         "min_child_weight": 5, "eval_metric": ["logloss", "auc"]}
    _same_fold_trees(p, X, y, 6, stratified=kind == "stratified",
                     folds=folds, seed=3)
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        out.append(pkg.cv(dict(p, **extra), pkg.DMatrix(X, label=y), 6,
                          nfold=3, stratified=kind == "stratified",
                          folds=folds, seed=3, as_pandas=False))
    j, t = out
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=EVAL_TOL)


def test_cv_early_stopping_and_frame():
    pd = pytest.importorskip("pandas")
    X, y = _data(classes=2, n=900)
    y = y.astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 3, "eta": 1.0,
         "min_child_weight": 5}
    _same_fold_trees(p, X, y, 4, stratified=False, folds=None, seed=1)
    out = []
    for pkg, extra in ((xgb, JAX), (xt, PORT)):
        out.append(pkg.cv(dict(p, **extra), pkg.DMatrix(X, label=y), 40,
                          nfold=3, early_stopping_rounds=2, seed=1))
    j, t = out
    assert isinstance(t, pd.DataFrame)
    assert len(t) == len(j) < 40
    np.testing.assert_allclose(t.values, j.values, rtol=0, atol=EVAL_TOL)


@pytest.mark.parametrize("cls,params,labels", [
    ("XGBClassifier", {"max_depth": 3}, "3"),
    ("XGBClassifier", {"max_depth": 2, "eval_metric": "auc"}, "2"),
    ("XGBRegressor", {"booster": "gblinear", "reg_alpha": 0.01}, "r"),
    ("XGBRFRegressor", {"max_depth": 3}, "r"),
])
def test_wrapper_model_is_trains_model(cls, params, labels):
    """A wrapper's model is ``xt.train``'s from the parameters it maps
    (``get_xgb_params``, the classifier's ``num_class`` and encoded
    labels, ``eval_metric``), byte for byte."""
    X, y = _data(classes=3 if labels == "3" else 2)
    if labels == "r":
        y = np.nan_to_num(X[:, 0]) + 0.5 * y
    est = getattr(xt, cls)(n_estimators=4, device="cpu", **params)
    est.fit(X, y, verbose=False)
    mapped = est.get_xgb_params()
    if labels == "3":
        mapped["num_class"] = 3
    if est.eval_metric is not None:
        mapped["eval_metric"] = est.eval_metric
    target = (np.searchsorted(est.classes_, y).astype(np.float32)
              if cls == "XGBClassifier" else y)
    bst = xt.train(mapped, xt.DMatrix(X, label=target),
                   est.get_num_boosting_rounds(), verbose_eval=False)
    assert bytes(bst.save_raw("ubj")) == \
        bytes(est.get_booster().save_raw("ubj"))
