"""``XTPU_NAN_POLICY`` (``raise`` / ``zero`` / ``off``) in the port
(``objective/base.py guard_gradient``) against the JAX package on the same
seeded inputs: NaN and Inf labels, and a custom objective that returns
NaN.

Under ``raise`` the JAX package's fused depthwise round checks the margin
after the round, so it counts every row the poisoned tree reached; its
general path (``lossguide`` here, and every custom objective) checks the
gradient as the port does, and there both name the same rows. Under
``zero`` both train the same trees: the JSON's integer fields equal and
its floats within ``JSON_RTOL`` (the sigmoid rounds differently in the
two packages from round 1 on, as without NaN).
"""

import json

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.objective.base import \
    NumericalDivergence as JaxNumericalDivergence

JSON_RTOL = 1e-5
ROUNDS = 3
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
          "base_score": 0.5}
GENERAL = {"grow_policy": "lossguide", "max_leaves": 8}


def _data(bad="nan", share=0.02, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(400, 5).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    rows = np.flatnonzero(rng.rand(400) < share)
    y[rows] = np.nan if bad == "nan" else np.inf
    return X, y, len(rows)


def _train(pkg, X, y, extra=None, obj=None, rounds=ROUNDS):
    p = dict(PARAMS, **(extra or {}))
    p.update({"hist_method": "prehot"} if pkg is xgb else {"device": "cpu"})
    return pkg.train(p, pkg.DMatrix(X, label=y), rounds, obj=obj,
                     verbose_eval=False)


def _trees(bst):
    return json.loads(bytes(bst.save_raw("json")))["learner"][
        "gradient_booster"]["trees"]


def _same_json(a, b):
    """Integer fields equal, float fields within JSON_RTOL (NaN = NaN)."""
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert ta.keys() == tb.keys()
        for k in ta:
            va, vb = ta[k], tb[k]
            if isinstance(va, list) and va and isinstance(va[0], float):
                np.testing.assert_allclose(vb, va, rtol=JSON_RTOL,
                                           atol=JSON_RTOL)
            else:
                assert va == vb, k


def _nan_objective(bad_rows):
    def obj(margin, dtrain):
        p = 1.0 / (1.0 + np.exp(-margin))
        y = dtrain.get_label()
        g, h = p - y, p * (1.0 - p)
        g[bad_rows] = np.nan
        return g, h
    return obj


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("extra", [None, GENERAL], ids=["fused", "general"])
def test_raise_names_the_rows(monkeypatch, bad, extra):
    monkeypatch.setenv("XTPU_NAN_POLICY", "raise")
    X, y, n_bad = _data(bad)
    with pytest.raises(xt.NumericalDivergence) as te:
        _train(xt, X, y, extra)
    with pytest.raises(JaxNumericalDivergence) as je:
        _train(xgb, X, y, extra)
    # the port checks each gradient before its round's trees exist
    assert te.value.bad_rows == n_bad and te.value.iteration == 0
    assert te.value.objective == "binary:logistic"
    if extra is not None:      # the JAX package's general path: the same
        assert je.value.bad_rows == n_bad
        assert str(te.value) == str(je.value)


def test_raise_commits_no_tree(monkeypatch):
    monkeypatch.setenv("XTPU_NAN_POLICY", "raise")
    X, y, _ = _data()
    bst = xt.Booster(dict(PARAMS, device="cpu"))
    with pytest.raises(xt.NumericalDivergence):
        bst.update(xt.DMatrix(X, label=y), 0)
    assert bst.num_boosted_rounds() == 0


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("extra", [None, GENERAL], ids=["fused", "general"])
def test_zero_trains_the_jax_model(monkeypatch, caplog, bad, extra):
    monkeypatch.setenv("XTPU_NAN_POLICY", "zero")
    X, y, n_bad = _data(bad)
    tb = _train(xt, X, y, extra)
    jb = _train(xgb, X, y, extra)
    _same_json(_trees(jb), _trees(tb))
    assert all(np.isfinite(t["base_weights"]).all() for t in _trees(tb))
    assert f"non-finite gradients for {n_bad} rows" in caplog.text


@pytest.mark.parametrize("extra", [None, GENERAL], ids=["fused", "general"])
def test_off_trains_without_a_check(monkeypatch, extra):
    monkeypatch.setenv("XTPU_NAN_POLICY", "off")
    X, y, _ = _data()
    tb = _train(xt, X, y, extra)
    jb = _train(xgb, X, y, extra)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == ROUNDS
    # NaN gradients reach the sums in both packages
    assert np.isnan(_trees(tb)[0]["base_weights"][0])
    assert np.isnan(_trees(jb)[0]["base_weights"][0])


@pytest.mark.parametrize("policy", ["raise", "zero", "off"])
def test_custom_objective(monkeypatch, policy):
    monkeypatch.setenv("XTPU_NAN_POLICY", policy)
    X, y, _ = _data(share=0.0)
    bad = np.array([3, 17, 200])
    obj = _nan_objective(bad)
    if policy == "raise":
        with pytest.raises(xt.NumericalDivergence) as te:
            _train(xt, X, y, obj=obj)
        with pytest.raises(JaxNumericalDivergence) as je:
            _train(xgb, X, y, obj=obj)
        assert te.value.bad_rows == je.value.bad_rows == len(bad)
        assert te.value.objective == je.value.objective == \
            "custom objective"
        assert str(te.value) == str(je.value)
        return
    tb = _train(xt, X, y, obj=obj)
    jb = _train(xgb, X, y, obj=obj)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == ROUNDS
    if policy == "zero":
        _same_json(_trees(jb), _trees(tb))


def test_bad_policy_value(monkeypatch):
    monkeypatch.setenv("XTPU_NAN_POLICY", "sometimes")
    X, y, _ = _data(share=0.0)
    with pytest.raises(ValueError) as te:
        _train(xt, X, y)
    with pytest.raises(ValueError) as je:
        _train(xgb, X, y)
    assert str(te.value) == str(je.value) == (
        "XTPU_NAN_POLICY must be raise|zero|off, got 'sometimes'")


@pytest.mark.parametrize("pkg", [xt, xgb], ids=["port", "jax"])
def test_policy_change_between_train_calls(monkeypatch, pkg):
    X, y, _ = _data()
    exc = xt.NumericalDivergence if pkg is xt else JaxNumericalDivergence
    monkeypatch.setenv("XTPU_NAN_POLICY", "raise")
    with pytest.raises(exc):
        _train(pkg, X, y)
    monkeypatch.setenv("XTPU_NAN_POLICY", "zero")
    assert _train(pkg, X, y).num_boosted_rounds() == ROUNDS
    monkeypatch.setenv("XTPU_NAN_POLICY", "raise")
    with pytest.raises(exc):
        _train(pkg, X, y)
