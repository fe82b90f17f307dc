"""The port's linear booster (``booster="gblinear"``) against the JAX
package's, on the CPU, from the same seeded inputs.

Tolerance: torch sums the products Xᵀg and (X²)ᵀh in another order
than XLA's einsum, so weights are compared to ``W_TOL`` relative and
absolute (measured here: at most 4.8e-7 apart after 10 rounds at
lambda 1, 1.2e-6 relative where lambda is 0 and weights reach 57) and
predictions to ``PRED_TOL`` of the largest margin's magnitude (without
lambda a logistic model's margins reach ~350 and cancel in X W: 1.2e-6
of it measured; at alpha 300, weights near the soft threshold:
2.4e-6). The weights' operand, the features with missing as 0, is
compared bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.boosting.gblinear import _cut_arrays, _page_features_jit
from xgboost_tpu.interop import load_xgboost_model as jax_load_ref
from xgboost_tpu.interop import save_xgboost_model as jax_save_ref
from xgboost_tpu_torch.boosting.gblinear import (GBLinear, coord_descent,
                                                 linear_features, shotgun)

from test_data_iterator import BatchIter
from test_torch_paged import PortIter

W_TOL = 5e-6
PRED_TOL = 5e-6
ROUNDS = 10
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _data(seed=0, n=2500, F=10, classes=0, nan=0.1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < nan] = np.nan
    s = np.nan_to_num(X) @ rng.randn(F) + 0.3 * rng.randn(n)
    if classes:
        cuts = np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1])
        y = np.digitize(s, cuts)
    elif seed % 2:
        y = s > 0
    else:
        y = s
    return X, y.astype(np.float32)


OBJECTIVES = {
    "binary": ({"objective": "binary:logistic"}, 0),
    "multiclass": ({"objective": "multi:softprob", "num_class": 3}, 3),
    "squarederror": ({"objective": "reg:squarederror"}, 0),
}
LINEAR = {"booster": "gblinear", "lambda": 1.0, "alpha": 0.0001,
          "eta": 0.5}


def _both(params, X, y, rounds=ROUNDS, evals_rows=500, weight=None,
          **train_kw):
    """(JAX booster, port booster, JAX evals, port evals) on the same
    rows; the last ``evals_rows`` rows held out as ``test``."""
    n = len(X) - evals_rows
    out = []
    for pkg, extra in ((xgb, {}), (xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X[:n], label=y[:n],
                          weight=None if weight is None else weight[:n])
        dte = pkg.DMatrix(X[n:], label=y[n:])
        res = {}
        b = pkg.train(dict(params, **extra), dtr, rounds,
                      evals=[(dtr, "train"), (dte, "test")], evals_result=res,
                      verbose_eval=False, **train_kw)
        out.append((b, res))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _weights(b):
    W = b.gbm.W
    bias = b.gbm.bias
    if isinstance(W, torch.Tensor):
        return W.numpy(), bias.numpy()
    return np.asarray(W), np.asarray(bias)


def _assert_same_model(jb, tb, X):
    jW, jbias = _weights(jb)
    tW, tbias = _weights(tb)
    np.testing.assert_allclose(tW, jW, rtol=W_TOL, atol=W_TOL)
    np.testing.assert_allclose(tbias, jbias, rtol=W_TOL, atol=W_TOL)
    want = jb.predict(xgb.DMatrix(X), output_margin=True)
    got = tb.predict(xt.DMatrix(X), output_margin=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL * max(
        1.0, float(np.abs(want).max())))


def _assert_same_evals(jres, tres):
    """The eval history to the eval line's six digits. The JAX package
    scores a held-out matrix's logloss as NaN at some rounds while its
    margins are finite (ROADMAP C); those entries are left out, and the
    port's are checked finite."""
    assert jres.keys() == tres.keys()
    for data, metrics in jres.items():
        for name, vals in metrics.items():
            j = np.asarray(vals)
            t = np.asarray(tres[data][name])
            assert np.isfinite(t).all()
            keep = ~np.isnan(j)
            np.testing.assert_allclose(t[keep], j[keep], rtol=0, atol=2e-6)


@pytest.mark.parametrize("updater", ["shotgun", "coord_descent"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_updaters_match_jax(updater, objective):
    """Both updaters, binary / 3-class / squared error, 10% missing: the
    weights, bias and margins within W_TOL / PRED_TOL of the JAX
    package's after 10 rounds, and the eval history."""
    extra, classes = OBJECTIVES[objective]
    X, y = _data(seed=1 if objective == "binary" else 2, classes=classes)
    jb, tb, jres, tres = _both(dict(LINEAR, updater=updater, **extra), X, y)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == ROUNDS
    _assert_same_model(jb, tb, X)
    _assert_same_evals(jres, tres)


def test_weighted_rows_match_jax():
    X, y = _data(seed=3)
    w = np.random.RandomState(4).uniform(0.2, 3.0, len(X)).astype(
        np.float32)
    jb, tb, jres, tres = _both(dict(LINEAR, objective="binary:logistic"),
                               X, y, weight=w)
    _assert_same_model(jb, tb, X)
    _assert_same_evals(jres, tres)


def test_l1_gives_the_same_zero_weights():
    """A large alpha zeroes most weights: the same ones in both
    packages."""
    X, y = _data(seed=5, F=20)
    jb, tb, _, _ = _both(dict(LINEAR, objective="binary:logistic",
                              alpha=300.0), X, y)
    jW, _ = _weights(jb)
    tW, _ = _weights(tb)
    assert (jW == 0).sum() >= 5
    np.testing.assert_array_equal(tW == 0, jW == 0)
    _assert_same_model(jb, tb, X)
    assert tb.get_score() == pytest.approx(jb.get_score(), abs=W_TOL)
    assert len(tb.get_score()) == (tW != 0).any(axis=1).sum()


@pytest.mark.parametrize("params,lam,alpha", [
    ({}, 0.0, 0.0),
    ({"lambda": 2.0}, 2.0, 0.0),
    ({"reg_lambda": 2.0, "reg_alpha": 0.5}, 2.0, 0.5),
    ({"alpha": 0.25, "learning_rate": 0.2}, 0.0, 0.25),
])
def test_lambda_and_alpha_are_zero_unless_set(params, lam, alpha):
    """The JAX package's rule: gblinear's lambda and alpha are 0 unless
    a caller set them; eta is the tree parameters'."""
    X, y = _data(seed=6, n=800)
    p = dict({"booster": "gblinear", "objective": "binary:logistic"},
             **params)
    jb, tb, _, _ = _both(p, X, y, rounds=3, evals_rows=100)
    for b in (jb, tb):
        assert (b.gbm.reg_lambda, b.gbm.reg_alpha) == (lam, alpha)
        assert b.gbm.eta == params.get("learning_rate", 0.3)
    _assert_same_model(jb, tb, X)


def test_iterator_built_matrix_trains_on_its_bin_values():
    """A resident matrix built from an iterator keeps no raw values: the
    linear operand is each bin's representative value with missing as
    0, bit for bit the JAX package's ``_page_features``; the models
    then agree within W_TOL."""
    X, y = _data(seed=7, n=3000)
    jd = xgb.QuantileDMatrix(BatchIter(X, y, 3), max_bin=64)
    td = xt.QuantileDMatrix(PortIter(X, y, 3), max_bin=64)
    jbin = jd.binned(64)
    want = np.asarray(_page_features_jit(jbin.bins, *_cut_arrays(jbin)))
    got = linear_features(td, torch.device("cpu")).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(got, np.nan_to_num(X))
    p = dict(LINEAR, objective="binary:logistic", max_bin=64)
    jb = xgb.train(p, jd, 5, verbose_eval=False)
    tb = xt.train(dict(p, device="cpu"), td, 5, verbose_eval=False)
    _assert_same_model(jb, tb, X)


def test_eval_sets_and_continuation_match_jax():
    """Eval sets recompute their margins each round (no margin cache);
    a model continued from its saved bytes (``xgb_model=``) goes on
    from the saved weights in both packages."""
    X, y = _data(seed=9)
    p = dict(LINEAR, objective="binary:logistic", updater="coord_descent")
    first = _both(p, X, y, rounds=4)
    jraw = first[0].save_raw("json")
    traw = first[1].save_raw("json")
    n = len(X) - 500
    out = []
    for pkg, raw, extra in ((xgb, jraw, {}), (xt, traw, {"device": "cpu"})):
        dtr = pkg.DMatrix(X[:n], label=y[:n])
        dte = pkg.DMatrix(X[n:], label=y[n:])
        res = {}
        b = pkg.train(dict(p, **extra), dtr, 3, evals=[(dte, "test")],
                      evals_result=res, verbose_eval=False, xgb_model=raw)
        out.append((b, res))
    (jc, jres), (tc, tres) = out
    assert jc.num_boosted_rounds() == tc.num_boosted_rounds() == 7
    _assert_same_model(jc, tc, X)
    _assert_same_evals(jres, tres)
    straight = xt.train(dict(p, device="cpu"),
                        xt.DMatrix(X[:n], label=y[:n]), 7,
                        verbose_eval=False)
    np.testing.assert_allclose(_weights(tc)[0], _weights(straight)[0],
                               rtol=W_TOL, atol=W_TOL)


def test_linear_contribs_and_interactions():
    """pred_contribs of a linear model: x_f W[f, k] and the bias plus
    the base score, the same bits as the JAX package's; rows sum to the
    margin; pred_interactions raises ValueError in both packages."""
    X, y = _data(seed=10, classes=3)
    jb, tb, _, _ = _both(dict(LINEAR, objective="multi:softprob",
                              num_class=3), X, y, rounds=3)
    jc = jb.predict(xgb.DMatrix(X), pred_contribs=True)
    tc = tb.predict(xt.DMatrix(X), pred_contribs=True)
    assert tc.shape == jc.shape == (len(X), 3, X.shape[1] + 1)
    tb2 = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    assert np.array_equal(tb2.predict(xt.DMatrix(X), pred_contribs=True),
                          jc)
    np.testing.assert_allclose(tc.sum(-1), tb.predict(
        xt.DMatrix(X), output_margin=True), rtol=PRED_TOL, atol=PRED_TOL)
    for b, pkg in ((jb, xgb), (tb, xt)):
        with pytest.raises(ValueError, match="gblinear"):
            b.predict(pkg.DMatrix(X), pred_interactions=True)
        assert b.predict(pkg.DMatrix(X), pred_leaf=True).shape == (len(X), 0)


def test_get_score_and_slicing():
    X, y = _data(seed=11)
    jb, tb, _, _ = _both(dict(LINEAR, objective="reg:squarederror"), X, y,
                         rounds=3)
    assert tb.get_score().keys() == jb.get_score().keys()
    for k, v in jb.get_score().items():
        assert tb.get_score()[k] == pytest.approx(v, abs=W_TOL)
    for b in (jb, tb):
        with pytest.raises(NotImplementedError, match="slic"):
            b[0:1]


@pytest.mark.parametrize("fmt", ["json", "ubj", "reference"])
def test_model_files_load_in_both_packages(fmt, tmp_path):
    """A gblinear model written by either package (native JSON or UBJSON,
    or the reference schema) loads into the other and predicts the same
    margins; the native payload's bytes round-trip."""
    X, y = _data(seed=12, classes=3)
    jb, tb, _, _ = _both(dict(LINEAR, objective="multi:softmax",
                              num_class=3), X, y, rounds=3)
    dx, dj = xt.DMatrix(X), xgb.DMatrix(X)
    for src, other in ((jb, "port"), (tb, "jax")):
        path = str(tmp_path / f"{other}.{fmt}")
        if fmt == "reference":
            (jax_save_ref if src is jb else xt.save_xgboost_model)(src, path)
            loaded = (xt.load_xgboost_model(path, device="cpu")
                      if other == "port" else jax_load_ref(path))
        else:
            raw = bytes(src.save_raw(fmt))
            loaded = (xt.Booster({"device": "cpu"}, model_file=raw)
                      if other == "port" else xgb.Booster(model_file=raw))
            if other == "port":
                assert bytes(loaded.save_raw(fmt)) == raw
        want = src.predict(dx if src is tb else dj, output_margin=True)
        got = loaded.predict(dx if other == "port" else dj,
                             output_margin=True)
        np.testing.assert_allclose(got, want, rtol=PRED_TOL, atol=PRED_TOL)
        assert loaded.num_features() == X.shape[1]


def test_reference_fixture_loads_in_both_packages():
    """The hand-written reference-schema gblinear file (weights flat,
    bias last) predicts the same in both packages."""
    path = os.path.join(FIXTURES, "gblinear_squarederror.json")
    X = np.asarray([[1.0, 2.0], [np.nan, -1.0], [0.5, 0.0]], np.float32)
    tb = xt.Booster({"device": "cpu"}, model_file=path)
    jb = xgb.Booster(model_file=path)
    got = tb.predict(xt.DMatrix(X))
    np.testing.assert_array_equal(got, jb.predict(xgb.DMatrix(X)))
    want = 0.5 + 0.05 + np.nan_to_num(X) @ np.asarray([0.3, -0.7])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with open(path) as fh:
        assert json.load(fh)["learner"]["gradient_booster"]["name"] == \
            "gblinear"


def test_round_functions_against_jax_rounds():
    """One round of each updater from the same gradient, weights and
    bias: the port's functions against the JAX package's jitted ones."""
    from xgboost_tpu.boosting.gblinear import _coord_round, _shotgun_round

    rng = np.random.RandomState(13)
    X = rng.randn(700, 9).astype(np.float32)
    gpair = np.stack([rng.randn(700, 2), rng.rand(700, 2) + 0.1],
                     -1).astype(np.float32)
    W = (0.1 * rng.randn(9, 2)).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    kw = dict(eta=0.5, lam=1.0, alpha=0.01)
    for jfn, tfn in ((_shotgun_round, shotgun),
                     (_coord_round, coord_descent)):
        want = [np.asarray(v) for v in jfn(X, gpair, W, b, **kw)]
        got = [v.numpy() for v in tfn(*map(torch.from_numpy,
                                           (X, gpair, W, b)), **kw)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=W_TOL, atol=W_TOL)


def test_empty_model_predicts_the_base():
    gbm = GBLinear(2)
    X = torch.zeros((3, 4))
    base = torch.tensor([0.5, -0.5])
    assert torch.equal(gbm.predict_margin(X, base),
                       base[None, :].expand(3, 2))
    assert gbm.to_json()["weights"] == []
