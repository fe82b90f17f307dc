"""The survival objectives and metrics of the port
(``objective/survival.py``, ``metric/survival_metric.py``) and the label
bounds of its ``DMatrix``, against the JAX package on the CPU.

Tolerances: AFT's gradient and hessian at rtol 2e-5 + 16 U / L plus
1e-6 of their column's scale, U the f32 unit roundoff and L the row's
interval probability (``torch.erf``, ``exp`` and ``log`` against
XLA's, a few ulps apart; a censored row's likelihood ``1 - (1 - F)``
cancels, so an ulp of F is U / L of it in both packages); Cox's at rtol
1e-6 (float64 sums cast to f32; numpy's ``exp`` and torch's may differ
in the last float64 bit); the metrics at rtol 1e-12 (both are numpy
float64 over the same predictions); models under
``tests/test_torch_train.py compare_forests`` with the number of trees
equal in full asserted as measured.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.metric import get_metric as jax_metric
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu_torch.data.dmatrix import MetaInfo
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.objective.survival import sort_by_time

from test_torch_train import LEAF_ATOL, compare_forests

CPU = {"device": "cpu"}
CENSORING = ("uncensored", "right", "left", "interval")


def survival_data(n=2000, F=5, seed=0):
    """(X, times, lower, upper): log-normal times from a linear rule; a
    quarter each uncensored, right-censored (upper +inf), left-censored
    (lower 0) and interval-censored."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    t = np.exp(0.5 * X[:, 0] - 0.3 * X[:, 1]
               + 0.4 * rng.normal(size=n)).astype(np.float32)
    kind = np.arange(n) % 4
    lo, hi = t.copy(), t.copy()
    hi[kind == 1] = np.inf
    lo[kind == 2] = 0.0
    lo[kind == 3] = t[kind == 3] * 0.7
    hi[kind == 3] = t[kind == 3] * 1.6
    return X, t, lo.astype(np.float32), hi.astype(np.float32)


class _Info:
    def __init__(self, labels=None, weights=None, lo=None, hi=None):
        self.labels, self.weights = labels, weights
        self.label_lower_bound, self.label_upper_bound = lo, hi


def _interval_mass(dist, lo, hi, margin, sigma):
    """The probability [n] (float64) the distribution gives each row's
    interval (1 for an uncensored row)."""
    from scipy.stats import gumbel_l, logistic, norm

    cdf = {"normal": norm.cdf, "logistic": logistic.cdf,
           "extreme": gumbel_l.cdf}[dist]
    lo, hi, m = (np.asarray(a, np.float64) for a in (lo, hi, margin))
    with np.errstate(divide="ignore"):
        f_lo = np.where(lo > 0, cdf((np.log(lo) - m) / sigma), 0.0)
        f_hi = np.where(np.isfinite(hi), cdf((np.log(hi) - m) / sigma), 1.0)
    return np.where(lo == hi, 1.0, np.maximum(f_hi - f_lo, 1e-30))


@pytest.mark.parametrize("censoring", CENSORING)
@pytest.mark.parametrize("dist", ["normal", "logistic", "extreme"])
def test_aft_gradient(dist, censoring):
    X, t, lo, hi = survival_data()
    rows = np.arange(len(t)) % 4 == CENSORING.index(censoring)
    lo, hi = lo[rows], hi[rows]
    rng = np.random.RandomState(2)
    margin = rng.uniform(-2, 2, (len(lo), 1)).astype(np.float32)
    w = (0.5 + rng.rand(len(lo))).astype(np.float32)
    p = {"aft_loss_distribution": dist, "aft_loss_distribution_scale": 1.2}
    want = np.asarray(jax_objective("survival:aft", p).get_gradient(
        jnp.asarray(margin), _Info(t[rows], w, lo, hi)))
    got = get_objective("survival:aft", p).get_gradient(
        torch.from_numpy(margin), torch.from_numpy(t[rows]),
        torch.from_numpy(w),
        bounds=(torch.from_numpy(lo), torch.from_numpy(hi))).numpy()
    assert got.shape == want.shape == (len(lo), 1, 2)
    # a censored row's f32 likelihood 1 - (1 - F) cancels: an ulp of F
    # (where the two erf / exp approximations differ) is U / L of it
    rtol = 2e-5 + 16 * 2.0 ** -24 / _interval_mass(dist, lo, hi,
                                                    margin[:, 0], 1.2)
    for c in range(2):
        scale = np.abs(want[:, 0, c]).max()
        err = np.abs(got[:, 0, c] - want[:, 0, c])
        assert (err <= rtol * np.abs(want[:, 0, c]) + 1e-6 * scale).all(), \
            (c, float(np.max(err / np.abs(want[:, 0, c]))))


@pytest.mark.parametrize("weighted", [False, True])
def test_cox_gradient(weighted):
    X, t, _, _ = survival_data()
    rng = np.random.RandomState(3)
    y = np.where(rng.rand(len(t)) < 0.3, -t, t).astype(np.float32)
    y[:50] = y[50:100]                       # tied times
    margin = rng.randn(len(y), 1).astype(np.float32)
    w = (0.5 + rng.rand(len(y))).astype(np.float32) if weighted else None
    want = np.asarray(jax_objective("survival:cox").get_gradient(
        margin, _Info(y, w)))
    yt = torch.from_numpy(y)
    obj = get_objective("survival:cox")
    wt = None if w is None else torch.from_numpy(w)
    got = obj.get_gradient(torch.from_numpy(margin), yt, wt,
                           time_order=sort_by_time(yt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the order made inside the call when none is given: the same bits
    assert np.array_equal(obj.get_gradient(torch.from_numpy(margin), yt,
                                           wt).numpy(), got)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["aft-nloglik", "cox-nloglik",
                                  "interval-regression-accuracy",
                                  "quantile", "quantile@0.9"])
def test_metrics_match_jax(name, weighted):
    X, t, lo, hi = survival_data()
    rng = np.random.RandomState(4)
    w = (0.5 + rng.rand(len(t))).astype(np.float32) if weighted else None
    preds = np.exp(rng.randn(len(t))).astype(np.float32)
    labels = np.where(np.arange(len(t)) % 3 == 0, -t, t).astype(np.float32)
    if name.startswith("quantile"):
        labels = t
        preds = np.stack([preds * 0.5, preds, preds * 2.0], axis=1)
    jinfo = _Info(labels, w, lo, hi)
    tinfo = MetaInfo(labels=labels, weights=w, label_lower_bound=lo,
                     label_upper_bound=hi)
    want = jax_metric(name)(preds, jinfo)
    got = get_metric(name)(preds, tinfo)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert get_metric(name).full_name == jax_metric(name).full_name


def test_aft_nloglik_keeps_the_jax_semantics():
    """The JAX package's ``aft-nloglik`` scores a normal distribution with
    sigma 1 whatever the objective's parameters (upstream reads them;
    ROADMAP C): the port's eval line gives the same value under a
    logistic distribution at scale 1.2."""
    X, t, lo, hi = survival_data(n=800, seed=5)
    kw = dict(label_lower_bound=lo, label_upper_bound=hi)
    p = {"objective": "survival:aft", "aft_loss_distribution": "logistic",
         "aft_loss_distribution_scale": 1.2, "max_depth": 3,
         "base_score": 0.5}
    res_t, res_j = {}, {}
    dt, dj = xt.DMatrix(X, label=t, **kw), xgb.DMatrix(X, label=t, **kw)
    xt.train(dict(p, **CPU), dt, 2, evals=[(dt, "train")],
             evals_result=res_t, verbose_eval=False)
    xgb.train(dict(p, hist_method="prehot"), dj, 2, evals=[(dj, "train")],
              evals_result=res_j, verbose_eval=False)
    np.testing.assert_allclose(res_t["train"]["aft-nloglik"],
                               res_j["train"]["aft-nloglik"], rtol=1e-5)


class _It(xt.DataIter):
    def __init__(self, X, y, lo, hi, parts):
        super().__init__()
        self.X, self.y, self.lo, self.hi = X, y, lo, hi
        self.parts, self.i = parts, 0

    def next(self, input_data):
        if self.i == len(self.parts):
            return 0
        s = self.parts[self.i]
        input_data(data=self.X[s], label=self.y[s],
                   label_lower_bound=self.lo[s], label_upper_bound=self.hi[s])
        self.i += 1
        return 1

    def reset(self):
        self.i = 0


@pytest.mark.parametrize("way", ["constructor", "iterator",
                                 "set_float_info", "slice", "save_binary"])
def test_bounds_through_every_way_in(way, tmp_path):
    X, t, lo, hi = survival_data(n=600)
    kw = dict(label_lower_bound=lo, label_upper_bound=hi)
    rows = np.arange(600)
    if way == "constructor":
        dm = xt.DMatrix(X, label=t, **kw)
    elif way == "iterator":
        dm = xt.QuantileDMatrix(_It(X, t, lo, hi, [slice(0, 250),
                                                   slice(250, 600)]))
    elif way == "set_float_info":
        dm = xt.DMatrix(X, label=t)
        dm.set_float_info("label_lower_bound", lo)
        dm.set_float_info("label_upper_bound", hi)
    elif way == "slice":
        rows = np.arange(0, 600, 3)
        dm = xt.DMatrix(X, label=t, **kw).slice(rows)
    else:
        xt.DMatrix(X, label=t, **kw).save_binary(str(tmp_path / "m.bin"))
        dm = xt.DMatrix(str(tmp_path / "m.bin"))
        # and the JAX package reads the port's file
        jdm = xgb.DMatrix(str(tmp_path / "m.bin"))
        np.testing.assert_array_equal(jdm.info.label_upper_bound, hi)
    np.testing.assert_array_equal(dm.get_float_info("label_lower_bound"),
                                  lo[rows])
    np.testing.assert_array_equal(dm.get_float_info("label_upper_bound"),
                                  hi[rows])
    b = xt.train({"objective": "survival:aft", "max_depth": 2, **CPU}, dm,
                 2, evals=[(dm, "train")], verbose_eval=False)
    assert np.isfinite(b.predict(xt.DMatrix(X[rows]))).all()


def test_aft_needs_bounds():
    X, t, _, _ = survival_data(n=100)
    with pytest.raises(ValueError, match="label_lower_bound"):
        xt.train({"objective": "survival:aft", **CPU},
                 xt.DMatrix(X, label=t), 1, verbose_eval=False)


# (objective, params, trees equal in full as measured)
MODELS = {
    "aft_normal": ("survival:aft", {"aft_loss_distribution": "normal",
                                    "aft_loss_distribution_scale": 1.2,
                                    "lambda": 0.01, "alpha": 0.02}, 3),
    "aft_logistic": ("survival:aft", {"aft_loss_distribution": "logistic"},
                     3),
    "aft_extreme": ("survival:aft", {"aft_loss_distribution": "extreme",
                                     "aft_loss_distribution_scale": 0.8}, 3),
    "cox": ("survival:cox", {}, 3),
    "cox_weighted": ("survival:cox", {"weighted": True}, 3),
}


@pytest.mark.parametrize("case", list(MODELS))
def test_models_match_jax(case):
    objective, params, full_min = MODELS[case]
    params = dict(params)
    X, t, lo, hi = survival_data()
    w = None
    if params.pop("weighted", False):
        w = (0.5 + np.random.RandomState(6).rand(len(t))).astype(np.float32)
    if objective == "survival:cox":
        kw = {}
        y = np.where(np.arange(len(t)) % 4 == 1, -t, t).astype(np.float32)
    else:
        kw = dict(label_lower_bound=lo, label_upper_bound=hi)
        y = t
    p = dict({"objective": objective, "max_depth": 3, "eta": 0.3},
             **params)
    jb = xgb.train(dict(p, hist_method="prehot"),
                   xgb.DMatrix(X, label=y, weight=w, **kw), 3,
                   verbose_eval=False)
    res = {}
    dm = xt.DMatrix(X, label=y, weight=w, **kw)
    tb = xt.train(dict(p, **CPU), dm, 3, evals=[(dm, "train")],
                  evals_result=res, verbose_eval=False)
    np.testing.assert_allclose(tb._base_np(), np.asarray(jb._base_np()),
                               rtol=1e-6)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees,
                                        0.3, lam=p.get("lambda", 1.0))
    print(f"{case}: {full} trees equal in full, ties {ties}, largest leaf "
          f"drift {drift:.3e}")
    assert full >= full_min
    want = jb.predict(xgb.DMatrix(X), iteration_range=(0, full))
    got = tb.predict(xt.DMatrix(X), iteration_range=(0, full))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=LEAF_ATOL)
    assert list(res["train"]) == [get_objective(objective).default_metric]


def test_early_stopping_maximises_interval_accuracy():
    """``interval-regression-accuracy`` is larger-is-better: early
    stopping keeps the round where it peaked, as the JAX package's."""
    X, t, lo, hi = survival_data(n=1500, seed=8)
    p = {"objective": "survival:aft", "max_depth": 3, "eta": 0.5,
         "eval_metric": "interval-regression-accuracy", "base_score": 0.5}
    out = []
    for pkg, extra in ((xgb, {"hist_method": "prehot"}), (xt, CPU)):
        dtr = pkg.DMatrix(X[:1000], label=t[:1000],
                          label_lower_bound=lo[:1000],
                          label_upper_bound=hi[:1000])
        dte = pkg.DMatrix(X[1000:], label=t[1000:],
                          label_lower_bound=lo[1000:],
                          label_upper_bound=hi[1000:])
        res = {}
        b = pkg.train(dict(p, **extra), dtr, 40, evals=[(dte, "test")],
                      evals_result=res, early_stopping_rounds=3,
                      verbose_eval=False)
        acc = res["test"]["interval-regression-accuracy"]
        assert b.best_iteration == int(np.argmax(acc))
        assert b.best_score == max(acc)
        out.append((b.best_iteration, b.num_boosted_rounds()))
    assert out[0] == out[1]
