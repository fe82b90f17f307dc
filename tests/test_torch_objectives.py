"""The six elementwise objectives of the port (``objective/regression.py``:
``count:poisson``, ``reg:gamma``, ``reg:tweedie``,
``reg:pseudohubererror``, ``reg:squaredlogerror``, ``binary:hinge``)
against the JAX package on the CPU, on labels drawn as each objective's
users have them (counts, positive amounts, many zeros with a positive
tail, heavy-tailed noise, 0/1).

Tolerances: gradients and hessians at rtol 2e-6 of themselves plus
1e-6 of their column's scale (``exp`` and ``log`` are other
approximations in XLA and torch, an ulp or two apart); the transforms
at rtol 1e-6; the intercepts (one Newton step from margin 0, whose
sums add in another order) at rtol 1e-5; trees under
``tests/test_torch_train.py compare_forests`` (leaves at rtol 1e-5 plus
``LEAF_ATOL``, gains under the near-tie certificate) with the number of
trees equal in full asserted as measured on the CPU, and predictions at
rtol 1e-5 plus ``LEAF_ATOL``. The models start from ``base_score`` 0.5,
as ``test_torch_train.py``'s do, so that both packages grow their first
tree from the same margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.serve import Server

from test_torch_train import LEAF_ATOL, compare_forests

CPU = {"device": "cpu"}
OBJECTIVES = ("count:poisson", "reg:gamma", "reg:tweedie",
              "reg:pseudohubererror", "reg:squaredlogerror", "binary:hinge")
ROUNDS = 3


def objective_data(objective, n=2000, F=5, seed=0):
    """(X [n, F] f32, labels [n] f32) as ``objective``'s users have them:
    claim counts, positive amounts, pure premiums (mostly 0), a linear
    signal under Student-t noise, positive sizes, 0/1 classes."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    mu = np.exp(0.5 * X[:, 0] - 0.3 * X[:, 1])
    y = {
        "count:poisson": lambda: rng.poisson(mu),
        "reg:gamma": lambda: rng.gamma(2.0, mu / 2.0),
        "reg:tweedie": lambda: rng.poisson(0.3 * mu) * rng.gamma(2.0, 1.0,
                                                                 n),
        "reg:pseudohubererror": lambda: X[:, 0] + 0.5 * X[:, 1]
        + rng.standard_t(2, n),
        "reg:squaredlogerror": lambda: mu * rng.gamma(4.0, 0.25, n),
        "binary:hinge": lambda: X[:, 0] + 0.5 * rng.normal(size=n) > 0,
    }[objective]()
    return X, np.asarray(y, np.float32)


def _params(objective, **extra):
    return dict({"objective": objective, "max_depth": 3, "eta": 0.3,
                 "base_score": 0.5}, **extra)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_match_jax(objective):
    _, y = objective_data(objective)
    rng = np.random.RandomState(1)
    # inside squared-log's domain (margin > -1) for every objective
    margin = rng.uniform(-0.5, 1.5, (len(y), 1)).astype(np.float32)
    w = (0.5 + rng.rand(len(y))).astype(np.float32)

    class Info:
        labels, weights = y, w

    want = np.asarray(jax_objective(objective).get_gradient(
        jnp.asarray(margin), Info()))
    got = get_objective(objective).get_gradient(
        torch.from_numpy(margin), torch.from_numpy(y),
        torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (len(y), 1, 2)
    for c in range(2):
        scale = np.abs(want[..., c]).max()
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=2e-6,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_transforms_intercept_and_metric_match_jax(objective):
    _, y = objective_data(objective)
    jobj, tobj = jax_objective(objective), get_objective(objective)
    m = np.linspace(-3, 3, 61, dtype=np.float32)[:, None]
    np.testing.assert_allclose(
        tobj.pred_transform(torch.from_numpy(m)).numpy(),
        np.asarray(jobj.pred_transform(jnp.asarray(m))), rtol=1e-6)
    prob = np.asarray([0.5, 2.0, 1e-20], np.float64)
    np.testing.assert_allclose(tobj.prob_to_margin(prob),
                               np.asarray(jobj.prob_to_margin(prob)),
                               rtol=1e-6)

    class Info:
        labels, weights = y, None

    want = np.asarray(jobj.init_estimation(Info()))
    got = tobj.init_estimation(torch.from_numpy(y))
    assert got.dtype == np.float32 and got.shape == want.shape == (1,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tobj.default_metric == jobj.default_metric
    assert get_metric(tobj.default_metric).full_name == \
        tobj.default_metric


def test_tweedie_metric_follows_the_power():
    obj = get_objective("reg:tweedie", {"tweedie_variance_power": 1.2})
    assert obj.default_metric == "tweedie-nloglik@1.2" == \
        jax_objective("reg:tweedie", {"tweedie_variance_power": 1.2}) \
        .default_metric


# trees equal in full (of ROUNDS), as measured on the CPU
FULL = {"count:poisson": 3, "reg:gamma": 3, "reg:tweedie": 3,
        "reg:pseudohubererror": 3, "reg:squaredlogerror": 3,
        "binary:hinge": 3}


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_models_match_jax(objective):
    X, y = objective_data(objective)
    p = _params(objective)
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=y),
                   ROUNDS, verbose_eval=False)
    res = {}
    dm = xt.DMatrix(X, label=y)
    tb = xt.train(dict(p, **CPU), dm, ROUNDS, evals=[(dm, "train")],
                  evals_result=res, verbose_eval=False)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3)
    print(f"{objective}: {full} trees equal in full, ties {ties}, "
          f"largest leaf drift {drift:.3e}")
    assert full >= FULL[objective]
    want = jb.predict(xgb.DMatrix(X), iteration_range=(0, full))
    got = tb.predict(xt.DMatrix(X), iteration_range=(0, full))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=LEAF_ATOL)
    metric = get_objective(objective, p).default_metric
    assert list(res["train"]) == [metric]


def round_by_round(jb, params, X, y, **dm_kw):
    """The JAX model's rounds grown again by the port, each from the JAX
    model's margin before it (``base_margin``), so that one round's drift
    does not carry into the next; returns the rounds whose trees agree
    under ``compare_forests``."""
    same = 0
    per = len(jb.gbm.trees) // jb.num_boosted_rounds()
    for r in range(jb.num_boosted_rounds()):
        m = jb.predict(xgb.DMatrix(X, **dm_kw), output_margin=True,
                       iteration_range=(0, r)) if r else None
        if m is None:
            tb = xt.train(dict(params, **CPU),
                          xt.DMatrix(X, label=y, **dm_kw), 1,
                          verbose_eval=False)
        else:
            tb = xt.train(dict(params, **CPU),
                          xt.DMatrix(X, label=y, base_margin=m, **dm_kw), 1,
                          verbose_eval=False)
        full, _, _ = compare_forests(jb.gbm.trees[r * per:(r + 1) * per],
                                     tb.gbm.trees, 0.3)
        same += full == per
    return same


def test_max_delta_step_and_huber_slope_routing():
    """``max_delta_step`` goes to the objective and not to the trees, as
    in the JAX package (its learner keys): Poisson reads it (0.7 when
    none is given) and the tree parameter keeps its 0; ``huber_slope``
    reaches the pseudo-Huber gradient. Models trained with both equal
    the JAX package's, round by round (:func:`round_by_round`)."""
    for objective, key, value in (("count:poisson", "max_delta_step", 0.3),
                                  ("reg:pseudohubererror", "huber_slope",
                                   2.5)):
        X, y = objective_data(objective, n=1500, seed=4)
        p = _params(objective, **{key: value})
        tb = xt.train(dict(p, **CPU), xt.DMatrix(X, label=y), ROUNDS,
                      verbose_eval=False)
        jb = xgb.train(dict(p, hist_method="prehot"),
                       xgb.DMatrix(X, label=y), ROUNDS, verbose_eval=False)
        assert tb.tree_param.max_delta_step == jb.tree_param.max_delta_step \
            == 0.0
        assert float(tb.obj.params[key]) == value
        assert round_by_round(jb, p, X, y) == ROUNDS
        # the parameter moves the gradient
        m = torch.zeros((len(y), 1))
        base = get_objective(objective).get_gradient(m, torch.from_numpy(y))
        moved = tb.obj.get_gradient(m, torch.from_numpy(y))
        assert not torch.equal(base, moved)
    assert get_objective("count:poisson").get_gradient(
        torch.zeros((1, 1)), torch.zeros(1))[0, 0, 1] == \
        torch.exp(torch.tensor(0.7))


@pytest.mark.parametrize("objective", ["count:poisson", "reg:gamma",
                                       "reg:tweedie", "binary:hinge"])
def test_transform_through_server_inplace_and_margin(objective):
    """``exp`` (and hinge's 0/1) through ``Booster.predict``,
    ``inplace_predict``, a ``Server`` and ``output_margin=True``."""
    X, y = objective_data(objective, n=800, seed=5)
    b = xt.train(dict(_params(objective), **CPU), xt.DMatrix(X, label=y),
                 ROUNDS, verbose_eval=False)
    dm = xt.DMatrix(X)
    margin = b.predict(dm, output_margin=True)
    pred = b.predict(dm)
    want = (margin > 0).astype(np.float32) if objective == "binary:hinge" \
        else np.exp(margin)
    np.testing.assert_allclose(pred, want, rtol=1e-6)
    if objective == "binary:hinge":
        assert set(np.unique(pred)) <= {0.0, 1.0}
    np.testing.assert_array_equal(b.inplace_predict(X), pred)
    np.testing.assert_array_equal(
        b.inplace_predict(X, predict_type="margin"), margin)
    with Server(models={"m": bytes(b.save_raw("json"))}, device="cpu") \
            as srv:
        np.testing.assert_array_equal(np.asarray(srv.predict(X[:100])),
                                      pred[:100])


def test_eval_walk_of_rounds_without_a_categorical_split():
    """A forest grown on a matrix with categorical features keeps its
    trees' category words (all zero) where none of the selected trees
    splits on a category; packing such trees for the held-out walk (K1)
    used to fail with a numpy broadcast error (ROADMAP C). Here the code
    is noise, so no tree splits on it."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 2)).astype(np.float32)
    X[:, 1] = rng.integers(0, 40, 500)
    y = (X[:, 0] > 0).astype(np.float32)
    kw = dict(feature_types=["q", "c"], enable_categorical=True)
    res = {}
    b = xt.train({"objective": "binary:logistic", "max_depth": 1, **CPU},
                 xt.DMatrix(X, label=y, **kw), 2,
                 evals=[(xt.DMatrix(X[:100], label=y[:100], **kw), "test")],
                 evals_result=res, verbose_eval=False)
    assert not any(t.is_cat_split.any() for t in b.gbm.trees)
    assert b.gbm.trees[0].cat_words.shape[1] > 1
    p = b.predict(xt.DMatrix(X[:100], **kw))
    info = xt.DMatrix(X[:100], label=y[:100]).info
    assert res["test"]["logloss"][-1] == float(
        f"{get_metric('logloss')(p, info):.6f}")
