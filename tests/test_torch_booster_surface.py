"""The rest of the port's Booster surface against the JAX package, on
the CPU, and the agaricus walkthrough as a whole.

- ``copy`` / ``deepcopy``, ``save_config`` / ``load_config``, ``eval``,
  ``inplace_predict``;
- the elementwise metrics (``error``, ``error@t``, ``rmsle``, ``mae``,
  ``mape``, ``mphe``, ``poisson-nloglik``, ``gamma-nloglik``,
  ``gamma-deviance``, ``tweedie-nloglik``) at rtol 1e-12 (both float64);
- the agaricus demos (``demo/guide-python``'s basic walkthrough,
  boost from prediction, predict first ntree, leaf indices) on
  agaricus-shaped libsvm files: ``binary:logistic`` with ``error`` and
  ``reg:squarederror`` with ``rmse``, trees under ``tests/
  test_torch_train.py compare_tree`` and eval histories to the 6 digits
  the eval line prints; the same predictions from the file, its binary
  copy, scipy CSR / CSC and numpy; one more round from the predicted
  margin equal to a 3-round model's eval line; ``iteration_range`` and
  ``pred_leaf`` against the JAX package;
- the port's modules and ``chip_smoke.py`` import neither JAX nor the
  JAX package (a grep over their lines).
"""

import copy
import json
import os
import re

import numpy as np
import pytest
import scipy.sparse

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import compare_tree
from xgboost_tpu.metric import get_metric as jax_metric
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_TEST = 2000, 500


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("agaricus"))
    y, idx = agaricus_rows(N_TRAIN + N_TEST, seed=3)
    paths = []
    for name, s in (("train", slice(0, N_TRAIN)),
                    ("test", slice(N_TRAIN, None))):
        p = os.path.join(tmp, f"agaricus.txt.{name}")
        write_libsvm(p, y[s], idx[s])
        paths.append(p)
    return tmp, paths


def _pair(pkg, paths):
    return [pkg.DMatrix(p + "?format=libsvm") for p in paths]


def _train(pkg, params, dtr, dte, rounds, **kw):
    res = {}
    extra = {"device": "cpu"} if pkg is xt else {"hist_method": "prehot"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        b = pkg.train(dict(params, **extra), dtr, rounds,
                      evals=[(dtr, "train"), (dte, "eval")],
                      evals_result=res, verbose_eval=False, **kw)
    return b, res


@pytest.mark.parametrize("objective,metric", [
    ("binary:logistic", "error"), ("reg:squarederror", "rmse")])
def test_agaricus_walkthrough_matches_jax(files, objective, metric):
    tmp, paths = files
    p = {"objective": objective, "max_depth": 2, "eta": 1.0,
         "eval_metric": metric}
    jtr, jte = _pair(xgb, paths)
    ttr, tte = _pair(xt, paths)
    jb, jres = _train(xgb, p, jtr, jte, 2)
    tb, tres = _train(xt, p, ttr, tte, 2)
    assert tres == jres
    for r, (a, b) in enumerate(zip(jb.gbm.trees, tb.gbm.trees)):
        assert not compare_tree(a, b, eta=1.0, r=r)[0]
    preds = tb.predict(tte)
    np.testing.assert_allclose(preds, jb.predict(jte), rtol=1e-5, atol=1e-6)
    # save / load, the binary copy of the test file, scipy and numpy
    tb.save_model(os.path.join(tmp, "m.json"))
    again = xt.Booster({"device": "cpu"},
                       model_file=os.path.join(tmp, "m.json"))
    np.testing.assert_array_equal(again.predict(tte), preds)
    tte.save_binary(os.path.join(tmp, "dtest.buffer"))
    np.testing.assert_array_equal(
        tb.predict(xt.DMatrix(os.path.join(tmp, "dtest.buffer"))), preds)
    X = tte.X
    csr = scipy.sparse.csr_matrix(np.nan_to_num(X))
    csr.eliminate_zeros()
    for data in (csr, csr.tocsc(), X):
        np.testing.assert_array_equal(tb.predict(xt.DMatrix(data)), preds)
    # boost from prediction: one round from the 2-round margins evaluates
    # as the third round of a 3-round model
    j3, jres3 = _train(xgb, p, jtr, jte, 3)
    t3, tres3 = _train(xt, p, ttr, tte, 3)
    assert tres3 == jres3
    ttr.set_base_margin(tb.predict(ttr, output_margin=True))
    tte.set_base_margin(tb.predict(tte, output_margin=True))
    _, tres1 = _train(xt, p, ttr, tte, 1)
    for data in ("train", "eval"):
        np.testing.assert_allclose(tres1[data][metric][0],
                                   tres3[data][metric][2], rtol=0,
                                   atol=2e-6)
    # predict first ntree, and leaf indices
    dplain = xt.DMatrix(X)
    np.testing.assert_allclose(
        t3.predict(dplain, iteration_range=(0, 1)),
        j3.predict(xgb.DMatrix(X), iteration_range=(0, 1)), rtol=1e-5,
        atol=1e-6)
    leaf = t3.predict(dplain, pred_leaf=True)
    assert leaf.shape == (N_TEST, 3)
    np.testing.assert_array_equal(leaf,
                                  j3.predict(xgb.DMatrix(X), pred_leaf=True))


def test_copy_config_eval_and_inplace_predict(files):
    _, paths = files
    ttr, tte = _pair(xt, paths)
    jtr, jte = _pair(xgb, paths)
    p = {"objective": "binary:logistic", "max_depth": 2, "eta": 1.0,
         "eval_metric": ["error", "logloss"]}
    tb, _ = _train(xt, p, ttr, tte, 2)
    raw = tb.save_raw("json")
    jb = xgb.Booster(model_file=raw)
    jb.set_param({"eval_metric": ["error", "logloss"]})
    tl = xt.Booster({"device": "cpu"}, model_file=raw)
    tl.set_param({"eval_metric": ["error", "logloss"]})
    assert tl.eval(tte) == jb.eval(jte)
    assert tl.eval(tte, "test", 3) == tl.eval_set([(tte, "test")], 3)
    for c in (tb.copy(), copy.copy(tb), copy.deepcopy(tb)):
        assert c is not tb and c.gbm.trees is not tb.gbm.trees
        assert c.save_raw("json") == raw
        np.testing.assert_array_equal(c.predict(tte), tb.predict(tte))
    cfg = tb.save_config()
    fresh = xt.Booster({"device": "cpu"})
    fresh.load_config(cfg)
    got, want = json.loads(fresh.save_config()), json.loads(cfg)
    assert got["learner"]["gradient_booster"] == \
        want["learner"]["gradient_booster"]
    lp = got["learner"]["learner_train_param"]
    assert {k: lp[k] for k in want["learner"]["learner_train_param"]} == \
        want["learner"]["learner_train_param"]
    assert json_tree_param(cfg) == json_tree_param(jb.save_config())
    X = tte.X
    np.testing.assert_array_equal(tb.inplace_predict(X), tb.predict(tte))
    np.testing.assert_array_equal(
        tb.inplace_predict(np.nan_to_num(X, nan=-1.0), missing=-1.0,
                           predict_type="margin"),
        tb.predict(tte, output_margin=True))
    np.testing.assert_allclose(tl.inplace_predict(X), jb.inplace_predict(X),
                               rtol=1e-6)


def json_tree_param(cfg):
    return json.loads(cfg)["learner"]["gradient_booster"]["tree_train_param"]


METRICS = ["error", "error@0.7", "rmsle", "mae", "mape", "mphe",
           "poisson-nloglik", "gamma-nloglik", "gamma-deviance",
           "tweedie-nloglik", "tweedie-nloglik@1.2", "rmse", "logloss"]


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("weighted", [False, True])
def test_elementwise_metrics_match_jax(name, weighted):
    rng = np.random.RandomState(11)
    n = 500
    y = rng.gamma(2.0, 1.0, n).astype(np.float32)
    if name.startswith(("error", "logloss")):
        y = (rng.rand(n) > 0.5).astype(np.float32)
    p = rng.uniform(0.01, 3.0, n).astype(np.float32)
    if name.startswith(("error", "logloss")):
        p = rng.rand(n).astype(np.float32)
    w = rng.rand(n).astype(np.float32) + 0.1 if weighted else None

    class Info:
        labels, weights = y, w

    dm = xt.DMatrix(np.zeros((n, 1), np.float32), label=y, weight=w)
    want = jax_metric(name)(p, Info())
    got = get_metric(name)(p, dm.info)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert get_metric(name).full_name == jax_metric(name).full_name


def test_unported_metrics_name_their_item():
    for name in ("aft-nloglik", "cox-nloglik",
                 "interval-regression-accuracy", "quantile"):
        with pytest.raises(NotImplementedError, match=r"A\.5\.11"):
            get_metric(name)


IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|xgboost_tpu)\b(?!_)")


def test_no_port_file_imports_jax():
    """A grep over every line of the port and ``chip_smoke.py``: no
    ``import jax`` / ``from xgboost_tpu ...`` (``xgboost_tpu_torch`` is
    the port's own name)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "xgboost_tpu_torch")):
        paths += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert any(p.endswith(os.path.join("data", "fileio.py")) for p in paths)
    bad = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if IMPORT.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line}")
    assert not bad, bad
