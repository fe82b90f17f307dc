"""Custom objectives and metrics in the port (``train(obj=,
custom_metric=, feval=)``, ``Booster.update(fobj=)``, ``Booster.boost``)
against the JAX package, on agaricus-shaped libsvm files, on the CPU.

The demo's logistic objective (``demo/guide-python/custom_objective.py``)
grows the JAX package's trees under ``tests/test_torch_train.py
compare_tree`` and the port's own ``binary:logistic`` trees; its eval
history (the booster's metric and the custom one, printed to 6 digits)
is the JAX package's. With ``subsample`` 0.5 the rows drawn are the JAX
package's (the round's key is ``fold_in(make_key(it), it)`` in both).
"""

import os

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import compare_tree
from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

PARAMS = {"objective": "binary:logistic", "max_depth": 2, "eta": 1.0}


def logregobj(preds, dtrain):
    labels = dtrain.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - labels, p * (1.0 - p)


def evalerror(preds, dtrain):
    # preds are margins: a margin above 0 predicts class 1
    return "my-error", float(np.mean((preds > 0.0) != dtrain.get_label()))


@pytest.fixture(scope="module")
def agaricus(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("agaricus"))
    y, idx = agaricus_rows(2500, seed=0)
    write_libsvm(os.path.join(tmp, "agaricus.txt.train"), y[:2000],
                 idx[:2000])
    write_libsvm(os.path.join(tmp, "agaricus.txt.test"), y[2000:],
                 idx[2000:])
    return {pkg.__name__: [pkg.DMatrix(os.path.join(tmp, f"agaricus.txt.{s}"
                                                    "?format=libsvm"))
                           for s in ("train", "test")] for pkg in (xgb, xt)}


def _train(pkg, agaricus, params, rounds=2, **kw):
    dtr, dte = agaricus[pkg.__name__]
    res = {}
    extra = {"device": "cpu"} if pkg is xt else {"hist_method": "prehot"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        b = pkg.train(dict(params, **extra), dtr, rounds,
                      evals=[(dtr, "train"), (dte, "eval")],
                      evals_result=res, verbose_eval=False, **kw)
    return b, res


@pytest.mark.parametrize("extra", [{}, {"subsample": 0.5}])
def test_custom_objective_matches_jax(agaricus, extra):
    p = dict(PARAMS, **extra)
    jb, jres = _train(xgb, agaricus, p, obj=logregobj,
                      custom_metric=evalerror)
    tb, tres = _train(xt, agaricus, p, obj=logregobj,
                      custom_metric=evalerror)
    assert tres == jres
    assert list(tres["eval"]) == ["logloss", "my-error"]
    for r, (a, b) in enumerate(zip(jb.gbm.trees, tb.gbm.trees)):
        assert not compare_tree(a, b, eta=1.0, r=r)[0]
    if not extra:
        # the demo's objective grows the built-in objective's trees
        built_in, _ = _train(xt, agaricus, p)
        for r, (a, b) in enumerate(zip(built_in.gbm.trees, tb.gbm.trees)):
            assert not compare_tree(a, b, eta=1.0, r=r)[0]


def test_custom_metric_wins_over_feval_and_gets_margins(agaricus):
    seen = []

    def feval(preds, dm):
        return [("fe", 0.0)]

    def metric(preds, dm):
        seen.append(preds.copy())
        return [("cm-a", 1.0), ("cm-b", 2.0)]

    b, res = _train(xt, agaricus, PARAMS, rounds=1, feval=feval,
                    custom_metric=metric)
    assert list(res["eval"]) == ["logloss", "cm-a", "cm-b"]
    dte = agaricus["xgboost_tpu_torch"][1]
    np.testing.assert_array_equal(
        seen[-1], b.predict(dte, output_margin=True))
    _, res_f = _train(xt, agaricus, PARAMS, rounds=1, feval=feval)
    assert list(res_f["eval"]) == ["logloss", "fe"]


@pytest.mark.parametrize("shape", ["flat", "column"])
def test_boost_equals_update_with_the_same_gradients(agaricus, shape):
    """``Booster.boost`` with the gradients a custom objective returns
    grows the trees ``update(fobj=)`` grows, bit for bit; [n] and [n, 1]
    gradients alike."""
    dtr, _ = agaricus["xgboost_tpu_torch"]

    def fobj(preds, dm):
        g, h = logregobj(preds, dm)
        return (g, h) if shape == "flat" else (g[:, None], h[:, None])

    p = dict(PARAMS, device="cpu", subsample=0.7)
    a = xt.Booster(p)
    b = xt.Booster(p)
    for it in range(2):
        a.update(dtr, it, fobj=fobj)
        b._configure(dtr)
        # the margin update(fobj=) gives its objective: the cached one
        margin = b._cached_margin(dtr, is_train=True).numpy().squeeze()
        b.boost(dtr, *fobj(margin, dtr))
    assert b.num_boosted_rounds() == 2
    assert a.save_raw("json") == b.save_raw("json")
