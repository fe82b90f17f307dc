"""Multiclass training and prediction in the port against the JAX package,
on the CPU: ``multi:softprob`` / ``multi:softmax`` (3 to 5 classes, a few
thousand rows, depth 6 or less).

- the gradient ``p - onehot``, ``h = max(2p(1-p), 1e-16)`` at rtol 1e-6
  (the two packages' ``exp`` differ by an ulp, ROADMAP C);
- trained trees node by node under the near-tie certificate, as the
  main path (``tests/test_torch_sampling.py check_against_jax``), with
  and without sampling and with ``num_parallel_tree`` 2;
- ``merror`` / ``mlogloss`` (weighted), softprob / softmax predictions,
  ``output_margin`` and ``strict_shape``;
- model bytes both ways: a port model loads into the JAX package and
  predicts the same, a JAX model loads into the port, predicts the same
  and saves the bytes it was read from;
- a 7-group forest served by ``Server`` answers what ``Booster.predict``
  answers, bit for bit, and K1's plan takes 7 groups at every server
  bucket.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_sampling import check_against_jax
from xgboost_tpu.metric import get_metric as jax_metric
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.objective import get_objective


def _data(n=3000, F=10, K=4, seed=0, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = np.argmax(X @ rng.randn(F, K) + 0.7 * rng.randn(n, K),
                  axis=1).astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return X, y


class _Info:
    def __init__(self, labels, weights=None):
        self.labels, self.weights = labels, weights


@pytest.mark.parametrize("name", ["multi:softprob", "multi:softmax"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_matches_jax(name, weighted):
    rng = np.random.RandomState(3)
    n, K = 2000, 5
    margin = (rng.randn(n, K) * 3).astype(np.float32)
    margin[:5] = [[0, 0, 0, 0, 0], [80, -80, 0, 1, 2], [-30] * 5,
                  [1e-8, 0, 0, 0, 0], [5, 5, 5, 5, 4]]
    y = rng.randint(0, K, n).astype(np.float32)
    w = rng.rand(n).astype(np.float32) if weighted else None
    jobj = jax_objective(name, {"num_class": K})
    want = np.asarray(jobj.get_gradient(jnp.asarray(margin), _Info(y, w)))
    tobj = get_objective(name, {"num_class": K})
    got = tobj.get_gradient(torch.from_numpy(margin), torch.from_numpy(y),
                            None if w is None else torch.from_numpy(w)
                            ).numpy()
    assert got.shape == want.shape == (n, K, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[..., 1] >= 1e-16 * (w[:, None] if weighted else 1)).all()
    assert tobj.n_targets() == K
    np.testing.assert_array_equal(tobj.init_estimation(None),
                                  np.zeros(K, np.float32))


@pytest.mark.parametrize("metric", ["merror", "mlogloss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(metric, weighted):
    rng = np.random.RandomState(5)
    n, K = 1000, 3
    p = rng.dirichlet(np.ones(K), n).astype(np.float32)
    p[0] = (0.0, 1.0, 0.0)                   # log(0) clipped at 1e-16
    y = rng.randint(0, K, n).astype(np.float32)
    y[0] = 0
    info = _Info(y, rng.rand(n).astype(np.float32) if weighted else None)
    want = jax_metric(metric)(p, info)
    assert get_metric(metric)(p, info) == want
    if metric == "merror":                   # softmax's class ids
        ids = p.argmax(axis=1).astype(np.float32)
        assert get_metric(metric)(ids, info) == jax_metric(metric)(ids, info)


# (params, rounds equal in full end to end, rounds with no near tie round
# by round), the last two as measured on the CPU
MULTICLASS_CASES = [
    ({"objective": "multi:softprob", "num_class": 4, "max_depth": 5}, 0, 5),
    ({"objective": "multi:softmax", "num_class": 3, "max_depth": 6}, 0, 3),
    ({"objective": "multi:softprob", "num_class": 5, "max_depth": 4,
      "subsample": 0.8, "colsample_bytree": 0.8, "colsample_bynode": 0.8},
     6, 6),
    ({"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
      "num_parallel_tree": 2, "subsample": 0.7}, 6, 6),
]


@pytest.mark.parametrize("params,full_min,clean_min", MULTICLASS_CASES)
def test_multiclass_training_matches_jax(params, full_min, clean_min,
                                         monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = _data(K=params["num_class"])
    jb, tb = check_against_jax(X, y, dict(params, eta=0.3), 6, full_min,
                               clean_min)
    K = params["num_class"]
    assert tb.gbm.tree_info[:2 * K * params.get("num_parallel_tree", 1)] \
        == jb.gbm.tree_info[:2 * K * params.get("num_parallel_tree", 1)]
    np.testing.assert_array_equal(tb._base_np(), np.zeros(K, np.float32))


def _trained(objective="multi:softprob", K=4, rounds=4, **extra):
    X, y = _data(K=K)
    p = dict({"objective": objective, "num_class": K, "max_depth": 4,
              "device": "cpu"}, **extra)
    return X, y, xt.train(p, xt.DMatrix(X, label=y), rounds,
                          verbose_eval=False)


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_predictions_and_shapes_match_jax(objective):
    X, y, tb = _trained(objective)
    jb = xgb.Booster(model_file=tb.save_raw("json"))
    dj, dt = xgb.DMatrix(X), xt.DMatrix(X)
    for kw in ({}, {"output_margin": True}, {"strict_shape": True},
               {"iteration_range": (1, 3)}):
        want = jb.predict(dj, **kw)
        got = tb.predict(dt, **kw)
        assert got.shape == want.shape, kw
        if objective == "multi:softmax" and not kw.get("output_margin"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    probs = tb.predict(dt)
    if objective == "multi:softprob":
        assert probs.shape == (X.shape[0], 4)
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)
    else:
        assert probs.shape == (X.shape[0],)


def test_model_bytes_round_trip_both_ways():
    X, y, tb = _trained(rounds=3, subsample=0.8)
    dj, dt = xgb.DMatrix(X), xt.DMatrix(X)
    for fmt in ("json", "ubj"):
        raw = tb.save_raw(fmt)
        jb = xgb.Booster(model_file=raw)
        assert jb.num_boosted_rounds() == 3 and jb.n_groups == 4
        np.testing.assert_allclose(jb.predict(dj), tb.predict(dt),
                                   rtol=1e-6, atol=1e-7)
        # the JAX package saves what it read back to the port's bytes
        again = xt.Booster({"device": "cpu"}, model_file=jb.save_raw(fmt))
        assert bytes(again.save_raw(fmt)) == bytes(jb.save_raw(fmt))
    lmp = json.loads(tb.save_raw("json"))["learner"]["learner_model_param"]
    assert lmp == {"base_score": [0.0] * 4, "num_class": 4, "num_target": 4,
                   "num_feature": 10}
    # a JAX-trained model through the port
    jtrained = xgb.train({"objective": "multi:softprob", "num_class": 4,
                          "max_depth": 4}, xgb.DMatrix(X, label=y), 3,
                         verbose_eval=False)
    port = xt.Booster({"device": "cpu"}, model_file=jtrained.save_raw("ubj"))
    np.testing.assert_allclose(port.predict(dt), jtrained.predict(dj),
                               rtol=1e-6, atol=1e-7)
    assert bytes(port.save_raw("ubj")) == bytes(jtrained.save_raw("ubj"))


def test_model_json_matches_jax_fields():
    """learner_model_param, the objective's JSON and the forest's tree_info
    and iteration_indptr as the JAX package writes them for the same
    training call."""
    X, y = _data(K=3)
    p = {"objective": "multi:softmax", "num_class": 3, "max_depth": 3,
         "num_parallel_tree": 2, "base_score": 0.25}
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=y),
                   2, verbose_eval=False)
    tb = xt.train(dict(p, hist_method="prehot", device="cpu"),
                  xt.DMatrix(X, label=y), 2, verbose_eval=False)
    a = json.loads(jb.save_raw("json"))["learner"]
    b = json.loads(tb.save_raw("json"))["learner"]
    for k in ("learner_model_param", "objective", "attributes",
              "feature_names", "feature_types"):
        assert a[k] == b[k], k
    for k in ("name", "num_parallel_tree", "multi_strategy", "tree_info",
              "iteration_indptr"):
        assert a["gradient_booster"][k] == b["gradient_booster"][k], k
    assert b["gradient_booster"]["tree_info"] == [0, 0, 1, 1, 2, 2] * 2


def test_eval_set_runs_multiclass_metrics():
    X, y = _data(K=3)
    dtr = xt.DMatrix(X[:2000], label=y[:2000])
    dte = xt.DMatrix(X[2000:], label=y[2000:])
    res = {}
    bst = xt.train({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 4, "eval_metric": ["merror", "mlogloss"],
                    "device": "cpu"}, dtr, 5,
                   evals=[(dtr, "train"), (dte, "test")], evals_result=res,
                   verbose_eval=False)
    assert list(res["test"]) == ["merror", "mlogloss"]
    ll = res["test"]["mlogloss"]
    assert ll[-1] < ll[0]
    p = bst.predict(dte)
    want = -np.mean(np.log(np.clip(p[np.arange(1000), y[2000:].astype(int)],
                                   1e-16, 1)))
    assert abs(want - ll[-1]) < 1e-6
    # softmax's default metric is merror
    soft = xt.train({"objective": "multi:softmax", "num_class": 3,
                     "max_depth": 3, "device": "cpu"}, dtr, 2,
                    evals=[(dte, "test")], evals_result=res,
                    verbose_eval=False)
    assert list(res["test"]) == ["merror"] and soft.n_groups == 3


def test_seven_group_server_answers_equal_predict():
    from xgboost_tpu_torch.serve import Server

    X, y, tb = _trained(K=7, rounds=3)
    raw = tb.save_raw("ubj")
    want = tb.predict(xt.DMatrix(X))
    with Server(models={"m": raw}, max_batch=512, device="cpu") as srv:
        srv.warmup()
        for n, lo in ((1, 0), (8, 17), (64, 100), (512, 1000), (700, 2000)):
            got = np.asarray(srv.predict(X[lo:lo + n]))
            assert got.shape == (n, 7)
            np.testing.assert_array_equal(got, want[lo:lo + n])


def test_walk_plans_seven_groups_at_every_bucket():
    """K1's plan for a 210-tree, 7-group forest of depth 8 over 54
    features (30 Covertype rounds): the spread walk at every server
    bucket, the staged walk (X read from global memory: 768 rows x 54
    features do not fit half the shared memory) at 100,000 rows."""
    from xgboost_tpu_torch.ops.cuda.walk import (SMEM_MAX, walk_plan,
                                                 slot_spans)
    from xgboost_tpu_torch.serve.buckets import BucketLadder
    from xgboost_tpu_torch.serve.packed import PackedForest
    from xgboost_tpu_torch.testing import make_forest

    trees, info = make_forest(210, 8, 54, n_groups=7, seed=11)
    pf = PackedForest.from_trees(trees, info, 7)
    Tp = pf.tree_offsets.shape[0]
    spans = slot_spans(pf.tree_offsets, pf.words.shape[0])
    for bucket in BucketLadder.pow2(512).sizes:
        plan = walk_plan(bucket, Tp, spans, 54, 7, 132)
        assert plan.schedule == "spread" and plan.smem <= SMEM_MAX
    plan = walk_plan(100_000, Tp, spans, 54, 7, 132)
    assert plan.schedule == "staged" and not plan.stage_x
    assert plan.smem <= SMEM_MAX
