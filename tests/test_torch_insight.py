"""The port's insight telemetry and model report
(``xgboost_tpu_torch/obs/insight.py``) against the JAX package's: the
per-round records of the fused tier (depthwise, where ``_batchable``
holds) and of the host tier (lossguide, dart) equal the JAX package's
(integer fields exactly, gains, leaf values and norms to ``RTOL``), the
in-carry eval gives the host path's scores, arming moves no model byte,
and ``model_inspect`` / ``model_diff`` give the JAX package's reports.
The JAX package runs with ``hist_method="prehot"``, which sums the
port's int8x2 integers, so both grow the same trees."""

import contextlib
import json

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.obs import insight as jinsight
from xgboost_tpu_torch.obs import insight
from xgboost_tpu_torch.obs import metrics as obs_metrics
from xgboost_tpu_torch.obs import trace

RTOL = 1e-5
SCORE_RTOL = 1e-6
INT_KEYS = ("round", "leaf_count", "split_count", "depth",
            "nan_guard_bad_rows")
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
          "max_bin": 64, "eval_metric": ["logloss", "error"]}
TIERS = {
    "fused": {},
    "fused_multiclass": {"objective": "multi:softprob", "num_class": 3,
                         "eval_metric": ["mlogloss"]},
    "lossguide": {"grow_policy": "lossguide", "max_leaves": 6},
    "dart": {"booster": "dart", "rate_drop": 0.3},
}
ROUNDS = 4


def _data(n=600, f=6, seed=0, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] + 0.3 * rng.randn(n)
    if classes == 2:
        y = (s > 0).astype(np.float32)
    else:
        y = np.digitize(s, [-0.5, 0.5]).astype(np.float32)
    return X, y


@contextlib.contextmanager
def armed(eval=True):
    insight.enable(eval=eval)
    jinsight.enable(eval=eval)
    try:
        yield
    finally:
        insight.disable()
        jinsight.disable()


def _train(pkg, params, data, val=None, rounds=ROUNDS, **kw):
    X, y = data
    if val is not None:
        kw["evals"] = [(pkg.DMatrix(val[0], label=val[1]), "val")]
    extra = {"device": "cpu"} if pkg is xt else {"hist_method": "prehot"}
    return pkg.train(dict(params, **extra), pkg.DMatrix(X, label=y),
                     rounds, verbose_eval=False, **kw)


def _raw(bst):
    return bytes(bst.save_raw("ubj"))


def _same_record(a, b):
    """Integer fields exactly, the rest to ``RTOL``; the leaves' mean, a
    sum of signed values, to ``RTOL`` of the largest leaf."""
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    scale = max(abs(a.get("leaf_value_min", 0.0)),
                abs(a.get("leaf_value_max", 0.0)))
    for k in a:
        if k in INT_KEYS:
            assert a[k] == b[k], (k, a[k], b[k])
        else:
            atol = RTOL * scale if k == "leaf_value_mean" else 1e-7
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_records_equal_the_jax_packages(tier):
    params = dict(PARAMS, **TIERS[tier])
    classes = params.get("num_class", 2)
    data = _data(classes=classes)
    with armed(eval=False):
        jb = _train(xgb, params, data)
        tb = _train(xt, params, data)
    assert not tb._insight_blocked
    assert len(tb.training_log.records) == ROUNDS
    for a, b in zip(jb.training_log.records, tb.training_log.records):
        _same_record(a, b)
    rec = tb.training_log.records[0]
    fused = tier.startswith("fused")
    assert ("grad_norm" in rec) == fused
    if fused:
        assert len(rec["gain_per_level"]) == params["max_depth"]
        assert rec["nan_guard_bad_rows"] == 0


@pytest.mark.parametrize("tier", ["fused", "lossguide"])
def test_arming_moves_no_model_byte(tier):
    params = dict(PARAMS, **TIERS[tier])
    data, val = _data(), _data(300, seed=1)
    with armed():
        on = _train(xt, params, data, val)
    off = _train(xt, params, data, val)
    assert _raw(on) == _raw(off)
    assert dict(on.training_log) == dict(off.training_log)
    assert on.training_log.records and not off.training_log.records


def test_in_carry_scores_equal_the_host_path():
    data, val = _data(), _data(300, seed=1)
    Xv, yv = val
    with armed():
        tb = _train(xt, PARAMS, data, val)
    ins = tb._insight_scores
    assert ins is not None and ins["iteration"] == ROUNDS - 1
    dv = xt.DMatrix(Xv, label=yv)
    p = tb.predict(dv)
    for name in ("logloss", "error"):
        host = float(xt.metric.get_metric(name)(p, dv.info))
        np.testing.assert_allclose(ins["scores"][("val", name)], host,
                                   rtol=SCORE_RTOL)
    off = _train(xt, PARAMS, data, val)
    assert dict(tb.training_log) == dict(off.training_log)


def test_in_carry_history_equals_the_jax_packages():
    data, val = _data(), _data(300, seed=1)
    with armed():
        jb = _train(xgb, PARAMS, data, val)
        tb = _train(xt, PARAMS, data, val)
    for m in ("logloss", "error"):
        np.testing.assert_allclose(tb.training_log["val"][m],
                                   jb.training_log["val"][m],
                                   rtol=SCORE_RTOL)


def test_snapshot_resume_restores_records(tmp_path):
    data, val = _data(), _data(300, seed=1)
    p = dict(PARAMS, eval_metric="logloss")
    ck = xt.CheckpointConfig(directory=str(tmp_path), every_n_rounds=3)
    with armed():
        with pytest.raises(RuntimeError, match="AbortAtRound"):
            _train(xt, p, data, val, rounds=10, checkpoint=ck,
                   callbacks=[xt.callback.AbortAtRound(7)])
        resumed = _train(xt, p, data, val, rounds=10, checkpoint=ck)
        straight = _train(xt, p, data, val, rounds=10)
    log = resumed.training_log
    assert [r["round"] for r in log.records] == list(range(10))
    assert len(log["val"]["logloss"]) == 10
    assert log["val"]["logloss"] == straight.training_log["val"]["logloss"]
    for a, b in zip(straight.training_log.records, log.records):
        _same_record(a, b)


def test_disarmed_records_nothing():
    insight.disable()
    tb = _train(xt, PARAMS, _data(), _data(300, seed=1))
    assert not tb.training_log.records
    assert tb._insight_scores is None and tb._insight_state is None


def test_log_round_streams_gauges_and_instants():
    reg = obs_metrics.get_registry()
    t = trace.enable(capacity=64)
    try:
        with armed(eval=False):
            tb = _train(xt, PARAMS, _data(), rounds=2)
    finally:
        trace.disable()
    last = tb.training_log.records[-1]
    assert reg.get("xtpu_insight_round") == 1.0
    assert reg.get("xtpu_insight_leaf_count") == last["leaf_count"]
    assert sum(s.name == "insight/round" for s in t.spans()) == 2


def test_training_log_is_one_class():
    from xgboost_tpu_torch.callback import CallbackContainer
    from xgboost_tpu_torch.obs import TrainingLog
    from xgboost_tpu_torch.obs.training_log import TrainingLog as Old

    assert Old is TrainingLog is insight.TrainingLog
    assert isinstance(CallbackContainer([]).history, TrainingLog)
    log = TrainingLog()
    log.log_eval("val", "logloss", 0.5)
    log.log_round(0, {"leaf_count": 8, "gain_per_level": [1.0, 2.0]})
    jlog = jinsight.TrainingLog()
    jlog.log_eval("val", "logloss", 0.5)
    jlog.log_round(0, {"leaf_count": 8, "gain_per_level": [1.0, 2.0]})
    assert log.to_obj() == jlog.to_obj()
    back = TrainingLog.from_obj(jlog.to_obj())
    assert back.records == log.records and back == log


def test_one_model_inspect():
    import xgboost_tpu_torch.dump as dump

    assert not hasattr(dump, "model_inspect")
    tb = _train(xt, PARAMS, _data())
    assert tb.inspect() == insight.model_inspect(tb)


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_model_inspect_of_one_file_is_the_jax_report(objective, tmp_path):
    params = dict(PARAMS, objective=objective, max_depth=3)
    classes = 2
    if objective == "multi:softprob":
        params["num_class"] = classes = 3
        params["eval_metric"] = ["mlogloss"]
    jb = _train(xgb, params, _data(classes=classes), rounds=5,
                early_stopping_rounds=2,
                evals=[(xgb.DMatrix(*_data(200, seed=3, classes=classes)[:1],
                                    label=_data(200, seed=3,
                                                classes=classes)[1]),
                        "v")])
    path = str(tmp_path / "m.json")
    jb.save_model(path)
    ours = insight.model_inspect(xt.Booster({"device": "cpu"},
                                            model_file=path))
    theirs = jinsight.model_inspect(xgb.Booster(model_file=path))
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)


def test_model_diff_names_the_jax_packages_features():
    X, y = _data()
    a_raw = _raw(_train(xgb, PARAMS, (X, y), rounds=3))
    b_raw = _raw(_train(xgb, dict(PARAMS, eta=0.6, max_depth=4), (X, y),
                        rounds=5))
    ta, tb = (xt.Booster({"device": "cpu"}, model_file=r)
              for r in (a_raw, b_raw))
    ja, jb = (xgb.Booster(model_file=bytearray(r)) for r in (a_raw, b_raw))
    ours = insight.model_diff(ta, tb, dm=xt.DMatrix(X, label=y))
    theirs = jinsight.model_diff(ja, jb, dm=xgb.DMatrix(X, label=y))
    assert [f["feature"] for f in ours["top_features"]] == \
        [f["feature"] for f in theirs["top_features"]]
    np.testing.assert_allclose(ours["prediction_drift"],
                               theirs["prediction_drift"], rtol=1e-5)
    assert ours["importance_delta"].keys() == theirs["importance_delta"].keys()
    same = insight.model_diff(ta, ta, dm=xt.DMatrix(X, label=y))
    assert same["prediction_drift"] == 0.0 and same["top_features"] == []


def test_front_end_report_route():
    from xgboost_tpu_torch.serve import FleetRouter, Server
    from xgboost_tpu_torch.serve import frontend
    from test_torch_serve_frontend import _Http

    X, y = _data()
    raw = _raw(_train(xt, PARAMS, (X, y), rounds=3))
    want = insight.model_inspect(xt.Booster({"device": "cpu"},
                                            model_file=raw))
    for srv in (Server(models={"m": raw}, device="cpu"),
                FleetRouter(models={"m": raw}, replicas=2, device="cpu")):
        h = _Http(frontend.make_http_server, srv)
        try:
            code, rep = h.call("/v1/model/m/report")
            assert code == 200
            assert rep.pop("name") == "m" and rep.pop("version") == 1
            assert rep == json.loads(json.dumps(want))
            assert h.call("/v1/model/nope/report")[0] == 404
        finally:
            h.close()
            srv.close()
