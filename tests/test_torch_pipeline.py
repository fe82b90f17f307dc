"""The port's continuous train -> serve pipeline
(``xgboost_tpu_torch/pipeline/``) against the JAX package's: on the same
pages both make the same decisions (promote / reject / roll back, with
versions), with gate scores to ``SCORE_RTOL`` and artifacts whose trees
have one structure and whose predictions agree to ``PRED_RTOL``; pages
and manifests are each package's files for the other; and the port's own
recovery contract: a kill at any stage, a torn snapshot, a corrupt
artifact or flaky reads end at the uninterrupted run's bytes. The JAX
package runs with ``hist_method="prehot"``, which sums the port's int8x2
integers."""

import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu.pipeline as jp
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.obs.flight import render_postmortem, verify_bundle
from xgboost_tpu_torch.obs.metrics import get_registry
from xgboost_tpu_torch.pipeline import (CanaryRolledBack, DriftGateFailed,
                                        GateRule, KilledByChaos, PageCorrupt,
                                        PageLog, Pipeline, PipelineConfig,
                                        PipelineFaultPlan,
                                        PromotionManifest, PromotionRejected,
                                        parse_gate)
from xgboost_tpu_torch.serve import FleetRouter, Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary:logistic", "max_depth": 2, "eta": 0.3,
          "max_bin": 32}
K = 3          # rounds per epoch
N_PAGES = 2    # epochs of the kill-stage runs
SCORE_RTOL = 1e-5
# an artifact of one epoch's rounds; a continued epoch's gradients come
# from a margin whose last ulp the two packages' walks may round apart,
# and one ulp can move an int8x2 quantum, so its leaves (and predictions)
# are held at the leaf tolerance of tests/test_torch_train.py
PRED_RTOL = 1e-6
CONTINUED_RTOL = 1e-5
STAGES = ["post_ingest", "mid_epoch", "post_train", "post_gate",
          "post_artifact", "post_manifest", "post_promote"]


def _page(n=60, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.1 * rng.randn(n) > 0
         ).astype(np.float32)
    return X, y


HOLDOUT = _page(150, 99)


def _config(workdir, pkg=None, **kw):
    mod = jp if pkg == "jax" else sys.modules[__name__]
    params = dict(PARAMS, **({"hist_method": "prehot"} if pkg == "jax"
                             else {"device": "cpu"}))
    base = dict(workdir=str(workdir), params=params, rounds_per_epoch=K,
                gates=(mod.GateRule("auc", max_regression=0.5),),
                checkpoint_every=2)
    base.update(kw)
    return (jp.PipelineConfig if pkg == "jax" else PipelineConfig)(**base)


def _server():
    return Server(device="cpu")


def _run(workdir, chaos=None, epochs=N_PAGES, server=None, **kw):
    pipe = Pipeline(_config(workdir, **kw), server=server,
                    holdout=HOLDOUT, chaos=chaos)
    for e in range(epochs):
        pipe.step(*_page(seed=e))
    return pipe


def _artifacts(workdir):
    d = os.path.join(str(workdir), "models")
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d)) if fn.endswith(".ubj")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted run's artifacts: the bytes every recovery must
    reach."""
    pipe = _run(tmp_path_factory.mktemp("pipe_ref"))
    assert pipe.status()["promotions"] == N_PAGES
    return _artifacts(pipe.config.workdir)


# ------------------------------------------------------ against the JAX one

def _scenario(name):
    """(config keywords, gate floors by epoch) of a decision scenario."""
    if name == "promote":
        return {}, {}
    if name == "reject":
        return {"gates": (GateRule("auc", min_value=0.55),)}, {1: 1.1}
    return {"canary_max_regression": -0.9}, {}


def _drive(pkg, workdir, scenario, epochs=3):
    kw, floors = _scenario(scenario)
    if pkg == "jax" and "gates" in kw:
        kw = dict(kw, gates=(jp.GateRule("auc", min_value=0.55),))
    cls = jp.Pipeline if pkg == "jax" else Pipeline
    pipe = cls(_config(workdir, pkg, **kw), holdout=HOLDOUT)
    out = []
    for e in range(epochs):
        if "gates" in kw:
            pipe.gates.rules[0].min_value = floors.get(e, 0.55)
        for entry in pipe.step(*_page(seed=e)):
            canary = entry.get("canary") or {}
            out.append((entry["epoch"], entry["action"],
                        entry.get("version"), entry["scores"],
                        canary.get("restored_version")))
    return pipe, out


@pytest.mark.parametrize("scenario", ["promote", "reject", "rollback"])
def test_decisions_equal_the_jax_packages(scenario, tmp_path):
    ours, a = _drive("port", tmp_path / "port", scenario)
    theirs, b = _drive("jax", tmp_path / "jax", scenario)
    assert [x[:3] + x[4:] for x in a] == [x[:3] + x[4:] for x in b]
    for x, y in zip(a, b):
        assert x[3].keys() == y[3].keys()
        for m in x[3]:
            np.testing.assert_allclose(x[3][m], y[3][m], rtol=SCORE_RTOL)
    assert ours.manifest.state["rolled_back"] == \
        theirs.manifest.state["rolled_back"]
    mine, jax_arts = _artifacts(tmp_path / "port"), \
        _artifacts(tmp_path / "jax")
    assert mine.keys() == jax_arts.keys() and mine
    from test_torch_train import compare_forests

    X = _page(200, 7)[0]
    for fn in mine:
        tb = xt.Booster({"device": "cpu"}, model_file=mine[fn])
        jb = xgb.Booster(model_file=bytearray(jax_arts[fn]))
        assert len(tb.gbm.trees) == len(jb.gbm.trees)
        for t, u in zip(tb.gbm.trees, jb.gbm.trees):
            np.testing.assert_array_equal(t.is_leaf, u.is_leaf)
            np.testing.assert_array_equal(t.split_feature, u.split_feature)
            np.testing.assert_array_equal(t.split_value, u.split_value)
        full, ties, _ = compare_forests(jb.gbm.trees, tb.gbm.trees,
                                        PARAMS["eta"])
        assert full == len(tb.gbm.trees) and not ties
        np.testing.assert_allclose(
            tb.predict(xt.DMatrix(X)), jb.predict(xgb.DMatrix(X)),
            rtol=PRED_RTOL if len(tb.gbm.trees) == K else CONTINUED_RTOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pages_are_the_same_bytes_both_ways(writer, tmp_path):
    X, y = _page(seed=4)
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    logs = {"port": PageLog(str(tmp_path / "port")),
            "jax": jp.PageLog(str(tmp_path / "jax"))}
    for log in logs.values():
        log.append(X, y, w)
        log.append(X[:7])
    for i in range(2):
        a, b = (open(os.path.join(str(tmp_path / k), f"page_{i:06d}.ubj"),
                     "rb").read() for k in ("port", "jax"))
        assert a == b
    reader = PageLog if writer == "jax" else jp.PageLog
    log = reader(str(tmp_path / writer))
    assert log.count() == 2
    page = log.read(0)
    np.testing.assert_array_equal(page["X"], X)
    np.testing.assert_array_equal(page["y"], y)
    np.testing.assert_array_equal(page["w"], w)
    assert log.read(1)["y"] is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_manifest_loads_in_the_other_package(writer, tmp_path):
    cls = PromotionManifest if writer == "port" else jp.PromotionManifest
    m = cls(str(tmp_path))
    m.record_promotion(0, 1, "models/v000001.ubj", rounds=3,
                       scores={"auc": 0.9}, inspect={"num_trees": 3})
    m.record_rejection(1, "floor", {"auc": 0.4})
    m.record_promotion(2, 2, "models/v000002.ubj", rounds=9)
    m.record_rollback(2, 2, "canary")
    other = (jp.PromotionManifest if writer == "port"
             else PromotionManifest).load(str(tmp_path))
    assert other.state == m.state
    assert other.active["version"] == 1 and other.decided_epoch == 2
    assert other.state["rolled_back"] == [2]


# --------------------------------------------------- kill / restart, bytes

@pytest.mark.parametrize("stage", STAGES)
def test_kill_at_stage_recovers_the_uninterrupted_bytes(stage, tmp_path,
                                                        reference):
    plan = PipelineFaultPlan(
        kill_stage=stage, kill_epoch=1,
        kill_round=K + 2 if stage == "mid_epoch" else None)
    with pytest.raises(KilledByChaos) as ei:
        _run(tmp_path, chaos=plan)
    doc = verify_bundle(ei.value.bundle)
    assert doc["reason"] == f"chaos-kill:{stage}"
    assert doc["extra"]["stage"] == stage and doc["extra"]["epoch"] == 1
    buf = io.StringIO()
    render_postmortem(doc, file=buf)
    assert f"chaos-kill:{stage}" in buf.getvalue()
    srv = _server()
    pipe = Pipeline(_config(tmp_path), server=srv, holdout=HOLDOUT)
    pipe.run_pending()
    for e in range(pipe.log.count(), N_PAGES):
        pipe.step(*_page(seed=e))
    assert _artifacts(tmp_path) == reference
    assert srv.registry.get("model").version == N_PAGES
    assert pipe.status()["rounds_behind"] == 0
    srv.close()


def test_a_corrupt_snapshot_falls_back(tmp_path, reference):
    plan = PipelineFaultPlan(kill_stage="mid_epoch", kill_epoch=1,
                             kill_round=2 * K - 1,
                             corrupt_newest_snapshot=True)
    with pytest.raises(KilledByChaos):
        _run(tmp_path, chaos=plan)
    Pipeline(_config(tmp_path), holdout=HOLDOUT).run_pending()
    assert _artifacts(tmp_path) == reference


def test_replay_from_the_page_log_alone(tmp_path, reference):
    plan = PipelineFaultPlan(kill_stage="post_gate", kill_epoch=1)
    with pytest.raises(KilledByChaos):
        _run(tmp_path, chaos=plan)
    ckdir = os.path.join(str(tmp_path), "checkpoints")
    for fn in os.listdir(ckdir):
        os.remove(os.path.join(ckdir, fn))
    pipe = Pipeline(_config(tmp_path), holdout=HOLDOUT)
    pipe.run_pending()
    assert _artifacts(tmp_path) == reference
    replayed = pipe._replay_model(N_PAGES - 1)
    assert bytes(replayed.save_raw("ubj")) == \
        reference[f"v{N_PAGES:06d}.ubj"]


def test_a_corrupt_artifact_is_regenerated(tmp_path, reference):
    srv = _server()
    pipe = Pipeline(_config(tmp_path), server=srv, holdout=HOLDOUT,
                    chaos=PipelineFaultPlan(corrupt_artifact_version=2))
    pipe.step(*_page(seed=0))
    with pytest.raises(PromotionRejected) as ei:
        pipe.step(*_page(seed=1))
    assert ei.value.version == 2
    assert srv.registry.get("model").version == 1
    assert pipe.manifest.decided_epoch == 0
    Pipeline(_config(tmp_path), server=srv, holdout=HOLDOUT).run_pending()
    assert _artifacts(tmp_path) == reference
    assert srv.registry.get("model").version == 2
    srv.close()


def test_flaky_ingest_is_absorbed(tmp_path, monkeypatch, reference):
    monkeypatch.setenv("XTPU_IO_RETRIES", "5")
    pipe = _run(tmp_path, chaos=PipelineFaultPlan(flaky_ingest_p=0.3,
                                                  seed=3))
    assert pipe.status()["promotions"] == N_PAGES
    assert _artifacts(tmp_path) == reference


def test_a_torn_page_is_not_counted(tmp_path):
    log = PageLog(str(tmp_path))
    log.append(*_page(seed=0))
    torn = os.path.join(str(tmp_path), "page_000001.ubj")
    with open(torn, "wb") as fh:
        fh.write(b"\x00" * 100)
    assert log.count() == 1
    assert log.append(*_page(seed=1)) == 1       # rewrites the torn slot
    assert log.count() == 2
    with open(torn, "r+b") as fh:
        fh.truncate(50)
    with pytest.raises(PageCorrupt):
        log.read(1)


def test_exactly_once_and_gate_rejection(tmp_path):
    plan = PipelineFaultPlan(kill_stage="post_manifest", kill_epoch=1)
    with pytest.raises(KilledByChaos):
        _run(tmp_path / "a", chaos=plan)
    srv = _server()
    pipe = Pipeline(_config(tmp_path / "a"), server=srv, holdout=HOLDOUT)
    pipe.run_pending()
    assert [h["version"] for h in pipe.manifest.history()] == [1, 2]
    assert srv.registry.get("model").version == 2
    pipe = Pipeline(_config(tmp_path / "b",
                            gates=(GateRule("auc", min_value=0.55),)),
                    server=srv, holdout=HOLDOUT)
    pipe.gates.rules[0].min_value = 1.1
    rep = pipe.step(*_page(seed=0))
    assert rep[0]["action"] == "rejected"
    assert isinstance(rep[0]["error"], DriftGateFailed)
    assert pipe.manifest.active is None
    srv.close()


# ---------------------------------------------------- serving and the canary

def test_canary_rollback_restores_serving(tmp_path):
    srv = _server()
    pipe = Pipeline(_config(tmp_path, canary_max_regression=-0.9),
                    server=srv, holdout=HOLDOUT)
    pipe.step(*_page(seed=0))
    X = _page(seed=5)[0]
    oracle = np.asarray(srv.predict(X))
    rep = pipe.step(*_page(seed=1))
    assert rep[0]["action"] == "rolled_back"
    assert isinstance(rep[0]["canary"]["error"], CanaryRolledBack)
    assert srv.registry.get("model").version == 1
    np.testing.assert_array_equal(np.asarray(srv.predict(X)), oracle)
    assert pipe.manifest.state["rolled_back"] == [2]
    srv.close()


def test_zero_downtime_across_promotion_and_rollback(tmp_path):
    srv = _server()
    pipe = Pipeline(_config(tmp_path, canary_max_regression=-0.9),
                    server=srv, holdout=HOLDOUT)
    pipe.step(*_page(seed=0))
    X = _page(seed=7)[0]
    failures, versions, stop = [], set(), threading.Event()

    def stream():
        while not stop.is_set():
            try:
                versions.add(srv.predict(X[:4]).version)
            except Exception as err:  # noqa: BLE001 - the assertion target
                failures.append(err)

    threads = [threading.Thread(target=stream) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        pipe.step(*_page(seed=1))
        pipe.step(*_page(seed=2))
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not failures
    assert versions <= {1, 2, 3} and 1 in versions
    srv.close()


def test_a_fleet_is_reconciled_to_the_manifest(tmp_path):
    fleet = FleetRouter(replicas=2, device="cpu")
    pipe = _run(tmp_path, server=fleet)
    assert fleet.served_versions("model") == {2}
    fam = {f.name: f for f in get_registry().collect()}
    assert "xtpu_pipeline_promotions_total" in fam
    assert "xtpu_pipeline_rounds_behind" in fam
    assert pipe.status()["active_version"] == 2
    fleet.close()


def test_gates_take_the_metric_registrys_orientation():
    g = parse_gate("auc:0.01")
    assert (g.metric, g.max_regression, g.min_value) == ("auc", 0.01, None)
    assert parse_gate("logloss:0.05::").max_regression == 0.05
    assert parse_gate("auc::0.7").min_value == 0.7
    assert g.maximize() and not GateRule("logloss").maximize()
    assert GateRule("ndcg").maximize() and not GateRule("rmse").maximize()
    g.check(0.90, 0.905)
    with pytest.raises(DriftGateFailed):
        g.check(0.85, 0.9)
    with pytest.raises(DriftGateFailed):
        GateRule("logloss", max_regression=0.01).check(0.5, 0.4)


def test_the_pipeline_refuses_a_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _config(tmp_path)
    cfg.params = dict(PARAMS)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        Pipeline(cfg, holdout=HOLDOUT)


# ----------------------------------------------------------------------- CLI

def test_cli_dispatch_and_status(tmp_path):
    X, y = _page(120, seed=0)
    data = tmp_path / "train.libsvm"
    with open(data, "w") as fh:
        for i in range(len(y)):
            feats = " ".join(f"{j}:{X[i, j]:.6f}" for j in range(5))
            fh.write(f"{int(y[i])} {feats}\n")
    wd = tmp_path / "wd"
    args = ["pipeline", f"workdir={wd}", f"data={data}", f"holdout={data}",
            "gate=auc:0.5", "rounds_per_epoch=2", "page_rows=60",
            "objective=binary:logistic", "max_depth=2", "max_bin=32",
            "device=cpu"]
    res = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch", *args],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert [ln["action"] for ln in lines[:-1]] == ["promoted", "promoted"]
    assert lines[-1]["status"]["active_version"] == 2
    from xgboost_tpu_torch.cli import main

    out = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, out
    try:
        assert main(["pipeline", f"workdir={wd}", "command=status"]) == 0
    finally:
        sys.stdout = sys_stdout
    st = json.loads(out.getvalue())
    assert st["promotions"] == 2 and st["pages"] == 2
    from xgboost_tpu.pipeline.cli import _status

    assert st == _status(str(wd))
