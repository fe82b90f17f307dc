"""The port's jsonl loop and HTTP front end (``serve/frontend.py``)
against the JAX package's on the same model and the same requests:
predictions to ``RTOL`` (``tests/test_torch_serve.py``), SHAP
contributions to ``JAX_TOL`` (``tests/test_torch_shap.py``: the JAX
package's recursion rounds in float32), and the same status codes,
``error_type``s and Prometheus family names, every family common (the
port's ``recompiles`` counter and ``recompiles_after_warmup`` gauge count
its serving graphs' captures where the JAX package's count its compile
cache). ``GET /v1/model/<name>/report`` answers the JAX package's
report."""

import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.serve import Server as JaxServer
from xgboost_tpu.serve import frontend as jax_frontend
from xgboost_tpu_torch.serve import FleetRouter, Server
from xgboost_tpu_torch.serve import frontend

RTOL = 1e-6
JAX_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(12)
    X = rng.randn(300, 6).astype(np.float32)
    X[rng.rand(300, 6) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 2]) > 0
         ).astype(np.float32)
    bst = xgb.train({"objective": "binary:logistic", "max_depth": 4,
                     "eta": 0.3}, xgb.DMatrix(X, label=y), 8,
                    verbose_eval=False)
    return bytes(bst.save_raw("json")), X


class _Http:
    """One front end on an ephemeral port, served from a thread."""

    def __init__(self, make, server):
        self.httpd = make(server, 0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, path, obj=None, raw=None):
        data = raw if raw is not None else (
            None if obj is None else json.dumps(obj).encode())
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                code, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read().decode()
        try:
            return code, json.loads(body)
        except json.JSONDecodeError:
            return code, body

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture
def both(model):
    """(port front end, JAX front end) over the same model."""
    raw, _ = model
    srv = Server(models={"m": raw}, device="cpu", max_batch=64)
    jsrv = JaxServer(models={"m": raw}, max_batch=64)
    srv.warmup()
    jsrv.warmup()
    ours = _Http(frontend.make_http_server, srv)
    theirs = _Http(jax_frontend.make_http_server, jsrv)
    yield ours, theirs, srv, jsrv
    ours.close()
    theirs.close()
    srv.close()
    jsrv.close()


@pytest.mark.parametrize("output", ["value", "margin"])
@pytest.mark.parametrize("rows", [1, 7, 150])
def test_predict_route(model, both, rows, output):
    _, X = model
    ours, theirs, _, _ = both
    req = {"data": X[:rows].tolist(), "model": "m", "output": output,
           "id": 5}
    (c1, a), (c2, b) = ours.call("/v1/predict", req), \
        theirs.call("/v1/predict", req)
    assert c1 == c2 == 200
    assert (a["id"], a["model"], a["version"]) == \
        (b["id"], b["model"], b["version"]) == (5, "m", 1)
    np.testing.assert_allclose(a["predictions"], b["predictions"],
                               rtol=RTOL, atol=RTOL)


def test_contribs_route(model, both):
    raw, X = model
    ours, theirs, _, _ = both
    req = {"data": X[:200].tolist(), "id": 3}
    (c1, a), (c2, b) = ours.call("/v1/model/m/contribs", req), \
        theirs.call("/v1/model/m/contribs", req)
    assert c1 == c2 == 200 and a["version"] == b["version"] == 1
    phi, want = np.asarray(a["contribs"]), np.asarray(b["contribs"])
    assert phi.shape == want.shape == (200, 7)
    np.testing.assert_allclose(phi, want, rtol=JAX_TOL, atol=JAX_TOL)
    # equal to the port's Booster.predict(pred_contribs=True)
    bst = xt.Booster({"device": "cpu"}, model_file=raw)
    np.testing.assert_array_equal(
        phi, bst.predict(xt.DMatrix(X[:200]), pred_contribs=True))


# (path, body, raw body): each failure's status and error_type in both
FAILURES = [
    ("/v1/predict", {"data": [[1.0] * 6], "model": "nope"}, None),
    ("/v1/predict", {"data": [[1.0] * 6], "output": "proba"}, None),
    ("/v1/predict", {"model": "m"}, None),
    ("/v1/predict", None, b"{not json"),
    ("/v1/model/nope/contribs", {"data": [[1.0] * 6]}, None),
    ("/v1/nothing", {"data": [[1.0] * 6]}, None),
]


@pytest.mark.parametrize("path,obj,raw", FAILURES,
                         ids=["unknown_model", "bad_output",
                              "no_data", "bad_json", "contribs_unknown",
                              "unknown_path"])
def test_failures_match(both, path, obj, raw):
    ours, theirs, _, _ = both
    (c1, a), (c2, b) = ours.call(path, obj, raw), theirs.call(path, obj, raw)
    assert c1 == c2 and c1 in (400, 404)
    assert a.get("error_type") == b.get("error_type")


def test_narrow_request_is_refused_where_jax_answers(both):
    """A request narrower than the model's features: the port refuses it
    (its walk would read past the row), the JAX package answers from its
    clamped reads."""
    ours, theirs, _, _ = both
    req = {"data": [[1.0, 2.0]], "model": "m"}
    code, body = ours.call("/v1/predict", req)
    assert code == 400 and body["error_type"] == "ValueError"
    assert "needs 6 feature columns" in body["error"]
    assert theirs.call("/v1/predict", req)[0] == 200


def test_get_routes(model, both):
    _, X = model
    ours, theirs, srv, jsrv = both
    for h in (ours, theirs):
        assert h.call("/v1/predict", {"data": X[:3].tolist()})[0] == 200
    (c1, m1), (c2, m2) = ours.call("/v1/models"), theirs.call("/v1/models")
    assert c1 == c2 == 200 and m1 == m2
    (c1, h1), (c2, h2) = ours.call("/healthz"), theirs.call("/healthz")
    assert c1 == c2 == 200 and h1["status"] == h2["status"] == "ok"
    common = ("status", "replica", "warmed", "models", "queue_rows",
              "requests", "sheds", "deadline_exceeded", "errors", "swaps",
              "rollbacks")
    assert {k: h1[k] for k in common} == {k: h2[k] for k in common}
    (c1, s1), (c2, s2) = ours.call("/v1/metrics"), \
        theirs.call("/v1/metrics")
    assert c1 == c2 == 200
    assert s1["counters"]["requests"] == s2["counters"]["requests"] == 1
    assert s1["models"] == s2["models"] and s1["buckets"] == s2["buckets"]
    # /report: the served version's model_inspect, the JAX package's JSON
    (c1, r1), (c2, r2) = ours.call("/v1/model/m/report"), \
        theirs.call("/v1/model/m/report")
    assert c1 == c2 == 200 and r1 == r2
    assert ours.call("/v1/model/nope/report")[0] == \
        theirs.call("/v1/model/nope/report")[0] == 404


def _families(text):
    return {m.group(1): m.group(2)
            for m in re.finditer(r"^# TYPE (xtpu_serve_\w+) (\w+)$", text,
                                 re.M)}


def test_prometheus_families(model, both):
    _, X = model
    ours, theirs, _, _ = both
    for h in (ours, theirs):
        assert h.call("/v1/predict", {"data": X[:3].tolist()})[0] == 200
        assert h.call("/v1/model/m/contribs",
                      {"data": X[:2].tolist()})[0] == 200
    (c1, t1), (c2, t2) = ours.call("/metrics"), theirs.call("/metrics")
    assert c1 == c2 == 200
    f1, f2 = _families(t1), _families(t2)
    assert "xtpu_serve_stage_latency_seconds" in f1
    assert f1 == f2
    stages = set(re.findall(r'stage="(\w+)"', t1))
    assert {"queue", "compute", "e2e", "shap"} <= stages


@pytest.mark.parametrize("kind", ["shed", "deadline", "closed"])
def test_overload_deadline_and_closed_codes(model, kind):
    raw, X = model
    codes, types = [], []
    for pkg in ("port", "jax"):
        kw = dict(max_batch=64, max_delay_ms=3000 if kind == "shed" else 300,
                  max_queue_rows=4)
        srv = (Server(models={"m": raw}, device="cpu", **kw) if pkg == "port"
               else JaxServer(models={"m": raw}, **kw))
        h = _Http(frontend.make_http_server if pkg == "port"
                  else jax_frontend.make_http_server, srv)
        try:
            req = {"data": X[:3].tolist()}
            if kind == "shed":
                first = srv.submit(X[:3])         # holds the queue
                code, body = h.call("/v1/predict", req)
                first.result(timeout=30)
            elif kind == "deadline":
                code, body = h.call("/v1/predict", dict(req, timeout_ms=1))
            else:
                srv.close()
                code, body = h.call("/v1/predict", req)
                assert h.call("/healthz")[0] == 503
            codes.append(code)
            types.append(body["error_type"])
        finally:
            h.close()
            srv.close()
    assert codes[0] == codes[1] == {"shed": 429, "deadline": 504,
                                    "closed": 503}[kind]
    assert types[0] == types[1]


def test_jsonl_loop_matches_jax(model):
    raw, X = model
    lines = [json.dumps({"data": X[:4].tolist(), "id": 1}),
             json.dumps({"data": X[4:5].tolist(), "output": "margin",
                         "id": 2}),
             "",
             "not json",
             json.dumps({"data": X[:2].tolist(), "model": "nope", "id": 3}),
             json.dumps({"data": X[:2].tolist(), "output": "proba",
                         "id": 4}),
             json.dumps({"data": X[5:30].tolist(), "id": 5})]
    text = "\n".join(lines) + "\n"
    outs = []
    for srv in (Server(models={"m": raw}, device="cpu"),
                JaxServer(models={"m": raw})):
        out = io.StringIO()
        try:
            n = (frontend if isinstance(srv, Server) else
                 jax_frontend).jsonl_loop(srv, io.StringIO(text), out)
        finally:
            srv.close()
        assert n == 6
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    for a, b in zip(*outs):
        assert a.get("id") == b.get("id")
        assert a.get("error_type") == b.get("error_type")
        if "predictions" in b:
            assert (a["model"], a["version"]) == (b["model"], b["version"])
            np.testing.assert_allclose(a["predictions"], b["predictions"],
                                       rtol=RTOL, atol=RTOL)


def test_build_server_keys_and_fleet(model, tmp_path):
    raw, X = model
    path = str(tmp_path / "m.json")
    with open(path, "wb") as fh:
        fh.write(raw)
    server, front = frontend.build_server(
        ["--fleet", "2", f"model[m]={path}", "max_batch=32", "buckets=1,8",
         "shap_max_batch=16", "device=cpu", "http_port=0",
         "warm_contribs=1"])
    try:
        assert isinstance(server, FleetRouter) and server.n_replicas == 2
        assert front == {"http_port": "0", "warm_contribs": "1"}
        r = server.replicas()[0]
        assert r.ladder.sizes == (1, 8, 32) and r.shap_ladder.sizes[-1] == 16
        want = xt.Booster({"device": "cpu"}, model_file=raw).predict(
            xt.DMatrix(X[:40]))
        np.testing.assert_allclose(server.predict(X[:40], "m"), want,
                                   rtol=RTOL)
    finally:
        server.close()
    with pytest.raises(ValueError, match="unknown serve key"):
        frontend.build_server([f"model={path}", "colour=blue"])
    with pytest.raises(ValueError, match="at least one model"):
        frontend.build_server(["device=cpu"])


def test_cli_serve_jsonl_subprocess(model, tmp_path):
    """``python -m xgboost_tpu_torch serve`` over stdin / stdout, against
    the in-process loop's answers."""
    raw, X = model
    path = str(tmp_path / "m.json")
    with open(path, "wb") as fh:
        fh.write(raw)
    lines = "".join(json.dumps({"data": X[i:i + 3].tolist(), "id": i}) + "\n"
                    for i in range(0, 30, 3))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch", "serve",
         f"model={path}", "device=cpu", "--fleet", "2"],
        input=lines, capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [g["id"] for g in got] == list(range(0, 30, 3))
    want = xt.Booster({"device": "cpu"}, model_file=raw).predict(
        xt.DMatrix(X[:30]))
    np.testing.assert_allclose(
        np.concatenate([g["predictions"] for g in got]), want, rtol=RTOL)
    snap = json.loads(proc.stderr.strip().splitlines()[-1])
    assert snap["counters"]["requests"] == 10 and snap["n_replicas"] == 2
