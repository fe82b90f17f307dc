"""``python -m xgboost_tpu_torch serve``: the jsonl scoring loop and the
HTTP front end (the JAX package's ``serve/frontend.py``).

Config follows the CLI's key=value convention (``cli.py``):

    python -m xgboost_tpu_torch serve model=higgs.ubj max_batch=512 \
        max_delay_ms=2 timeout_ms=100 http_port=8080 --fleet 2

Keys: ``model`` / ``model[NAME]`` (repeatable — multi-model registry),
``max_batch``, ``max_delay_ms``, ``max_queue_rows``, ``timeout_ms``,
``buckets`` (comma list, e.g. ``1,8,64,512``), ``shap_max_batch``,
``shap_buckets``, ``output`` (value|margin), ``log_every_s``,
``http_port``, ``silent``, ``warm_contribs`` (run the contribs ladder
once up front), ``device`` (``cuda``, the default, or ``cpu``) and
``fleet`` — also spelled ``--fleet N`` — which runs N in-process
replicas on the one device behind the consistent-hash
:class:`~.fleet.FleetRouter` instead of a single Server.

Without ``http_port`` the process scores a **jsonl loop**: one request
object per stdin line —

    {"data": [[...], ...], "model": "name", "output": "margin", "id": 7}

— answered in order on stdout as

    {"id": 7, "model": "name", "version": 1, "predictions": [...]}

(typed failures come back as ``{"id":..., "error": "...",
"error_type": "ServerOverloaded"}``; the loop never dies on a bad
line). EOF drains the server and writes a final metrics snapshot to
stderr. Rows within one line are one request — concurrent batching
across clients needs the HTTP front end, whose handler threads share
the micro-batcher:

    POST /v1/predict   {"data": ..., "model":?, "output":?}
    POST /v1/model/<name>/contribs
                       {"data": ...} -> per-feature SHAP values from the
                       device TreeSHAP (last column the bias; rows sum
                       to the margin)
    GET  /v1/models    registry listing
    GET  /v1/metrics   ServeMetrics snapshot (JSON)
    GET  /metrics      Prometheus text exposition of the process-wide
                       registry (``obs/metrics.py``)
    GET  /healthz      liveness + versions/queue/shed counters
                       (503 once the server stops accepting)
    GET  /v1/model/<name>/report
                       501 with ``error_type`` NotImplementedError: the
                       model report needs ``obs.insight`` (ROADMAP A.10)
"""

from __future__ import annotations

import json
import re
import sys
from typing import Dict, List, Tuple

from ..obs.metrics import get_registry
from .errors import ServeError, UnknownModel
from .server import ServeConfig, Server


def _parse_kv(argv: List[str]) -> List[Tuple[str, str]]:
    # --fleet N / --fleet=N sugar for fleet=N (the one flag-style arg,
    # matching the README quickstart)
    norm: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--fleet":
            if i + 1 >= len(argv):
                raise ValueError("--fleet needs a replica count")
            norm.append(f"fleet={argv[i + 1]}")
            i += 2
            continue
        if a.startswith("--fleet="):
            norm.append("fleet=" + a.split("=", 1)[1])
            i += 1
            continue
        norm.append(a)
        i += 1
    pairs = []
    for a in norm:
        if "=" not in a:
            raise ValueError(f"expected key=value argument, got {a!r}")
        k, v = a.split("=", 1)
        pairs.append((k, v))
    return pairs


def build_server(argv: List[str]) -> Tuple[Server, Dict[str, str]]:
    """Parse key=value args, construct + warm a Server (or, with
    ``fleet=N`` / ``--fleet N``, a FleetRouter over N replicas).
    Returns (server, leftover config dict for the frontend loop)."""
    models: Dict[str, str] = {}
    cfg_kw: Dict[str, object] = {}
    front: Dict[str, str] = {}
    fleet_n = 0
    device = "cuda"
    for k, v in _parse_kv(argv):
        m = re.match(r"^model\[(.+)\]$", k)
        if m:
            models[m.group(1)] = v
        elif k == "model":
            models["default"] = v
        elif k in ("max_batch", "max_queue_rows", "shap_max_batch"):
            cfg_kw[k] = int(v)
        elif k in ("max_delay_ms", "timeout_ms", "log_every_s"):
            cfg_kw[k] = float(v)
        elif k in ("buckets", "shap_buckets"):
            cfg_kw[k] = [int(x) for x in v.split(",") if x]
        elif k == "fleet":
            fleet_n = int(v)
        elif k == "device":
            device = v
        elif k in ("http_port", "silent", "output", "warm_contribs"):
            front[k] = v
        else:
            raise ValueError(f"unknown serve key: {k!r}")
    if not models:
        raise ValueError("serve needs at least one model= / model[NAME]=")
    if fleet_n > 0:
        from .fleet import FleetConfig, FleetRouter

        server = FleetRouter(config=FleetConfig(
            replicas=fleet_n, serve=ServeConfig(**cfg_kw)), device=device)
    else:
        server = Server(config=ServeConfig(**cfg_kw), device=device)
    for name, path in models.items():
        server.load_model(name, path)
    server.warmup()
    if front.get("warm_contribs", "0") in ("1", "true"):
        server.warmup_contribs()
    if fleet_n > 0:
        server.start_autoscaler()
    return server, front


def _error_obj(exc: BaseException, rid) -> Dict[str, object]:
    return {"id": rid, "error": str(exc), "error_type": type(exc).__name__}


def _score_obj(server: Server, obj: Dict[str, object],
               default_output: str) -> Dict[str, object]:
    rid = obj.get("id")
    kw: Dict[str, object] = {"output": str(obj.get("output",
                                                   default_output))}
    if "timeout_ms" in obj:
        kw["timeout_ms"] = obj["timeout_ms"]
    try:
        preds = server.predict(obj["data"], obj.get("model"), **kw)
    except (ServeError, ValueError, KeyError, TypeError) as exc:
        return _error_obj(exc, rid)
    return {"id": rid, "model": getattr(preds, "model", None),
            "version": getattr(preds, "version", None),
            "predictions": [float(x) for x in preds.reshape(-1)]
            if preds.ndim == 1 else preds.tolist()}


def _contribs_obj(server, name: str, obj: Dict[str, object]
                  ) -> Dict[str, object]:
    rid = obj.get("id")
    kw: Dict[str, object] = {}
    if "timeout_ms" in obj:
        kw["timeout_ms"] = obj["timeout_ms"]
    try:
        phi = server.contribs(obj["data"], name or None, **kw)
    except (ServeError, ValueError, KeyError, TypeError) as exc:
        return _error_obj(exc, rid)
    return {"id": rid, "model": getattr(phi, "model", None),
            "version": getattr(phi, "version", None),
            "contribs": phi.tolist()}


def jsonl_loop(server: Server, instream, outstream,
               default_output: str = "value") -> int:
    n = 0
    for line in instream:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as exc:
            out = _error_obj(exc, None)
        else:
            out = _score_obj(server, obj, default_output)
        outstream.write(json.dumps(out) + "\n")
        outstream.flush()
        n += 1
    return n


# ----------------------------------------------------------------- HTTP mode

def make_http_server(server: Server, port: int,
                     default_output: str = "value"):
    """A stdlib ThreadingHTTPServer; handler threads share the
    micro-batcher, so concurrent POSTs coalesce into device batches.
    Returns the HTTPServer (``.server_address[1]`` is the bound port —
    pass port=0 for an ephemeral one; call ``.serve_forever()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str, ctype: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                # external probes and the pipeline's canary watcher read
                # the same signals; 503 once the server stopped accepting
                h = server.health_snapshot()
                self._send(200 if h["status"] == "ok" else 503, h)
            elif self.path == "/metrics":
                # Prometheus text exposition from the process-wide
                # registry: every server's and the fleet's series
                self._send_text(
                    200, get_registry().render_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/v1/metrics":
                self._send(200, server.metrics_snapshot())
            elif self.path == "/v1/models":
                self._send(200, server.registry.describe())
            elif self.path.startswith("/v1/model/") \
                    and self.path.endswith("/report"):
                name = self.path[len("/v1/model/"):-len("/report")]
                try:
                    server.registry.get(name or None)
                except UnknownModel as exc:
                    self._send(404, _error_obj(exc, None))
                    return
                self._send(501, _error_obj(NotImplementedError(
                    "the model report needs obs.insight, which is not in "
                    "the PyTorch port yet (ROADMAP A.10)"), None))
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:  # noqa: N802
            m = re.match(r"^/v1/model/(.+)/contribs$", self.path)
            if self.path != "/v1/predict" and m is None:
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                self._send(400, _error_obj(exc, None))
                return
            if m is not None:
                out = _contribs_obj(server, m.group(1), obj)
            else:
                out = _score_obj(server, obj, default_output)
            if "error" in out:
                code = {"ServerOverloaded": 429, "DeadlineExceeded": 504,
                        "ServerClosed": 503, "UnknownModel": 404}.get(
                            out["error_type"], 400)
                self._send(code, out)
            else:
                self._send(200, out)

        def log_message(self, fmt, *args) -> None:  # quiet by default
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_main(argv: List[str]) -> int:
    try:
        server, front = build_server(argv)
    except (ValueError, OSError, UnknownModel) as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 1
    silent = front.get("silent", "0") in ("1", "true")
    default_output = front.get("output", "value")
    try:
        if "http_port" in front:
            httpd = make_http_server(server, int(front["http_port"]),
                                     default_output)
            if not silent:
                print(f"serving on http://127.0.0.1:"
                      f"{httpd.server_address[1]}", file=sys.stderr)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()
        else:
            jsonl_loop(server, sys.stdin, sys.stdout, default_output)
    finally:
        server.close(drain=True)
        if not silent:
            print(json.dumps(server.metrics_snapshot()), file=sys.stderr)
    return 0
