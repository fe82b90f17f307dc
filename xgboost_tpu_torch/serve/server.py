"""The serving engine: config, dispatch pipeline, latency accounting.

``Server`` wires the pieces together: requests enter through
``submit``/``predict``, the :class:`~.batcher.MicroBatcher` coalesces
them per model, and ``_dispatch`` runs the measured pipeline —
bucket-pad (host) -> H2D from a pinned buffer -> packed walk +
transform on the device -> D2H -> host slice back to per-request
results. Every device batch is padded to a :class:`~.buckets.BucketLadder`
shape, and ``warmup()`` runs each shape once: on the card that captures
each (model version, bucket)'s walk and transform as a CUDA graph over
a static input buffer (``serve/registry.py``), which every later batch
of the bucket replays. The :class:`~.buckets.RecompileCounter` counts
the captures; after warmup it stays flat, the
``recompiles_after_warmup`` SLO (0), and a swap's planned captures are
absorbed into its baseline.

On the card the results are BIT-IDENTICAL to ``Booster.predict()``: the
walk kernel sums each row in a fixed order that does not depend on the
batch, the transform is elementwise, and pad rows are sliced off on the
host.

``contribs`` answers SHAP values on the caller's thread over a ladder of
its own (``ServeConfig.shap_ladder``), with pinned staging buffers of
its own: device TreeSHAP (``ops/shap.py``, float64 torch ops) costs far
more a row than the walk, so it never takes the predict path's batch
slots. A swap keeps the displaced version built, so ``rollback_model``
restores it in one assignment; ``drain`` serves the backlog and stops.
With ``replica`` set (a fleet member) every exposed metric carries a
``replica`` label.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..context import resolve_device
from ..logging_utils import logger
from ..obs import memory as _mem
from ..obs import trace as _trace
from ..obs.metrics import Family, Sample, get_registry
from .batcher import MicroBatcher, PredictRequest
from .buckets import BucketLadder, RecompileCounter
from .errors import DeadlineExceeded, ServeError, ServerOverloaded
from .metrics import ServeMetrics
from .registry import ModelRegistry, ServedModel


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs.

    max_batch:       rows per device dispatch; also the ladder top.
    max_delay_ms:    longest a lone request waits for batch company.
    max_queue_rows:  admission bound; past it submits shed with
                     ServerOverloaded.
    timeout_ms:      default per-request deadline (None = no deadline).
    buckets:         explicit ladder sizes; default powers of two up to
                     ``max_batch`` (which is always the top).
    log_every_s:     > 0 logs a metrics line that often.
    shap_max_batch:  top bucket of the contribs ladder (device TreeSHAP
                     costs ~leaves x depth times the walk a row, so its
                     default top is smaller: min(128, max_batch)).
    shap_buckets:    explicit contribs ladder sizes.
    """

    max_batch: int = 512
    max_delay_ms: float = 2.0
    max_queue_rows: int = 8192
    timeout_ms: Optional[float] = None
    buckets: Optional[Sequence[int]] = None
    log_every_s: float = 0.0
    shap_max_batch: Optional[int] = None
    shap_buckets: Optional[Sequence[int]] = None

    def ladder(self) -> BucketLadder:
        if self.buckets is not None:
            lad = BucketLadder(self.buckets)
            if lad.max_batch < self.max_batch:
                lad = BucketLadder(lad.sizes + (self.max_batch,))
            return lad
        return BucketLadder.pow2(self.max_batch)

    def shap_ladder(self) -> BucketLadder:
        """The contribs route's own bucket ladder."""
        if self.shap_buckets is not None:
            return BucketLadder(self.shap_buckets)
        return BucketLadder.pow2(self.shap_max_batch
                                 or min(128, self.max_batch))


_UNSET = object()


class Server:
    """In-process inference server over a multi-model registry, on
    ``device`` (the card unless the caller asks for ``"cpu"``);
    ``replica`` names a fleet member in its metrics."""

    def __init__(self, models: Optional[Dict[str, object]] = None,
                 config: Optional[ServeConfig] = None,
                 device: str = "cuda", replica: Optional[str] = None,
                 **cfg_kw) -> None:
        self.device = resolve_device(device)     # raises without CUDA
        if config is None:
            config = ServeConfig(**cfg_kw)
        elif cfg_kw:
            config = dataclasses.replace(config, **cfg_kw)
        self.config = config
        self.ladder = config.ladder()
        self.shap_ladder = config.shap_ladder()
        self.replica = replica
        self.metrics = ServeMetrics(
            labels=(("replica", replica),) if replica else ())
        self.registry = ModelRegistry(self.device)
        self.recompile_counter = RecompileCounter.for_forest_predictor(
            self.registry)
        self._closed = False
        self._warmed = False
        self._next_log = (time.perf_counter() + config.log_every_s
                          if config.log_every_s > 0 else None)
        self._log_lock = threading.Lock()
        # staging buffers by (rows, width), pinned on the card so the H2D
        # copy is a DMA: the predict path's, and the contribs route's own.
        # Each lock keeps two threads (the batcher and a warmup, or two
        # contribs callers) from sharing a buffer.
        self._staging: Dict[Tuple[int, int], torch.Tensor] = {}
        self._stage_lock = threading.Lock()
        self._shap_staging: Dict[Tuple[int, int], torch.Tensor] = {}
        self._shap_stage_lock = threading.Lock()
        # a stream of this server's own: fleet replicas on one card wait
        # for their own batches, not for each other's
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.batcher = MicroBatcher(
            max_batch=self.ladder.max_batch,
            max_delay_s=config.max_delay_ms / 1e3,
            max_queue_rows=config.max_queue_rows,
            dispatch=self._dispatch,
            on_tick=self._maybe_log if self._next_log else None,
            on_expire=lambda n: self.metrics.inc("deadline_exceeded", n))
        get_registry().register(Server._collect_obs, owner=self)
        for name, src in (models or {}).items():
            self.load_model(name, src)

    def _collect_obs(self):
        """Registry collector for state that lives outside ServeMetrics:
        the recompile SLO gauge and the live queue depth."""
        lab = self.metrics.labels
        return [
            Family("xtpu_serve_recompiles_after_warmup", "gauge",
                   "serving captures made since warmup (SLO: 0)",
                   [Sample(self.recompiles_after_warmup
                           if self._warmed else 0, lab)]),
            Family("xtpu_serve_queue_rows", "gauge",
                   "rows currently queued in the micro-batcher",
                   [Sample(self.batcher.queue_depth_rows(), lab)]),
        ]

    # ------------------------------------------------------- model lifecycle
    def load_model(self, name: str, source, *, version: Optional[int] = None,
                   warm: bool = True) -> ServedModel:
        sm = self.registry.load(name, source, version=version)
        if warm and sm.n_features > 0:
            self._warm_model(sm)
        return sm

    def swap_model(self, name: str, source, *,
                   version: Optional[int] = None,
                   warm: bool = True) -> ServedModel:
        """Hot-swap: fully build and warm the incoming model while the old
        one keeps serving, then publish atomically. In-flight batches
        finish on whichever model they resolved."""
        sm = self.registry.prepare(name, source, version=version)
        if warm and sm.n_features > 0:
            self._warm_model(sm)
        self.registry.publish(sm)
        self.metrics.inc("swaps")
        return sm

    def rollback_model(self, name: str) -> ServedModel:
        """Restore the version the last swap displaced. It is still built
        and on the device, so the restore is one atomic registry
        assignment: in-flight batches finish on whichever version they
        resolved and no request fails."""
        sm = self.registry.rollback(name)
        self.metrics.inc("rollbacks")
        return sm

    def unload_model(self, name: str) -> None:
        self.registry.unload(name)
        self.metrics.inc("evictions")

    def warmup(self, model: Optional[str] = None,
               n_features: Optional[int] = None) -> int:
        """Capture every (bucket, model) program up front; marks the
        recompile baseline. Returns the number of warmup batches run."""
        targets = ([self.registry.get(model)] if model is not None
                   else self.registry.models())
        n = 0
        for sm in targets:
            if sm.n_features <= 0 and n_features:
                sm.n_features = int(n_features)
            n += self._warm_model(sm)
        self.mark_warm()
        return n

    def _warm_model(self, sm: ServedModel) -> int:
        c0 = self.recompile_counter.compiles()
        for size in self.ladder.sizes:
            self._run_padded(sm, sm.warm_batch(size), size, warm=True)
            self.metrics.inc("warmup_batches")
        if self._warmed:
            # a post-warmup (swap) warm captures on purpose; keep the
            # zero-recompile SLO about unplanned captures
            self.recompile_counter.absorb(
                self.recompile_counter.compiles() - c0)
        return len(self.ladder.sizes)

    def mark_warm(self) -> None:
        """Snapshot the captures: everything after this counts as a
        post-warmup recompile (the zero-recompile SLO); reports this
        server warm (``health_snapshot``'s ``warmed``)."""
        self.recompile_counter.mark()
        self._warmed = True

    @property
    def recompiles_after_warmup(self) -> int:
        return self.recompile_counter.since_mark()

    # ------------------------------------------------------------- requests
    def submit(self, data, model: Optional[str] = None, *,
               output: str = "value",
               timeout_ms: object = _UNSET) -> Future:
        """Enqueue one predict request; returns a Future resolving to the
        predictions (or raising a typed ServeError)."""
        if output not in ("value", "margin"):
            raise ValueError(f"output must be 'value' or 'margin', "
                             f"got {output!r}")
        X = np.ascontiguousarray(np.asarray(data, np.float32))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(f"expected [rows, features] with rows >= 1, "
                             f"got shape {X.shape}")
        sm = self.registry.get(model)          # fail unknown model fast
        if X.shape[1] < sm.min_columns:
            raise ValueError(
                f"model {sm.key()} needs {sm.min_columns} feature columns, "
                f"the request has {X.shape[1]}")
        t_ms = (self.config.timeout_ms if timeout_ms is _UNSET
                else timeout_ms)
        deadline = (time.perf_counter() + float(t_ms) / 1e3
                    if t_ms is not None else None)
        req = PredictRequest(X, sm.name, output, deadline)
        self.metrics.inc("requests")
        self.metrics.inc("rows", X.shape[0])
        try:
            return self.batcher.submit(req)
        except ServerOverloaded:
            self.metrics.inc("sheds")
            raise

    def predict(self, data, model: Optional[str] = None, *,
                output: str = "value",
                timeout_ms: object = _UNSET) -> np.ndarray:
        return self.submit(data, model, output=output,
                           timeout_ms=timeout_ms).result()

    # ------------------------------------------------------------- contribs
    def contribs(self, data, model: Optional[str] = None, *,
                 timeout_ms: object = _UNSET) -> np.ndarray:
        """Device TreeSHAP: per-feature attributions ``[rows, F+1]``
        (``[rows, groups, F+1]`` with several groups), the last column
        the bias; equal to ``Booster.predict(pred_contribs=True)`` and
        each row sums to its margin.

        Synchronous (no micro-batching): contribs traffic is sparse and
        far heavier a row than the walk, so it runs on the caller's
        thread over its own bucket ladder and staging buffers — it never
        competes with the predict path for batch slots, only for the
        device."""
        t_start = time.perf_counter()
        X = np.ascontiguousarray(np.asarray(data, np.float32))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(f"expected [rows, features] with rows >= 1, "
                             f"got shape {X.shape}")
        sm = self.registry.get(model)
        if not sm.supports_contribs:
            raise ServeError(
                f"model {sm.key()} has no packed forest; device contribs "
                "need the packed walk's scalar trees")
        if X.shape[1] < sm.min_columns:
            raise ValueError(
                f"model {sm.key()} needs {sm.min_columns} feature columns, "
                f"the request has {X.shape[1]}")
        t_ms = (self.config.timeout_ms if timeout_ms is _UNSET
                else timeout_ms)
        deadline = (t_start + float(t_ms) / 1e3
                    if t_ms is not None else None)
        self.metrics.inc("contrib_requests")
        self.metrics.inc("contrib_rows", X.shape[0])
        n = X.shape[0]
        try:
            outs = []
            off = 0
            with _trace.span("serve/contribs", args={"rows": n}):
                for size in self.shap_ladder.chunks(n):
                    if deadline is not None \
                            and time.perf_counter() > deadline:
                        self.metrics.inc("deadline_exceeded")
                        raise DeadlineExceeded(
                            f"contribs deadline of {t_ms}ms exceeded "
                            f"after {off}/{n} rows")
                    bucket = self.shap_ladder.bucket_for(size)
                    outs.append(self._run_contribs_padded(
                        sm, X[off:off + size], bucket)[:size])
                    off += size
        except BaseException:
            self.metrics.inc("errors")
            raise
        phi = np.concatenate(outs) if len(outs) > 1 else outs[0]
        if phi.shape[1] == 1:
            phi = phi[:, 0, :]   # Booster.predict's binary shape
        self.metrics.observe("shap", time.perf_counter() - t_start)
        self.metrics.observe("e2e", time.perf_counter() - t_start)
        return _ServedResult(phi.astype(np.float32), sm.name, sm.version)

    def _run_contribs_padded(self, sm: ServedModel, X: np.ndarray,
                             bucket: int, warm: bool = False) -> np.ndarray:
        """pad -> H2D -> device TreeSHAP -> D2H on one shap bucket;
        returns the f64 values [bucket, G, F + 1]."""
        with self._shap_stage_lock, self._on_stream():
            t0 = time.perf_counter()
            Xp = self.shap_ladder.pad(X, bucket)
            t1 = time.perf_counter()
            xd = self._stage(Xp, self._shap_staging)
            self._sync()
            t2 = time.perf_counter()
            phi_d = sm.contribs_padded(xd)
            self._sync()
            t3 = time.perf_counter()
            phi = phi_d.cpu().numpy()
            t4 = time.perf_counter()
        if not warm:
            self.metrics.observe("pad", t1 - t0)
            self.metrics.observe("h2d", t2 - t1)
            self.metrics.observe("compute", t3 - t2)
            self.metrics.observe("d2h", t4 - t3)
        return phi

    def warmup_contribs(self, model: Optional[str] = None) -> int:
        """Run every (shap bucket, model) shape once up front (the path
        tables are built by the first); skips models without a packed
        forest. Returns the number of warmup batches run; their
        preparations are planned (absorbed once the server is warm)."""
        targets = ([self.registry.get(model)] if model is not None
                   else self.registry.models())
        n = 0
        c0 = self.recompile_counter.compiles()
        for sm in targets:
            if not sm.supports_contribs or sm.n_features <= 0:
                continue
            for size in self.shap_ladder.sizes:
                self._run_contribs_padded(sm, sm.warm_batch(size), size,
                                          warm=True)
                self.metrics.inc("warmup_batches")
                n += 1
        if self._warmed:
            self.recompile_counter.absorb(
                self.recompile_counter.compiles() - c0)
        return n

    # ------------------------------------------------------------- pipeline
    def _on_stream(self):
        """Run what follows on this server's stream, after the work the
        default stream holds (a model's upload by ``load_model`` or
        ``swap_model``)."""
        if self._stream is None:
            return contextlib.nullcontext()
        self._stream.wait_stream(torch.cuda.default_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _pinned(self, Xp: np.ndarray,
                staging: Dict[Tuple[int, int], torch.Tensor]
                ) -> torch.Tensor:
        """The padded batch in a pinned host buffer of ``staging`` on the
        card (so its H2D copy is a DMA), the array itself on the CPU."""
        if self.device.type != "cuda":
            return torch.from_numpy(Xp)
        key = Xp.shape
        buf = staging.get(key)
        if buf is None:
            buf = torch.empty(key, dtype=torch.float32, pin_memory=True)
            staging[key] = buf
        buf.numpy()[...] = Xp
        return buf

    def _stage(self, Xp: np.ndarray,
               staging: Dict[Tuple[int, int], torch.Tensor]) -> torch.Tensor:
        """The padded batch on the device: a copy from a pinned host
        buffer of ``staging`` on the card, the array itself on the
        CPU."""
        return self._pinned(Xp, staging).to(self.device, non_blocking=True)

    def _run_padded(self, sm: ServedModel, X: np.ndarray, bucket: int,
                    warm: bool = False):
        """pad -> H2D -> compute -> D2H on one bucket; returns
        (values [R, G], margins [R, G]) host arrays and records stage
        latencies (skipped for warmup batches)."""
        with self._stage_lock, self._on_stream():
            t0 = time.perf_counter()
            with _trace.span("serve/pad"):
                Xp = self.ladder.pad(X, bucket)
            t1 = time.perf_counter()
            with _trace.span("serve/h2d"):
                # into the bucket's static buffer, which its graph reads
                bucket_prog = sm.stage_bucket(
                    self._pinned(Xp, self._staging))
                self._sync()
            t2 = time.perf_counter()
            with _trace.span("serve/compute"):
                margin_d, value_d = sm.run_bucket(bucket_prog)
                self._sync()
            t3 = time.perf_counter()
            with _trace.span("serve/d2h"):
                margin = margin_d.cpu().numpy()
                value = value_d.cpu().numpy()
            t4 = time.perf_counter()
        if not warm:
            self.metrics.observe("pad", t1 - t0)
            self.metrics.observe("h2d", t2 - t1)
            self.metrics.observe("compute", t3 - t2)
            self.metrics.observe("d2h", t4 - t3)
            self.metrics.hit_bucket(bucket, bucket - X.shape[0])
        return value, margin

    def _dispatch(self, model_name: str, batch: List[PredictRequest]) -> None:
        """Batcher callback: resolve the model NOW (hot swap takes effect
        at batch granularity), run per-ladder chunks, slice results back
        to request futures."""
        t_form = time.perf_counter()
        for r in batch:
            self.metrics.observe("queue", t_form - r.t_submit)
        try:
            sm = self.registry.get(model_name)
        except ServeError as exc:
            for r in batch:
                r.future.set_exception(exc)
            self.metrics.inc("errors", len(batch))
            return
        rows = np.concatenate([r.X for r in batch]) if len(batch) > 1 \
            else batch[0].X
        n = rows.shape[0]
        try:
            values, margins = [], []
            off = 0
            with _trace.span("serve/batch", args={"rows": n}):
                for size in self.ladder.chunks(n):
                    bucket = self.ladder.bucket_for(size)
                    v, m = self._run_padded(sm, rows[off:off + size],
                                            bucket)
                    values.append(v[:size])
                    margins.append(m[:size])
                    off += size
            _mem.sample("serve/batch")   # the batch's boundary
            value = np.concatenate(values) if len(values) > 1 else values[0]
            margin = (np.concatenate(margins) if len(margins) > 1
                      else margins[0])
            self.metrics.inc("batches")
        except Exception as exc:  # fail the futures, keep the worker
            self.metrics.inc("errors", len(batch))
            for r in batch:
                r.future.set_exception(exc)
            return
        t_done = time.perf_counter()
        off = 0
        for r in batch:
            out = (margin if r.output == "margin" else value)
            res = np.array(out[off:off + r.rows])  # copy: drop batch ref
            if res.ndim == 2 and res.shape[1] == 1:
                res = res[:, 0]  # match Booster.predict non-strict shape
            r.future.set_result(_ServedResult(res, sm.name, sm.version))
            self.metrics.observe("e2e", t_done - r.t_submit)
            off += r.rows

    # ---------------------------------------------------------- maintenance
    def _maybe_log(self) -> None:
        if self._next_log is None:
            return
        with self._log_lock:
            now = time.perf_counter()
            if now < self._next_log:
                return
            self._next_log = now + self.config.log_every_s
        self.metrics.set("recompiles", self.recompiles_after_warmup)
        logger.info(self.metrics.report_line(
            {"queue_rows": self.batcher.queue_depth_rows(),
             "models": len(self.registry.models())}))

    def health_snapshot(self) -> Dict[str, object]:
        """The ``/healthz`` payload: liveness plus served versions, queue
        depth and the shed / deadline / error counters (one locked cut of
        them)."""
        c = self.metrics.get_many(("requests", "sheds", "deadline_exceeded",
                                   "errors", "swaps", "rollbacks"))
        return {
            "status": "closed" if self._closed else "ok",
            "replica": self.replica,
            "device": str(self.device),
            "warmed": self._warmed,
            "models": [{"name": m.name, "version": m.version}
                       for m in self.registry.models()],
            "queue_rows": self.batcher.queue_depth_rows(),
            **{k: int(v) for k, v in c.items()},
        }

    def metrics_snapshot(self) -> Dict[str, object]:
        snap = self.metrics.snapshot()
        snap["recompiles_after_warmup"] = (
            self.recompiles_after_warmup if self._warmed else None)
        snap["queue_rows"] = self.batcher.queue_depth_rows()
        snap["models"] = self.registry.describe()
        snap["buckets"] = list(self.ladder.sizes)
        return snap

    def drain(self) -> None:
        """Serve the backlog, then stop accepting and dispatching."""
        self.close(drain=True)

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        self.batcher.close(drain=drain)
        self._closed = True

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)


class _ServedResult(np.ndarray):
    """Prediction array annotated with the serving model identity
    (``.model``/``.version``) — a plain ndarray everywhere else."""

    def __new__(cls, arr: np.ndarray, model: str, version: int):
        obj = np.asarray(arr).view(cls)
        obj.model = model
        obj.version = version
        return obj

    def __array_finalize__(self, obj) -> None:
        if obj is not None:
            self.model = getattr(obj, "model", None)
            self.version = getattr(obj, "version", None)
