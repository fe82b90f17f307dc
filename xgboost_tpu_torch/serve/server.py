"""The serving engine: config, dispatch pipeline, latency accounting.

``Server`` wires the pieces together: requests enter through
``submit``/``predict``, the :class:`~.batcher.MicroBatcher` coalesces
them per model, and ``_dispatch`` runs the measured pipeline —
bucket-pad (host) -> H2D from a pinned buffer -> packed walk +
transform on the device -> D2H -> host slice back to per-request
results. Every device batch is padded to a :class:`~.buckets.BucketLadder`
shape, and ``warmup()`` runs each shape once.

On the card the results are BIT-IDENTICAL to ``Booster.predict()``: the
walk kernel sums each row in a fixed order that does not depend on the
batch, the transform is elementwise, and pad rows are sliced off on the
host.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..context import resolve_device
from .batcher import MicroBatcher, PredictRequest
from .buckets import BucketLadder
from .errors import ServeError, ServerOverloaded
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

    Device batches are padded to powers of two up to ``max_batch``.
    """

    max_batch: int = 512
    max_delay_ms: float = 2.0
    max_queue_rows: int = 8192
    timeout_ms: Optional[float] = None


_UNSET = object()


class Server:
    """In-process inference server over a multi-model registry, on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""

    def __init__(self, models: Optional[Dict[str, object]] = None,
                 config: Optional[ServeConfig] = None,
                 device: str = "cuda", **cfg_kw) -> None:
        self.device = resolve_device(device)     # raises without CUDA
        if config is None:
            config = ServeConfig(**cfg_kw)
        elif cfg_kw:
            config = dataclasses.replace(config, **cfg_kw)
        self.config = config
        self.ladder = BucketLadder.pow2(config.max_batch)
        self.metrics = ServeMetrics()
        self.registry = ModelRegistry(self.device)
        self._closed = False
        self._warmed = False
        # one staging buffer per (bucket, width); pinned on the card so
        # the H2D copy is a DMA. The lock keeps a warmup on the caller's
        # thread from sharing a buffer with the batcher's dispatch.
        self._staging: Dict[Tuple[int, int], torch.Tensor] = {}
        self._stage_lock = threading.Lock()
        self.batcher = MicroBatcher(
            max_batch=self.ladder.max_batch,
            max_delay_s=config.max_delay_ms / 1e3,
            max_queue_rows=config.max_queue_rows,
            dispatch=self._dispatch,
            on_expire=lambda n: self.metrics.inc("deadline_exceeded", n))
        for name, src in (models or {}).items():
            self.load_model(name, src)

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

    def warmup(self, model: Optional[str] = None,
               n_features: Optional[int] = None) -> int:
        """Run every (bucket, model) shape once up front. Returns the
        number of warmup batches run."""
        targets = ([self.registry.get(model)] if model is not None
                   else self.registry.models())
        n = 0
        for sm in targets:
            if sm.n_features <= 0 and n_features:
                sm.n_features = int(n_features)
            n += self._warm_model(sm)
        self._warmed = True
        return n

    def _warm_model(self, sm: ServedModel) -> int:
        for size in self.ladder.sizes:
            self._run_padded(sm, sm.warm_batch(size), size, warm=True)
            self.metrics.inc("warmup_batches")
        return len(self.ladder.sizes)

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

    # ------------------------------------------------------------- pipeline
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, Xp: np.ndarray) -> torch.Tensor:
        """The padded batch on the device: a copy from a pinned host
        buffer on the card, the array itself on the CPU."""
        if self.device.type != "cuda":
            return torch.from_numpy(Xp)
        key = Xp.shape
        buf = self._staging.get(key)
        if buf is None:
            buf = torch.empty(key, dtype=torch.float32, pin_memory=True)
            self._staging[key] = buf
        buf.numpy()[...] = Xp
        return buf.to(self.device, non_blocking=True)

    def _run_padded(self, sm: ServedModel, X: np.ndarray, bucket: int,
                    warm: bool = False):
        """pad -> H2D -> compute -> D2H on one bucket; returns
        (values [R, G], margins [R, G]) host arrays and records stage
        latencies (skipped for warmup batches)."""
        with self._stage_lock:
            t0 = time.perf_counter()
            Xp = self.ladder.pad(X, bucket)
            t1 = time.perf_counter()
            xd = self._stage(Xp)
            self._sync()
            t2 = time.perf_counter()
            margin_d = sm.margin_padded(xd)
            value_d = sm.transform(margin_d)
            self._sync()
            t3 = time.perf_counter()
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
            for size in self.ladder.chunks(n):
                bucket = self.ladder.bucket_for(size)
                v, m = self._run_padded(sm, rows[off:off + size], bucket)
                values.append(v[:size])
                margins.append(m[:size])
                off += size
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
    def health_snapshot(self) -> Dict[str, object]:
        """Liveness plus served versions, queue depth and the shed /
        deadline / error counters."""
        c = self.metrics.get_many(("requests", "sheds", "deadline_exceeded",
                                   "errors", "swaps"))
        return {
            "status": "closed" if self._closed else "ok",
            "device": str(self.device),
            "warmed": self._warmed,
            "models": [{"name": m.name, "version": m.version}
                       for m in self.registry.models()],
            "queue_rows": self.batcher.queue_depth_rows(),
            **{k: int(v) for k, v in c.items()},
        }

    def metrics_snapshot(self) -> Dict[str, object]:
        snap = self.metrics.snapshot()
        snap["queue_rows"] = self.batcher.queue_depth_rows()
        snap["models"] = self.registry.describe()
        snap["buckets"] = list(self.ladder.sizes)
        return snap

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
