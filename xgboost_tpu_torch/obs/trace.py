"""Low-overhead span tracing: ring-buffered host spans, named on the
device timeline too.

The port of the JAX package's ``obs/trace.py``. One process-wide
:class:`Tracer` records host spans (stage names such as ``paged/hist``
or ``serve/compute`` with their wall-clock start and end) into a ring
of fixed capacity, and opens a ``torch.profiler.record_function`` of
the same name for each, so the stage names show on a
``torch.profiler`` timeline beside the CUDA kernels they launch (the
JAX package pairs its spans with ``jax.profiler.TraceAnnotation``).
CUDA work is asynchronous: a span around kernel launches times their
launch, not their run, unless sync mode is armed (:func:`sync`), when
the drivers' spans wait for the device before they close.

Tracing is off by default and the disabled path is free: :func:`span`
returns one shared no-op context manager and allocates nothing
(``tests/test_torch_obs.py`` holds this to zero allocations).

Knobs, read at import (:func:`enable` / :func:`disable` switch at run
time):

- ``XTPU_TRACE``: ``1`` turns tracing on (default ``0``).
- ``XTPU_TRACE_BUF``: the ring's capacity in spans (default 65536); a
  full ring keeps the newest spans.
- ``XTPU_TRACE_OUT``: a path written at process exit; a ``.jsonl`` name
  writes one span a line, any other Chrome / Perfetto trace JSON (opens
  in ``ui.perfetto.dev``).
- ``XTPU_TRACE_SYNC``: ``1`` arms sync mode (:func:`set_sync`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "enable", "disable", "enabled", "tracer",
           "span", "instant", "export", "reset", "sync", "set_sync",
           "set_identity"]


class Span:
    """One finished span: ``[t0, t1)`` seconds on ``time.perf_counter``'s
    clock; ``depth``: its nesting level in the thread that recorded it."""

    __slots__ = ("name", "cat", "t0", "t1", "depth", "tid", "args")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 depth: int, tid: int, args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.depth = depth
        self.tid = tid
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "cat": self.cat, "t0": self.t0,
             "t1": self.t1, "dur": self.t1 - self.t0, "depth": self.depth,
             "tid": self.tid}
        if self.args:
            d["args"] = self.args
        return d


class _NullSpan:
    """The shared no-op context manager: the whole disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _LiveSpan:
    """The enabled path's context manager, one a ``with span(...)``."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0", "_ann")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._ann = None
        if self._tr.annotate_device:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        tl = self._tr._tl
        tl.depth = getattr(tl, "depth", 0) + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tl = self._tr._tl
        depth = getattr(tl, "depth", 1)
        tl.depth = depth - 1
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tr._record(Span(self.name, self.cat, self._t0, t1,
                              depth - 1, threading.get_ident(), self.args))
        return False


class Tracer:
    """A ring of :class:`Span` records of fixed capacity.
    ``annotate_device``: open a ``torch.profiler.record_function`` for
    each live span."""

    def __init__(self, capacity: int = 65536,
                 annotate_device: bool = True) -> None:
        self.capacity = max(int(capacity), 1)
        self.annotate_device = annotate_device
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._n = 0                        # spans ever recorded
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._epoch = time.perf_counter()  # the export's time base
        self.rank: Optional[int] = None    # distributed identity
        self.world: Optional[int] = None

    def set_identity(self, rank: int, world: int) -> None:
        """Tag this ring with its ``(rank, world)``: exported spans and
        Perfetto events carry it, so the rings of several ranks stay
        attributable once merged."""
        self.rank = int(rank)
        self.world = int(world)

    # -- recording ------------------------------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None) -> _LiveSpan:
        return _LiveSpan(self, name, cat, args)

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, Any]] = None) -> None:
        t = time.perf_counter()
        self._record(Span(name, cat, t, t, getattr(self._tl, "depth", 0),
                          threading.get_ident(), args))

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = sp
            self._n += 1

    # -- reading --------------------------------------------------------------
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        """Spans the ring overwrote (0 until it wraps)."""
        return max(self._n - self.capacity, 0)

    def spans(self) -> List[Span]:
        """The ring's spans, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return list(self._buf[:n])
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0
            self._epoch = time.perf_counter()

    # -- export ---------------------------------------------------------------
    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome / Perfetto trace-event JSON: ``ph: "X"`` complete
        events, microseconds from the tracer's epoch."""
        events = []
        pid = os.getpid()
        if self.rank is not None:
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"rank {self.rank}/"
                                            f"{self.world}"}})
        for s in self.spans():
            ev: Dict[str, Any] = {
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": (s.t0 - self._epoch) * 1e6,
                "dur": (s.t1 - s.t0) * 1e6,
            }
            if s.cat:
                ev["cat"] = s.cat
            if s.args:
                ev["args"] = dict(s.args)
            if self.rank is not None:
                ev.setdefault("args", {})["rank"] = self.rank
            events.append(ev)
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def dump(self, path: str) -> int:
        """Write the ring to ``path``: one span dict a line when the name
        ends in ``.jsonl``, Perfetto JSON otherwise. -> spans written."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as fh:
            if path.endswith(".jsonl"):
                for s in spans:
                    d = s.to_dict()
                    if self.rank is not None:
                        d["rank"], d["world"] = self.rank, self.world
                    fh.write(json.dumps(d) + "\n")
            else:
                json.dump(self.to_perfetto(), fh)
        return len(spans)


# ---- module state -------------------------------------------------------------

_tracer: Optional[Tracer] = None


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn tracing on (idempotent) -> the live tracer."""
    global _tracer
    if _tracer is None or (capacity is not None
                           and _tracer.capacity != int(capacity)):
        _tracer = Tracer(capacity if capacity is not None
                         else _default_capacity())
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, cat: str = "", args: Optional[Dict[str, Any]] = None):
    """The instrumentation entry point. Disabled: the shared no-op
    context manager (no allocation). Enabled: a host span, named on the
    profiler's timeline too."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat, args)


def instant(name: str, cat: str = "",
            args: Optional[Dict[str, Any]] = None) -> None:
    """A zero-length marker (a retry, a promotion)."""
    t = _tracer
    if t is not None:
        t.instant(name, cat, args)


def export(path: Optional[str] = None) -> int:
    """Write the ring (0 spans when tracing is off) to ``path``, else
    ``XTPU_TRACE_OUT``, else ``xtpu_trace.json``."""
    t = _tracer
    if t is None:
        return 0
    return t.dump(path or _OUT or "xtpu_trace.json")


def reset() -> None:
    """Empty the ring; tracing stays on or off as it was."""
    t = _tracer
    if t is not None:
        t.clear()


def set_identity(rank: int, world: int) -> None:
    """Tag the tracer (when on) with its distributed identity."""
    t = _tracer
    if t is not None:
        t.set_identity(rank, world)


_SYNC = os.environ.get("XTPU_TRACE_SYNC", "0") not in ("0", "")


def set_sync(on: bool) -> None:
    """Arm or disarm sync mode (:func:`sync`)."""
    global _SYNC
    _SYNC = bool(on)


def _cuda_devices(x, out: set) -> None:
    if hasattr(x, "is_cuda"):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)


def sync(x):
    """The measurement barrier: when tracing is on and sync mode is armed
    (``XTPU_TRACE_SYNC=1`` or :func:`set_sync`), wait until the current
    stream of each CUDA device that holds a tensor of ``x`` (a tensor, or
    a list, tuple or dict of them) has run its work, so the enclosing
    span times the stage and not its launch. -> ``x``; a pass-through
    otherwise, and for CPU tensors."""
    if _tracer is not None and _SYNC:
        devs: set = set()
        _cuda_devices(x, devs)
        if devs:
            import torch

            for d in devs:
                torch.cuda.current_stream(d).synchronize()
    return x


def _default_capacity() -> int:
    try:
        return int(os.environ.get("XTPU_TRACE_BUF", 65536))
    except ValueError:
        return 65536


_OUT = os.environ.get("XTPU_TRACE_OUT") or None

if os.environ.get("XTPU_TRACE", "0") not in ("0", ""):
    enable()
    if _OUT:
        import atexit

        atexit.register(export, _OUT)
