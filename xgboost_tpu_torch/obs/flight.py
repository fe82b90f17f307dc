"""The flight recorder: rank-merged timelines, clock alignment, overlap
arithmetic and crash forensics (the port of the JAX package's
``obs/flight.py``; the ring and bundle JSON are that package's schema,
``RING_KIND`` / ``BUNDLE_KIND`` at ``RING_VERSION``, so either package
reads the other's files).

- **Identity**: a :class:`FlightRecorder` binds a tracer ring
  (``obs/trace.py``) to a ``(rank, world)`` identity, taken from a
  communicator when one is given, so every exported span names its rank.
- **Clock alignment**: :func:`sync_clocks` runs a barrier-timestamp
  handshake through the communicator (K pings, each a barrier allgather
  and then an allgather of the ``perf_counter`` reading taken at release)
  and estimates each rank's clock offset against rank 0: the median over
  the pings, with half the spread as its uncertainty. The collectives run
  under ``parallel/resilience.py op_context("flight/clock-sync")``.
- **Merging**: :func:`merge_rings` turns N exported rings into one
  Perfetto timeline, a process track a rank, each ring's timestamps moved
  by its clock offset.
- **Overlap arithmetic**: :func:`hidden_fraction` /
  :func:`covered_seconds` are the one home of "how much of this transfer
  was hidden under compute"; ``data/binned.py``'s
  ``streaming_overlap`` goes through :func:`hidden_fraction`.
- **Black box**: :class:`BlackBox` writes the trace ring, a metrics
  snapshot, the device-memory watermarks (the CUDA allocator's on the
  card, ``obs/memory.py``), the hand kernels built so far and the rank
  as one bundle with a CRC sidecar; :func:`arm` installs the except /
  threading / faulthandler hooks so that any abnormal exit leaves one,
  and the pipeline's chaos harness writes one at every kill. Render with
  ``python -m xgboost_tpu_torch.obs postmortem <bundle>``.

Knobs (read at import):

- ``XTPU_FLIGHT``: ``1`` arms the global black box (default ``0``).
- ``XTPU_FLIGHT_DIR``: the bundles' directory (default ``xtpu_blackbox``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
import zlib
from typing import Any, Dict, IO, Iterable, List, Optional, Sequence, Tuple

from . import trace as _trace
from .metrics import get_registry

__all__ = [
    "FlightRecorder", "BlackBox", "StragglerWarning", "ClockSync",
    "sync_clocks", "hidden_fraction", "interval_union", "covered_seconds",
    "load_ring", "merge_rings", "arm", "disarm", "armed",
    "write_postmortem", "verify_bundle", "render_postmortem",
]

RING_KIND = "xtpuflight.ring"
BUNDLE_KIND = "xtpuflight.postmortem"
RING_VERSION = 1


class StragglerWarning(UserWarning):
    """One rank's time in a stage exceeds the cohort's mean by more than
    the skew threshold. Carries ``.stage``, ``.rank``, ``.skew_pct`` so that
    handlers can route the forensics."""

    def __init__(self, stage: str, rank: int, skew_pct: float,
                 threshold_pct: float):
        self.stage = stage
        self.rank = rank
        self.skew_pct = skew_pct
        self.threshold_pct = threshold_pct
        super().__init__(
            f"straggler: rank {rank} is {skew_pct:.1f}% over the cohort "
            f"mean in stage '{stage}' (threshold {threshold_pct:.1f}%)")


# -------------------------------------------------------------- overlap math
#
# The one overlap formula of the port: ``data/binned.py`` feeds it the page
# ring's (busy, exposed) seconds, and span-interval sums can be fed to
# covered_seconds the same way.

def hidden_fraction(total_s: float, exposed_s: float) -> Optional[float]:
    """Fraction of ``total_s`` busy seconds hidden under concurrent work,
    given ``exposed_s`` seconds that blocked the consumer. ``None`` until
    any busy time accumulates; clamped at 0 (bookkeeping skew can make
    ``exposed_s`` marginally exceed ``total_s``)."""
    if total_s <= 0:
        return None
    return max(0.0, 1.0 - exposed_s / total_s)


def interval_union(
        intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge ``[t0, t1)`` intervals into a sorted disjoint union."""
    ivs = sorted((float(a), float(b)) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered_seconds(targets: Iterable[Tuple[float, float]],
                    covers: Iterable[Tuple[float, float]]) -> float:
    """Seconds of ``targets`` overlapped by the union of ``covers``."""
    cov = interval_union(covers)
    total = 0.0
    for a, b in targets:
        if b <= a:
            continue
        for c, d in cov:
            if d <= a:
                continue
            if c >= b:
                break
            total += min(b, d) - max(a, c)
    return total


# ------------------------------------------------------------ clock alignment

class ClockSync:
    """Result of one barrier-timestamp handshake: this rank's clock offset
    against rank 0 (``local_time - offset ~= rank0_time``) and the
    min/max spread of the per-ping estimates as the uncertainty."""

    __slots__ = ("offset_s", "err_s", "pings")

    def __init__(self, offset_s: float, err_s: float, pings: int):
        self.offset_s = offset_s
        self.err_s = err_s
        self.pings = pings

    def to_dict(self) -> Dict[str, Any]:
        return {"offset_s": self.offset_s, "err_s": self.err_s,
                "pings": self.pings}


def sync_clocks(comm, pings: int = 8) -> ClockSync:
    """Estimate this rank's ``perf_counter`` offset against rank 0.

    Each ping is two collectives: a barrier allgather (so every rank is
    released at approximately the same instant), then an allgather of the
    ``perf_counter`` reading taken at release. Per ping the offset sample
    is ``t_local - t_rank0``; the release jitter is scheduling noise, so
    the median over ``pings`` samples is the estimate and the half spread
    is the recorded uncertainty. Ops are labeled ``flight/clock-sync``
    (they enter resilient integrity headers like any collective)."""
    world = comm.get_world_size()
    rank = comm.get_rank()
    if world <= 1:
        return ClockSync(0.0, 0.0, 0)
    from ..parallel.resilience import op_context

    samples: List[float] = []
    with op_context("flight/clock-sync"):
        for _ in range(max(int(pings), 1)):
            comm.allgather_objects(None)          # barrier: align release
            t_local = time.perf_counter()
            times = comm.allgather_objects(t_local)
            samples.append(float(t_local) - float(times[0]))
    samples.sort()
    n = len(samples)
    median = (samples[n // 2] if n % 2 == 1
              else 0.5 * (samples[n // 2 - 1] + samples[n // 2]))
    err = 0.5 * (samples[-1] - samples[0])
    if rank == 0:
        median = 0.0                              # rank 0 IS the reference
    return ClockSync(median, err, n)


# ------------------------------------------------------------ flight recorder

class FlightRecorder:
    """Bind a tracer ring to a rank identity for per-rank export.

    ``tracer=None`` uses the process-global tracer (the usual one-process-
    per-rank deployment). In-process multi-rank harnesses (the InMemory
    thread world) pass a private :class:`~.trace.Tracer` per rank, or call
    :meth:`adopt_current_thread` so export filters the shared ring down to
    this rank's recording threads."""

    def __init__(self, comm=None, tracer: Optional[_trace.Tracer] = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        self.comm = comm
        if rank is None:
            rank = comm.get_rank() if comm is not None else 0
        if world is None:
            world = comm.get_world_size() if comm is not None else 1
        self.rank = int(rank)
        self.world = int(world)
        self._tracer = tracer
        self._tids: set = set()
        self.clock = ClockSync(0.0, 0.0, 0)
        if tracer is not None:
            tracer.set_identity(self.rank, self.world)

    # -- recording ----------------------------------------------------------
    @property
    def tracer(self) -> Optional[_trace.Tracer]:
        return self._tracer if self._tracer is not None else _trace.tracer()

    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None):
        t = self.tracer
        return _trace._NULL if t is None else t.span(name, cat, args)

    def adopt_current_thread(self) -> None:
        """Attribute the calling thread's spans in the SHARED global ring
        to this rank (thread-world harnesses only)."""
        self._tids.add(threading.get_ident())

    def sync_clocks(self, pings: int = 8) -> ClockSync:
        if self.comm is None:
            raise ValueError("FlightRecorder needs a communicator to "
                             "sync clocks")
        self.clock = sync_clocks(self.comm, pings=pings)
        return self.clock

    # -- export -------------------------------------------------------------
    def spans(self) -> List[_trace.Span]:
        t = self.tracer
        if t is None:
            return []
        spans = t.spans()
        if self._tids and self._tracer is None:
            spans = [s for s in spans if s.tid in self._tids]
        return spans

    def ring_doc(self) -> Dict[str, Any]:
        t = self.tracer
        return {
            "kind": RING_KIND, "version": RING_VERSION,
            "rank": self.rank, "world": self.world,
            "clock": self.clock.to_dict(),
            "epoch": t._epoch if t is not None else 0.0,
            "dropped": t.dropped if t is not None else 0,
            "spans": [dict(s.to_dict(), rank=self.rank, world=self.world)
                      for s in self.spans()],
        }

    def export_ring(self, path: str) -> int:
        """Write this rank's ring (with identity + clock metadata) as one
        JSON document; returns the number of spans written."""
        doc = self.ring_doc()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        return len(doc["spans"])


def load_ring(path_or_doc) -> Dict[str, Any]:
    """Load one exported ring (path or already-parsed dict)."""
    if isinstance(path_or_doc, dict):
        doc = path_or_doc
    else:
        with open(path_or_doc, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    if doc.get("kind") != RING_KIND:
        raise ValueError(f"not an xtpuflight ring: kind={doc.get('kind')!r}")
    return doc


def merge_rings(rings: Sequence[Any], align: bool = True) -> Dict[str, Any]:
    """Merge N per-rank rings into ONE Perfetto trace: one process track
    per rank (``pid`` = rank, named ``rank r/w``), each ring's timestamps
    shifted by its clock offset so all tracks share rank 0's clock. The
    per-rank shift is constant, so within-track ordering is preserved."""
    docs = [load_ring(r) for r in rings]
    if not docs:
        return {"displayTimeUnit": "ms", "traceEvents": []}
    base = None
    aligned: List[Tuple[Dict[str, Any], float]] = []
    for doc in docs:
        off = float(doc.get("clock", {}).get("offset_s", 0.0)) if align \
            else 0.0
        for s in doc["spans"]:
            t0 = float(s["t0"]) - off
            if base is None or t0 < base:
                base = t0
        aligned.append((doc, off))
    base = base or 0.0
    events: List[Dict[str, Any]] = []
    for doc, off in aligned:
        rank, world = int(doc["rank"]), int(doc["world"])
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": f"rank {rank}/{world}"}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                       "args": {"sort_index": rank}})
        for s in doc["spans"]:
            ev: Dict[str, Any] = {
                "name": s["name"], "ph": "X", "pid": rank,
                "tid": s.get("tid", 0),
                "ts": (float(s["t0"]) - off - base) * 1e6,
                "dur": (float(s["t1"]) - float(s["t0"])) * 1e6,
            }
            if s.get("cat"):
                ev["cat"] = s["cat"]
            args = dict(s.get("args") or {})
            args["rank"] = rank
            ev["args"] = args
            events.append(ev)
    return {"displayTimeUnit": "ms", "traceEvents": events}


# ------------------------------------------------------------- crash forensics

def _program_fingerprints() -> Dict[str, str]:
    """``kernel -> built library`` for every hand kernel this process has
    loaded (``ops/cuda/build.py loaded()``; its source-hash target, or the
    host parser's). It reads what is loaded and starts no build: a crash
    dump must not compile mid-teardown."""
    out: Dict[str, str] = {}
    try:
        from ..ops.cuda import build

        for name in build.loaded():
            try:
                if name.startswith("host:"):
                    out[name] = str(build._host_target(name[5:]))
                else:
                    out[name] = str(build._target(name))
            except Exception:
                out[name] = "<unknown>"
    except Exception as e:  # pragma: no cover - partial interpreter teardown
        out["<error>"] = repr(e)
    return out


def _memory_section() -> Optional[Dict[str, Any]]:
    """The memory monitor's snapshot when ``XTPU_FLIGHT_MEM`` armed it,
    and on the card the CUDA allocator's counters of every device in use
    with its name; None on the CPU with no monitor."""
    from . import memory as _memory

    mon = _memory.monitor()
    out = None
    if mon is not None:
        mon.sample("postmortem")
        out = mon.snapshot()
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        devs = []
        for d in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(d)
            devs.append({
                "index": d, "name": torch.cuda.get_device_name(d),
                "live_bytes": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes": int(st.get("allocated_bytes.all.peak", 0))})
        if out is None:
            out = {"live_bytes": sum(v["live_bytes"] for v in devs),
                   "peak_bytes": sum(v["peak_bytes"] for v in devs),
                   "samples": 1, "source": "device"}
        out["devices"] = devs
    return out


class BlackBox:
    """Crash-forensics writer: everything needed to debug a dead rank,
    in one CRC-sidecar JSON bundle. Construction is free (no I/O); the
    directory is created on first :meth:`write`."""

    def __init__(self, directory: str, rank: int = 0,
                 world: Optional[int] = None,
                 recorder: Optional[FlightRecorder] = None):
        if recorder is not None:
            rank, world = recorder.rank, recorder.world
        self.directory = directory
        self.rank = int(rank)
        self.world = int(world) if world is not None else 1
        self.recorder = recorder
        self.last_bundle: Optional[str] = None
        self._seq = 0
        self._lock = threading.Lock()

    # -- bundle assembly ---------------------------------------------------
    def _bundle(self, reason: str, exc: Optional[BaseException],
                extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        b: Dict[str, Any] = {
            "kind": BUNDLE_KIND, "version": RING_VERSION,
            "reason": reason, "rank": self.rank, "world": self.world,
            "pid": os.getpid(), "time_unix": time.time(),
        }
        if exc is not None:
            b["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-16384:],
            }
        try:
            rec = self.recorder
            if rec is not None:
                b["trace"] = rec.ring_doc()
            else:
                t = _trace.tracer()
                b["trace"] = {
                    "kind": RING_KIND, "version": RING_VERSION,
                    "rank": self.rank, "world": self.world,
                    "clock": {"offset_s": 0.0, "err_s": 0.0, "pings": 0},
                    "epoch": t._epoch if t is not None else 0.0,
                    "dropped": t.dropped if t is not None else 0,
                    "spans": [dict(s.to_dict(), rank=self.rank,
                                   world=self.world)
                              for s in (t.spans() if t is not None else [])],
                }
        except Exception as e:  # pragma: no cover - must never block a dump
            b["trace"] = {"error": repr(e)}
        try:
            b["metrics"] = get_registry().snapshot()
        except Exception as e:  # pragma: no cover
            b["metrics"] = {"error": repr(e)}
        try:
            b["memory"] = _memory_section()
        except Exception as e:  # pragma: no cover
            b["memory"] = {"error": repr(e)}
        b["programs"] = _program_fingerprints()
        if extra:
            b["extra"] = extra
        return b

    def write(self, reason: str, exc: Optional[BaseException] = None,
              extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Assemble + atomically persist one bundle (data file, then CRC
        sidecar — the snapshot discipline). Returns the bundle path, or
        ``None`` if even best-effort persistence failed: a crash dump
        must never raise over the crash it is documenting."""
        try:
            from ..utils.checkpoint import _atomic_write, _crc_path

            with self._lock:
                self._seq += 1
                seq = self._seq
            os.makedirs(self.directory, exist_ok=True)
            payload = json.dumps(
                self._bundle(reason, exc, extra), default=repr,
                sort_keys=True).encode("utf-8")
            name = (f"postmortem_rank{self.rank}_{os.getpid()}"
                    f"_{seq:03d}.json")
            path = os.path.join(self.directory, name)
            _atomic_write(path, payload)
            _atomic_write(_crc_path(path),
                          f"{zlib.crc32(payload):08x} {len(payload)}\n"
                          .encode())
            self.last_bundle = path
            try:
                get_registry().inc(
                    "xtpu_postmortem_bundles_total",
                    help="crash-forensics bundles written by the "
                         "flight-recorder black box")
            except Exception:  # pragma: no cover
                pass
            return path
        except Exception:  # pragma: no cover - dump-of-last-resort failed
            return None


class BundleCorrupt(RuntimeError):
    """The postmortem bundle fails its CRC sidecar or does not parse."""


def verify_bundle(path: str) -> Dict[str, Any]:
    """CRC-verify + parse one bundle; raises :class:`BundleCorrupt` on any
    integrity failure (the same contract as snapshot loading)."""
    from ..utils.checkpoint import _crc_path

    try:
        with open(path, "rb") as fh:
            payload = fh.read()
    except OSError as e:
        raise BundleCorrupt(f"cannot read bundle {path}: {e}") from e
    try:
        with open(_crc_path(path)) as fh:
            want_crc, want_len = fh.read().split()
    except (OSError, ValueError) as e:
        raise BundleCorrupt(
            f"bundle {path} has no valid CRC sidecar") from e
    if len(payload) != int(want_len) \
            or f"{zlib.crc32(payload):08x}" != want_crc:
        raise BundleCorrupt(f"bundle {path} failed its CRC sidecar check")
    try:
        doc = json.loads(payload.decode("utf-8"))
    except ValueError as e:
        raise BundleCorrupt(f"bundle {path} does not parse: {e}") from e
    if doc.get("kind") != BUNDLE_KIND:
        raise BundleCorrupt(
            f"{path} is not a postmortem bundle (kind={doc.get('kind')!r})")
    return doc


def render_postmortem(path_or_doc, file: Optional[IO[str]] = None) -> None:
    """Human rendering of one bundle: header, exception, hottest spans,
    memory watermarks, metric keys, program fingerprints."""
    out = file or sys.stdout
    doc = path_or_doc if isinstance(path_or_doc, dict) \
        else verify_bundle(path_or_doc)
    w = out.write
    w(f"postmortem: {doc.get('reason', '?')}\n")
    w(f"  rank {doc.get('rank')}/{doc.get('world')}  pid {doc.get('pid')}"
      f"  time_unix {doc.get('time_unix'):.3f}\n")
    exc = doc.get("exception")
    if exc:
        w(f"  exception: {exc.get('type')}: {exc.get('message')}\n")
        tb = exc.get("traceback") or ""
        for line in tb.rstrip().splitlines()[-12:]:
            w(f"    {line}\n")
    mem = doc.get("memory")
    if mem:
        w(f"  memory: live={mem.get('live_bytes', 0)}"
          f" peak={mem.get('peak_bytes', 0)}"
          f" samples={mem.get('samples', 0)}"
          f" source={mem.get('source', '?')}\n")
        for d in mem.get("devices") or ():
            w(f"    cuda:{d.get('index')} {d.get('name')}:"
              f" live={d.get('live_bytes', 0)}"
              f" peak={d.get('peak_bytes', 0)}\n")
    tr = doc.get("trace") or {}
    spans = tr.get("spans") or []
    w(f"  trace: {len(spans)} spans in ring"
      f" (dropped {tr.get('dropped', 0)})\n")
    by_name: Dict[str, float] = {}
    for s in spans:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) \
            + (float(s["t1"]) - float(s["t0"]))
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        w(f"    {name:<32s} {dur * 1e3:10.3f} ms total\n")
    mets = doc.get("metrics") or {}
    if isinstance(mets, dict) and mets:
        w(f"  metrics: {len(mets)} samples\n")
    progs = doc.get("programs") or {}
    if progs:
        w(f"  programs: {len(progs)} kernels built\n")
        for name, src in sorted(progs.items())[:8]:
            w(f"    {name:<24s} {src}\n")


# --------------------------------------------------------------- global arming

_armed: Optional[BlackBox] = None
_prev_excepthook = None
_prev_threading_hook = None
_fault_log = None


def armed() -> Optional[BlackBox]:
    return _armed


def arm(directory: Optional[str] = None, rank: Optional[int] = None,
        world: Optional[int] = None,
        recorder: Optional[FlightRecorder] = None,
        install_hooks: bool = True) -> BlackBox:
    """Arm the global black box: any unhandled exception (main thread or
    worker), and any native fault (via ``faulthandler``), leaves a bundle
    in ``directory``. Idempotent; :func:`disarm` restores the hooks."""
    global _armed, _prev_excepthook, _prev_threading_hook, _fault_log
    if _armed is not None:
        return _armed
    directory = directory or os.environ.get("XTPU_FLIGHT_DIR") \
        or "xtpu_blackbox"
    box = BlackBox(directory, rank=rank or 0, world=world,
                   recorder=recorder)
    _armed = box
    if install_hooks:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        _prev_threading_hook = threading.excepthook
        threading.excepthook = _threading_hook
        try:
            import faulthandler

            os.makedirs(directory, exist_ok=True)
            _fault_log = open(
                os.path.join(directory,
                             f"fault_rank{box.rank}_{os.getpid()}.log"),
                "w")
            faulthandler.enable(file=_fault_log)
        except Exception:  # pragma: no cover - faulthandler unavailable
            _fault_log = None
    return box


def disarm() -> None:
    """Restore the pre-:func:`arm` hooks and drop the global black box."""
    global _armed, _prev_excepthook, _prev_threading_hook, _fault_log
    if _armed is None:
        return
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _prev_threading_hook is not None:
        threading.excepthook = _prev_threading_hook
        _prev_threading_hook = None
    if _fault_log is not None:
        try:
            import faulthandler

            faulthandler.disable()
            _fault_log.close()
        except Exception:  # pragma: no cover
            pass
        _fault_log = None
    _armed = None


def write_postmortem(reason: str, exc: Optional[BaseException] = None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Optional[str]:
    """Write a bundle through the armed global black box (no-op returning
    ``None`` when not armed)."""
    box = _armed
    if box is None:
        return None
    return box.write(reason, exc=exc, extra=extra)


def _excepthook(etype, value, tb) -> None:
    box = _armed
    if box is not None:
        if value is not None and value.__traceback__ is None:
            try:
                value = value.with_traceback(tb)
            except Exception:  # pragma: no cover
                pass
        box.write("unhandled-exception", exc=value)
    if _prev_excepthook is not None:
        _prev_excepthook(etype, value, tb)


def _threading_hook(hook_args) -> None:
    box = _armed
    if box is not None and hook_args.exc_type is not SystemExit:
        box.write(f"unhandled-thread-exception:{hook_args.thread.name}",
                  exc=hook_args.exc_value)
    if _prev_threading_hook is not None:
        _prev_threading_hook(hook_args)


if os.environ.get("XTPU_FLIGHT", "0") not in ("0", ""):
    arm()
