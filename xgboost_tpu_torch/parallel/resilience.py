"""Resilient host collectives: retry/backoff, desync + corruption
detection, fault-injection schedules, and distributed checkpoint
agreement.

The port of the JAX package's ``parallel/resilience.py``. The reference's
rabit engine made every allreduce fault-tolerant: a worker that died
mid-iteration rejoined and the world recovered from the last
``CheckPoint`` (``rabit/include/rabit/rabit.h``, ``allreduce_robust.cc``).
The host-side collectives (``parallel/collective.py``) are fail-fast;
this module restores the robustness half of that contract:

- :class:`ResilientCommunicator` wraps any :class:`Communicator` and gives
  every ``allreduce``/``allgather``/``broadcast`` bounded retries with
  exponential backoff + deterministic jitter, optional per-op timeouts, and
  IN-BAND integrity checks: each op carries a sequence-number/op-kind header
  so two ranks whose collective schedules have drifted apart raise a typed
  :class:`CollectiveDesync` instead of hanging or silently summing
  mismatched buffers, and reduction payloads carry a control sum that turns
  transport corruption into a typed :class:`CollectiveCorruption`.
- :class:`FaultPlan` / :class:`FaultyCommunicator` generalise the one-shot
  ``FaultInjectionCommunicator`` (the reference's ``allreduce_mock.h``
  counterpart): fail-once at op *n* (optionally within round *k*), seeded
  flaky-probability failures, latency injection, and payload corruption.
- :func:`agree_round` is the distributed-recovery handshake: after a
  fault every surviving rank proposes the newest snapshot round it holds and
  the world resumes from the MINIMUM, the last *collectively agreed* state
  (reference ``LoadCheckPoint`` returns the globally committed version).

:class:`RetryPolicy` is shared with the serving client
(``serve/client.py``), which retries a shed request under it.

Design note: why headers are in-band. A separate header allgather before
each payload op deadlocks retry on barrier-based communicators: a rank
retrying from the header step would meet peers waiting in the payload
step and exchange mismatched buffers. Instead the header is piggybacked
INSIDE the payload (two control elements appended to reductions, a
``(header, crc, obj)`` wrapper on gathers), so every collective stays
exactly one inner op and a pre-op transient failure can be retried by
one rank alone without desynchronising the group. The gathers' CRC is
over the object's wire encoding (``parallel/wire.py``), as the JAX
package's; an object the codec refuses goes without one.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..logging_utils import logger
from ..obs import trace as _trace
from . import wire
from .collective import Communicator, get_communicator


# --------------------------------------------------------------- typed errors

class CollectiveError(RuntimeError):
    """Base class of every resilient-collective failure.

    The resilient wrapper attaches structured forensics before raising:
    ``rank`` (the local rank that detected the failure), ``label`` (the
    :class:`op_context` call-site label), ``seq`` (collective sequence
    number) and ``peer`` (the remote rank a gather implicated, when
    known): so handlers and the flight recorder's postmortem bundles
    name the offending rank without parsing the message."""

    rank: Optional[int] = None
    label: Optional[str] = None
    seq: Optional[int] = None
    peer: Optional[int] = None


class TransientCollectiveError(CollectiveError):
    """A retryable transport failure (the resilient wrapper backs off and
    retries these up to ``RetryPolicy.max_retries`` times)."""


class CollectiveFault(CollectiveError):
    """A non-retryable injected/permanent fault: the round must be aborted
    and the world recovered from the last agreed snapshot."""


class CollectiveTimeout(CollectiveError):
    """The inner collective did not complete within ``RetryPolicy.timeout_s``
    (a hung peer surfaces here instead of blocking forever)."""


class CollectiveDesync(CollectiveError):
    """Ranks disagree on the collective schedule (sequence number, op kind,
    payload shape/dtype, or op label): continuing would silently reduce
    mismatched buffers."""


class CollectiveCorruption(CollectiveError):
    """Payload integrity check failed (control sum / per-rank CRC mismatch):
    the transport delivered corrupted bytes."""


#: errors the resilient wrapper treats as retryable
RETRYABLE_ERRORS = (TransientCollectiveError, ConnectionError, BrokenPipeError)


# ---------------------------------------------------------------- retry policy

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule with exponential backoff + deterministic
    jitter (seeded so multi-rank tests replay identically).
    ``timeout_s``: the resilient collectives' per-op timeout (None:
    none); ``retry_timeouts``: retry an op that timed out."""

    max_retries: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    jitter: float = 0.5           # fraction of the delay randomized
    timeout_s: Optional[float] = None
    retry_timeouts: bool = False  # a timed-out peer is usually gone for good

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())


# ------------------------------------------------------------------ op context

_op_ctx = threading.local()


class op_context:
    """Label the collectives issued inside the block (``with
    op_context("paged/hist"): ...``). The label enters the integrity header,
    so a desync between two *call sites* (one rank in the paged histogram
    allreduce, another in the sketch merge) is reported by name."""

    def __init__(self, label: str) -> None:
        self.label = label

    def __enter__(self) -> "op_context":
        self._prev = getattr(_op_ctx, "label", "")
        _op_ctx.label = self.label
        return self

    def __exit__(self, *exc: Any) -> None:
        _op_ctx.label = self._prev


def current_op_label() -> str:
    return getattr(_op_ctx, "label", "")


# --------------------------------------------------------- resilient wrapper

def _small_hash(*parts: Any) -> int:
    """crc32 folded to 20 bits: exactly representable in float32 (< 2^24)
    so the control element survives any payload dtype's reduction."""
    return zlib.crc32("|".join(str(p) for p in parts).encode()) & 0xFFFFF


class ResilientCommunicator(Communicator):
    """Retry/backoff + desync/corruption detection around any communicator.

    Integrity checks are IN-BAND (see module docstring): reductions on
    float payloads append ``[header_hash, control]`` elements: under
    ``sum`` the reduced hash must equal ``world * h`` and the reduced
    control must match the payload's own sum (corruption check); under
    ``max``/``min`` the pair ``[h, -h]`` reduces back to ``[h, -h]`` iff
    every rank agrees. Gathers wrap each object as ``(header, crc, obj)``
    and verify every slot. Integer reductions skip the checks (a folded
    hash would overflow narrow dtypes): shape/dtype desync there still
    surfaces as the inner communicator's stack error.
    """

    def __init__(self, inner: Communicator,
                 policy: Optional[RetryPolicy] = None,
                 verify: bool = True,
                 on_retry: Optional[Callable[[str, int, BaseException],
                                             None]] = None) -> None:
        self._inner = inner
        self.policy = policy or RetryPolicy()
        self.verify = verify
        self._on_retry = on_retry
        self._seq = 0
        self._rng = random.Random(0xC0FFEE ^ inner.get_rank())
        self.stats: Dict[str, int] = {"ops": 0, "retries": 0, "desyncs": 0,
                                      "corruptions": 0, "timeouts": 0}
        from ..obs.metrics import get_registry

        get_registry().register(ResilientCommunicator._collect_obs,
                                owner=self)

    def _collect_obs(self):
        """Registry collector: the stats dict as labeled counters, so a
        serve-process scrape shows collective retry/desync rates."""
        from ..obs.metrics import Family, Sample

        return [Family(
            "xtpu_collective_events_total", "counter",
            "resilient-collective events by kind "
            "(ops/retries/desyncs/corruptions/timeouts)",
            [Sample(v, (("kind", k),))
             for k, v in sorted(self.stats.items())])]

    # -- topology ------------------------------------------------------------
    def get_rank(self) -> int:
        return self._inner.get_rank()

    def get_world_size(self) -> int:
        return self._inner.get_world_size()

    def on_round(self, iteration: int) -> None:
        cb = getattr(self._inner, "on_round", None)
        if cb is not None:
            cb(iteration)

    # -- machinery -----------------------------------------------------------
    def _with_timeout(self, fn: Callable[[], Any], what: str) -> Any:
        t = self.policy.timeout_s
        if t is None:
            return fn()
        box: List[Any] = []
        err: List[BaseException] = []

        def run() -> None:
            try:
                box.append(fn())
            except BaseException as e:  # noqa: BLE001 - reraised below
                err.append(e)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(t)
        if th.is_alive():
            self.stats["timeouts"] += 1
            raise CollectiveTimeout(
                f"{what} did not complete within {t:.3f}s "
                f"(rank {self.get_rank()})")
        if err:
            raise err[0]
        return box[0]

    def _attempts(self, fn: Callable[[], Any], what: str) -> Any:
        pol = self.policy
        attempt = 0
        label = current_op_label()
        while True:
            try:
                with _trace.span("collective/" + (label or "op"),
                                 "collective",
                                 {"what": what, "attempt": attempt}
                                 if _trace.enabled() else None):
                    return self._with_timeout(fn, what)
            except RETRYABLE_ERRORS as e:
                retryable = True
                err = e
            except CollectiveTimeout as e:
                retryable = pol.retry_timeouts
                err = e
            if not retryable or attempt >= pol.max_retries:
                raise err
            delay = pol.delay(attempt, self._rng)
            self.stats["retries"] += 1
            _trace.instant("collective/retry", "collective",
                           {"what": what, "attempt": attempt,
                            "delay_ms": round(delay * 1e3, 3)})
            if self._on_retry is not None:
                self._on_retry(what, attempt, err)
            logger.warning("collective %s failed (%s); retry %d/%d in %.0f ms",
                           what, err, attempt + 1, pol.max_retries,
                           delay * 1e3)
            time.sleep(delay)
            attempt += 1

    def _header(self, kind: str, shape: tuple, dtype: str) -> tuple:
        return (self._seq, kind, tuple(int(s) for s in shape), str(dtype),
                current_op_label())

    def _forensics(self, err: CollectiveError, seq: int,
                   peer: Optional[int] = None) -> CollectiveError:
        """Attach structured rank/op forensics (the header itself must
        stay rank-symmetric: the sum-reduced hash check needs every
        rank to contribute the identical tuple: so the local rank id
        travels on the exception, not in band)."""
        err.rank = self.get_rank()
        err.label = current_op_label()
        err.seq = seq
        err.peer = peer
        return err

    # -- collectives ---------------------------------------------------------
    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        arr = np.asarray(values)
        seq = self._seq
        self._seq += 1
        self.stats["ops"] += 1
        kind = f"allreduce:{op}"
        what = f"{kind}#{seq}" + (f" [{current_op_label()}]"
                                  if current_op_label() else "")
        checked = (self.verify and arr.dtype.kind == "f"
                   and op in ("sum", "max", "min"))
        if not checked:
            return self._attempts(
                lambda: self._inner.allreduce(arr, op=op), what)
        h = float(_small_hash(seq, kind, arr.shape, arr.dtype,
                              current_op_label()))
        flat = arr.ravel()
        if op == "sum":
            ctrl = np.asarray([h, float(flat.sum(dtype=np.float64))],
                              arr.dtype)
        else:  # max/min: the [h, -h] pair reduces to itself iff all agree
            ctrl = np.asarray([h, -h], arr.dtype)
        sent = np.concatenate([flat, ctrl])
        out = np.asarray(self._attempts(
            lambda: self._inner.allreduce(sent, op=op), what))
        payload, rh, rc = out[:-2], float(out[-2]), float(out[-1])
        world = self.get_world_size()
        if op == "sum":
            if rh != h * world:
                self.stats["desyncs"] += 1
                raise self._forensics(CollectiveDesync(
                    f"{what}: rank {self.get_rank()} header hash mismatch "
                    f"(got {rh}, want {h * world}); ranks disagree on the "
                    "collective schedule (sequence/op-kind/shape/dtype)"),
                    seq)
            expect = float(payload.sum(dtype=np.float64))
            scale = float(np.abs(payload).sum(dtype=np.float64)) + 1.0
            if abs(rc - expect) > 1e-3 * scale + 1e-5:
                self.stats["corruptions"] += 1
                raise self._forensics(CollectiveCorruption(
                    f"{what}: control sum {rc} != payload sum {expect} "
                    f"(rank {self.get_rank()}): transport corrupted the "
                    "reduction payload"), seq)
        else:
            if rh != h or -rc != h:
                self.stats["desyncs"] += 1
                raise self._forensics(CollectiveDesync(
                    f"{what}: rank {self.get_rank()} header hash mismatch "
                    f"(got [{rh}, {rc}], want [{h}, {-h}]); ranks disagree "
                    "on the collective schedule"), seq)
        return payload.reshape(arr.shape).astype(arr.dtype, copy=False)

    def allgather_objects(self, obj: Any) -> List[Any]:
        seq = self._seq
        self._seq += 1
        self.stats["ops"] += 1
        what = f"allgather#{seq}" + (f" [{current_op_label()}]"
                                     if current_op_label() else "")
        if not self.verify:
            return self._attempts(
                lambda: self._inner.allgather_objects(obj), what)
        header = self._header("allgather", (), "object")
        try:
            crc = zlib.crc32(wire.encode(obj))
        except Exception:  # not wire-encodable (rich objects): skip the crc
            crc = None
        wrapped = (header, crc, obj)
        slots = self._attempts(
            lambda: self._inner.allgather_objects(wrapped), what)
        out = []
        for rank, slot in enumerate(slots):
            if not (isinstance(slot, tuple) and len(slot) == 3):
                self.stats["desyncs"] += 1
                raise self._forensics(CollectiveDesync(
                    f"{what}: rank {rank} contributed an unwrapped payload "
                    "— it is not running the same resilient protocol"),
                    seq, peer=rank)
            rhead, rcrc, robj = slot
            if tuple(rhead) != header:
                self.stats["desyncs"] += 1
                raise self._forensics(CollectiveDesync(
                    f"{what}: rank {rank} header {rhead} != local {header} "
                    "— ranks disagree on the collective schedule"),
                    seq, peer=rank)
            if rcrc is not None:
                if zlib.crc32(wire.encode(robj)) != rcrc:
                    self.stats["corruptions"] += 1
                    raise self._forensics(CollectiveCorruption(
                        f"{what}: rank {rank} payload CRC mismatch: "
                        "transport corrupted the gathered object"),
                        seq, peer=rank)
            out.append(robj)
        return out


# ------------------------------------------------------------ fault injection

@dataclass
class FaultPlan:
    """Declarative fault schedule (generalizes the reference ``RABIT_MOCK``
    ``mock=rank,version,seq,ndeath`` tuples and our one-shot
    ``FaultInjectionCommunicator``).

    ``fail_at_op`` counts MATCHING ops (1-based; see ``op_filter``). With
    ``fail_round`` set, the count restarts at each round boundary (rounds
    are announced via :func:`collective.notify_round` from the train loop)
    and the failure only fires in that round. ``transient`` failures raise
    :class:`TransientCollectiveError` (retryable); permanent ones raise
    :class:`CollectiveFault`. ``flaky_p`` adds seeded random transient
    failures on top. ``latency_s`` sleeps before every matching op (drive
    timeout paths); ``corrupt_at_op`` perturbs the RESULT payload of the
    n-th matching op (drive checksum paths)."""

    fail_at_op: Optional[int] = None
    fail_round: Optional[int] = None
    op_filter: Optional[str] = None          # "allreduce" | "allgather"
    transient: bool = True
    max_failures: Optional[int] = 1          # None = unlimited
    flaky_p: float = 0.0
    seed: int = 0
    latency_s: float = 0.0
    corrupt_at_op: Optional[int] = None

    def __post_init__(self) -> None:
        if self.op_filter not in (None, "allreduce", "allgather"):
            raise ValueError(
                f"op_filter must be 'allreduce' or 'allgather', "
                f"got {self.op_filter!r}")
        if self.fail_at_op is not None and self.fail_at_op < 1:
            raise ValueError("fail_at_op is 1-based; got "
                             f"{self.fail_at_op}")
        if self.corrupt_at_op is not None and self.corrupt_at_op < 1:
            raise ValueError("corrupt_at_op is 1-based; got "
                             f"{self.corrupt_at_op}")


class FaultyCommunicator(Communicator):
    """Apply a :class:`FaultPlan` to a wrapped communicator. Failures fire
    BEFORE the inner op (so a retry re-enters the group collective cleanly
   : no rank consumed the exchange); corruption applies AFTER (the
    transport delivered, the bytes rotted)."""

    def __init__(self, inner: Communicator, plan: FaultPlan) -> None:
        self._inner = inner
        self.plan = plan
        self._rng = random.Random(plan.seed ^ (inner.get_rank() * 0x9E37))
        self.ops = 0               # matching ops, lifetime
        self.round_ops = 0         # matching ops since the last round mark
        self.failures = 0
        self._round: Optional[int] = None

    def on_round(self, iteration: int) -> None:
        self._round = iteration
        self.round_ops = 0
        cb = getattr(self._inner, "on_round", None)
        if cb is not None:
            cb(iteration)

    def get_rank(self) -> int:
        return self._inner.get_rank()

    def get_world_size(self) -> int:
        return self._inner.get_world_size()

    def _matches(self, kind: str) -> bool:
        return self.plan.op_filter is None or self.plan.op_filter == kind

    def _budget_ok(self) -> bool:
        p = self.plan
        return p.max_failures is None or self.failures < p.max_failures

    def _tick(self, kind: str) -> None:
        p = self.plan
        if not self._matches(kind):
            return
        self.ops += 1
        self.round_ops += 1
        if p.latency_s > 0.0:
            time.sleep(p.latency_s)
        want = False
        if p.fail_at_op is not None:
            count = self.round_ops if p.fail_round is not None else self.ops
            in_round = p.fail_round is None or p.fail_round == self._round
            want = in_round and count == p.fail_at_op
        elif p.fail_round is not None:
            want = p.fail_round == self._round and self.round_ops == 1
        if want and self._budget_ok():
            self.failures += 1
            cls = TransientCollectiveError if p.transient else CollectiveFault
            raise cls(f"injected {'transient ' if p.transient else ''}fault "
                      f"at {kind} #{self.ops} (round {self._round}, "
                      f"rank {self.get_rank()})")
        if p.flaky_p > 0.0 and self._rng.random() < p.flaky_p \
                and self._budget_ok():
            self.failures += 1
            raise TransientCollectiveError(
                f"injected flaky fault at {kind} #{self.ops} "
                f"(rank {self.get_rank()})")

    def _maybe_corrupt_arr(self, kind: str, out: np.ndarray) -> np.ndarray:
        if self._matches(kind) and self.plan.corrupt_at_op == self.ops:
            out = np.array(out, copy=True)
            flat = out.reshape(-1)
            if flat.size:  # bit-rot one element, keep control elems intact
                if out.dtype.kind == "f":
                    flat[0] = flat[0] + 1e6
                else:
                    flat[0] = flat[0] ^ 0x5A
        return out

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        self._tick("allreduce")
        out = self._inner.allreduce(values, op=op)
        return self._maybe_corrupt_arr("allreduce", np.asarray(out))

    def allgather_objects(self, obj: Any) -> List[Any]:
        self._tick("allgather")
        out = self._inner.allgather_objects(obj)
        if self._matches("allgather") and self.plan.corrupt_at_op == self.ops:
            out = list(out)
            # corrupt a PEER's slot (corrupting our own echoes back locally)
            victim = (self.get_rank() + 1) % max(len(out), 1)
            slot = out[victim]
            if isinstance(slot, tuple) and len(slot) == 3:
                out[victim] = (slot[0], slot[1], ("corrupted", slot[2]))
            else:
                out[victim] = ("corrupted", slot)
        return out


# ------------------------------------------------------ distributed recovery

def agree_round(local_round: int,
                comm: Optional[Communicator] = None) -> int:
    """The last *collectively agreed* snapshot round: the MINIMUM across
    ranks of the newest valid snapshot each holds (reference
    ``LoadCheckPoint``: the globally committed model version). Returns
    ``local_round`` unchanged in single-rank worlds."""
    comm = comm or get_communicator()
    if not comm.is_distributed():
        return int(local_round)
    with op_context("checkpoint/agree-round"):
        return int(comm.allreduce(
            np.asarray([float(local_round)], np.float64), op="min")[0])


def resilient(inner: Optional[Communicator] = None,
              **policy_kwargs: Any) -> ResilientCommunicator:
    """Convenience factory: wrap ``inner`` (default: the active
    communicator) in a :class:`ResilientCommunicator`."""
    return ResilientCommunicator(inner or get_communicator(),
                                 policy=RetryPolicy(**policy_kwargs)
                                 if policy_kwargs else None)
