"""Host-level communicators: the collectives that cross processes.

The port of the JAX package's ``parallel/collective.py`` (reference
``src/collective/communicator.h:72``, ``communicator-inl.h``). Inside
one process the data mesh's shards are summed by the growers
(``tree/grow.py RowShards``); this module carries what crosses ranks:
the histogram and root-sum reductions of ``parallel/launch.py``'s
sharded ingestion and of the paged tier, the quantile-sketch merge
(``src/common/quantile.cc:147-390``), small-object broadcasts, the
metric partial sums and the resume-round agreement.

Backends: ``NoOpCommunicator`` (one process, reference
``noop_communicator.h``), ``InMemoryCommunicator`` (N threads in one
process, reference ``in_memory_communicator.h``: the tests' workhorse)
and ``TorchProcessCommunicator`` (one rank per OS process over
``torch.distributed``, the JAX package's ``JaxProcessCommunicator``;
``parallel/launch.py init_distributed`` is the tracker's rendezvous).
Host objects travel over a ``gloo`` group: under a NCCL default group
the communicator makes a ``gloo`` group of its own, so no pickled
object and no host array goes through NCCL, and NCCL carries no
collective of training (ROADMAP A.8). ``parallel/federated.py`` adds
the gRPC federated communicator, whose wire is the restricted codec of
``parallel/wire.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import numpy as np


class Communicator:
    """Interface: world topology + host-level collectives."""

    def get_rank(self) -> int:
        raise NotImplementedError

    def get_world_size(self) -> int:
        raise NotImplementedError

    def is_distributed(self) -> bool:
        return self.get_world_size() > 1

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        raise NotImplementedError

    def allgather_objects(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    def broadcast(self, obj: Any, root: int = 0) -> Any:
        return self.allgather_objects(obj)[root]


class NoOpCommunicator(Communicator):
    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        return values

    def allgather_objects(self, obj: Any) -> List[Any]:
        return [obj]


def _reduce_stacked(parts: List[np.ndarray], op: str) -> np.ndarray:
    """The rank-ordered reduction of ``parts`` (rank 0's first)."""
    stacked = np.stack(parts)
    if op == "sum":
        return stacked.sum(axis=0)
    if op == "max":
        return stacked.max(axis=0)
    if op == "min":
        return stacked.min(axis=0)
    if op == "bitwise_or":
        out = parts[0].copy()
        for p in parts[1:]:
            out |= p
        return out
    raise ValueError(f"unknown op {op}")


class _InMemoryGroup:
    """Shared rendezvous state for one in-process world."""

    def __init__(self, world_size: int) -> None:
        self.world_size = world_size
        self.barrier = threading.Barrier(world_size)
        self.slots: List[Any] = [None] * world_size
        self.lock = threading.Lock()

    def exchange(self, rank: int, obj: Any) -> List[Any]:
        self.slots[rank] = obj
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()  # don't let a fast rank overwrite next round
        return out


class InMemoryCommunicator(Communicator):
    """N in-process 'workers' on threads: the code paths of a real
    multi-process run without processes (SURVEY.md §4 multi-worker
    testing)."""

    def __init__(self, group: _InMemoryGroup, rank: int) -> None:
        self._group = group
        self._rank = rank

    @staticmethod
    def make_world(world_size: int) -> List["InMemoryCommunicator"]:
        group = _InMemoryGroup(world_size)
        return [InMemoryCommunicator(group, r) for r in range(world_size)]

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._group.world_size

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        parts = self._group.exchange(self._rank, np.asarray(values))
        return _reduce_stacked(parts, op)

    def allgather_objects(self, obj: Any) -> List[Any]:
        return self._group.exchange(self._rank, obj)


class TorchProcessCommunicator(Communicator):
    """One rank per OS process over ``torch.distributed`` (the JAX
    package's ``JaxProcessCommunicator``); the default process group must
    be initialised (``parallel/launch.py init_distributed``). Arrays are
    reduced as CPU tensors over a ``gloo`` group (the default group when
    it is ``gloo``, else one made here, collectively, when the
    communicator is made on every rank); objects go through
    ``all_gather_object`` on the same group. So every collective of
    training runs on the host over ``gloo``, under an ``nccl`` default
    group too (which then serves only as the rendezvous). ``seconds``:
    the host time spent inside this communicator's collectives."""

    _OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "bitwise_or": "BOR"}

    def __init__(self, group: Any = None) -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "TorchProcessCommunicator needs torch.distributed's default "
                "process group; call parallel.launch.init_distributed() "
                "first")
        self._rank = dist.get_rank()
        self._world = dist.get_world_size()
        if group is None and dist.get_backend() != "gloo":
            # host objects never ride NCCL: a gloo group of our own
            group = dist.new_group(backend="gloo")
        self._group = group
        self.seconds = 0.0

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        if self._world == 1:
            return values
        import torch
        import torch.distributed as dist

        if op not in self._OPS:
            raise ValueError(f"unknown op {op}")
        arr = np.asarray(values)
        kind = arr.dtype
        t = torch.from_numpy(np.array(arr.astype(np.uint8) if kind == bool
                                      else arr, copy=True, order="C"))
        t0 = time.perf_counter()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, self._OPS[op]),
                        group=self._group)
        self.seconds += time.perf_counter() - t0
        out = t.numpy()
        return out.astype(bool) if kind == bool else out

    def allgather_objects(self, obj: Any) -> List[Any]:
        if self._world == 1:
            return [obj]
        import torch.distributed as dist

        out: List[Any] = [None] * self._world
        t0 = time.perf_counter()
        dist.all_gather_object(out, obj, group=self._group)
        self.seconds += time.perf_counter() - t0
        return out


class FaultInjectionCommunicator(Communicator):
    """Wraps any communicator and fails the k-th collective: the testing
    counterpart of the reference's mock rabit engine
    (``rabit/src/allreduce_mock.h:147``, ``RABIT_MOCK``). Counts every
    collective (allreduce + allgather) across the wrapped communicator's
    lifetime; optional ``op_filter`` restricts which operation kinds
    count."""

    class InjectedFault(RuntimeError):
        pass

    def __init__(self, inner: Communicator, fail_at: int,
                 op_filter: Optional[str] = None) -> None:
        # a fault injector that can never fire makes recovery tests
        # vacuous: reject misconfiguration loudly
        if fail_at < 1:
            raise ValueError(f"fail_at must be >= 1, got {fail_at}")
        if op_filter is not None and op_filter not in ("allreduce",
                                                      "allgather"):
            raise ValueError(
                f"op_filter must be 'allreduce' or 'allgather' (broadcasts "
                f"count as allgather), got {op_filter!r}")
        self._inner = inner
        self._fail_at = fail_at
        self._op_filter = op_filter
        self.calls = 0

    def _tick(self, kind: str) -> None:
        if self._op_filter is not None and kind != self._op_filter:
            return
        self.calls += 1
        if self.calls == self._fail_at:
            raise FaultInjectionCommunicator.InjectedFault(
                f"injected failure at {kind} #{self.calls} "
                f"(rank {self._inner.get_rank()})")

    def get_rank(self) -> int:
        return self._inner.get_rank()

    def get_world_size(self) -> int:
        return self._inner.get_world_size()

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        self._tick("allreduce")
        return self._inner.allreduce(values, op=op)

    def allgather_objects(self, obj: Any) -> List[Any]:
        self._tick("allgather")
        return self._inner.allgather_objects(obj)


# --- global communicator (reference collective::Init / CommunicatorContext) --

_comm: Communicator = NoOpCommunicator()
_comm_tls = threading.local()


def init(communicator: str = "noop", **kwargs: Any) -> None:
    """Initialise the process-global communicator by name (reference
    ``Communicator::Init``; names mirror CommunicatorType: ``torch`` and
    its alias ``rabit`` take ``torch.distributed``'s default group,
    ``federated`` connects to a ``parallel/federated.py`` server at
    ``federated_server_address`` as ``federated_rank`` of
    ``federated_world_size``)."""
    global _comm
    if communicator in ("noop", "none"):
        _comm = NoOpCommunicator()
    elif communicator in ("torch", "rabit"):  # rabit name kept for parity
        _comm = TorchProcessCommunicator(**kwargs)
    elif communicator == "federated":
        from .federated import FederatedCommunicator

        _comm = FederatedCommunicator(
            kwargs.pop("federated_server_address"),
            int(kwargs.pop("federated_world_size")),
            int(kwargs.pop("federated_rank")), **kwargs)
    else:
        raise ValueError(f"unknown communicator type: {communicator}")


def finalize() -> None:
    global _comm
    _comm = NoOpCommunicator()


def set_thread_local_communicator(comm: Optional[Communicator]) -> None:
    _comm_tls.value = comm


def get_communicator() -> Communicator:
    tl = getattr(_comm_tls, "value", None)
    return tl if tl is not None else _comm


def get_rank() -> int:
    return get_communicator().get_rank()


def get_world_size() -> int:
    return get_communicator().get_world_size()


def is_distributed() -> bool:
    return get_communicator().is_distributed()


def allreduce(data: np.ndarray, op: str = "sum") -> np.ndarray:
    """Module-level allreduce on the active communicator (reference
    ``collective.allreduce``; op names mirror the Op enum:
    sum/max/min/bitwise_or)."""
    return get_communicator().allreduce(np.asarray(data), op=op)


def broadcast(data: Any, root: int = 0) -> Any:
    """Broadcast any picklable object from ``root`` (reference
    ``collective.broadcast``)."""
    return get_communicator().broadcast(data, root=root)


def allgather(data: Any) -> List[Any]:
    """Gather one object per rank, rank-ordered."""
    return get_communicator().allgather_objects(data)


def notify_round(iteration: int) -> None:
    """Announce a boosting-round boundary to round-aware communicators
    (``FaultyCommunicator``'s schedules keyed on rounds,
    ``ResilientCommunicator``'s forwarding). A plain communicator ignores
    it."""
    cb = getattr(get_communicator(), "on_round", None)
    if cb is not None:
        cb(iteration)


def communicator_print(msg: Any) -> None:
    """Rank-prefixed print (reference ``collective.communicator_print``)."""
    print(f"[{get_rank()}] {msg}", flush=True)


def get_processor_name() -> str:
    import socket

    return socket.gethostname()


class CommunicatorContext:
    """``with CommunicatorContext(...)``: reference
    ``python-package/xgboost/collective.py``'s context manager. An
    instance becomes this thread's communicator; a name (or keywords)
    initialises the process-global one (``torch`` by default)."""

    def __init__(self, communicator: Optional[Communicator] = None,
                 **init_kwargs: Any) -> None:
        if isinstance(communicator, str):  # name, not instance: route to init
            init_kwargs["communicator"] = communicator
            communicator = None
        self._explicit = communicator
        self._init_kwargs = init_kwargs

    def __enter__(self) -> Communicator:
        if self._explicit is not None:
            set_thread_local_communicator(self._explicit)
            return self._explicit
        init(**(self._init_kwargs or {"communicator": "torch"}))
        return get_communicator()

    def __exit__(self, *exc: Any) -> None:
        if self._explicit is not None:
            set_thread_local_communicator(None)
        else:
            finalize()


def merge_summaries(local: list, max_bin: int,
                    comm: Optional[Communicator] = None) -> list:
    """Merge per-feature sketch summaries across workers: allgather ->
    merge -> prune (reference ``GatherSketchInfo`` + ``AllReduce`` in
    ``src/common/quantile.cc:147-276``). Shared by sharded ingestion and
    the iterator's external-memory path."""
    from ..data.quantile import FeatureSummary

    comm = comm or get_communicator()
    if not comm.is_distributed():
        return local
    from .resilience import op_context

    payload = [(s.values, s.weights) for s in local]
    with op_context("sketch/merge"):
        gathered = comm.allgather_objects(payload)
    widths = [len(g) for g in gathered]
    if len(set(widths)) != 1:
        # zip would silently truncate to the shortest list, destroying the
        # global sketch far from the cause (e.g. a rank whose iterator
        # yielded zero batches): fail at the source instead
        raise ValueError(
            "sketch merge: ranks disagree on feature count "
            f"{dict(enumerate(widths))}; every rank must contribute a "
            "summary for every feature (empty shards are not supported)")
    merged = local
    for rank, remote in enumerate(gathered):
        if rank == comm.get_rank():
            continue
        merged = [a.merge(FeatureSummary(np.asarray(v), np.asarray(w)))
                  for a, (v, w) in zip(merged, remote)]
    return [s.prune(max_bin * 8) for s in merged]


def distributed_sketch(X_local: np.ndarray, max_bin: int,
                       weights: Optional[np.ndarray] = None,
                       comm: Optional[Communicator] = None,
                       feature_types=None):
    """Global quantile cuts from row shards (the summary-level merge over
    the communicator)."""
    from ..data.quantile import FeatureSummary, cuts_from_summaries

    comm = comm or get_communicator()
    local = [FeatureSummary.from_data(X_local[:, f], weights)
             for f in range(X_local.shape[1])]
    if not comm.is_distributed():
        return cuts_from_summaries(local, max_bin, feature_types)
    return cuts_from_summaries(merge_summaries(local, max_bin, comm),
                               max_bin, feature_types)


# -- aggregator helpers (reference src/collective/aggregator.h) ---------------

def global_sum(values: np.ndarray,
               comm: Optional[Communicator] = None,
               row_split: bool = True) -> np.ndarray:
    """Sum across workers (reference ``collective::GlobalSum``,
    aggregator.h:91). With ``row_split=False`` (column split: rows and
    labels replicated on every worker) the reduction is skipped, as the
    reference's ``IsRowSplit`` guard skips it."""
    comm = comm or get_communicator()
    if not row_split:
        return np.asarray(values, np.float64)
    return comm.allreduce(np.asarray(values, np.float64), op="sum")


def global_ratio(numerator: float, denominator: float,
                 comm: Optional[Communicator] = None,
                 row_split: bool = True) -> float:
    """Sum both sides across workers, then divide (reference
    ``collective::GlobalRatio``, aggregator.h:115: how distributed metrics
    aggregate their partial sums)."""
    s = global_sum(np.asarray([numerator, denominator], np.float64), comm,
                   row_split=row_split)
    return float(s[0] / s[1]) if s[1] != 0 else float("nan")


def apply_with_labels(fn, comm: Optional[Communicator] = None,
                      label_rank: int = 0):
    """Reference ``collective::ApplyWithLabels`` (aggregator.h:36): only
    ``label_rank`` computes ``fn()`` and the result reaches every rank
    (vertical federated parties: only the label rank holds labels). The
    result is wire-encoded on the label rank (``parallel/wire.py``, never
    a pickle: the parties may not trust each other), its length maxed
    and the zero-padded bytes sum-reduced, the other ranks adding zeros:
    one symmetric reduction, as the JAX package's."""
    comm = comm or get_communicator()
    if not comm.is_distributed():
        return fn()
    from . import wire

    payload = wire.encode(fn()) if comm.get_rank() == label_rank else b""
    n = int(comm.allreduce(np.asarray([len(payload)], np.int64),
                           op="max")[0])
    buf = np.zeros(n, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    # the reduction may widen the dtype; one rank adds each byte
    buf = np.asarray(comm.allreduce(buf, op="sum")).astype(np.uint8)
    return wire.decode(buf.tobytes())
