"""Multi-process distributed training: sharded ingestion and
``train_per_host``.

The port of the JAX package's ``parallel/launch.py``, the counterpart of
the reference's cluster integrations (``python-package/xgboost/
dask.py:918`` ``_train_async``, PySpark's barrier mode): a tracker hands
every worker the rendezvous, each worker builds a matrix from its own
rows and runs ``train()`` under a ``CommunicatorContext``, and the
histogram allreduce crosses the workers.

PyTorch mapping:

- the **tracker** is ``torch.distributed``'s rendezvous
  (:func:`init_distributed`: a ``tcp://`` or ``file://`` init method, or
  ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment;
  ``parallel/tracker.py`` hands them out);
- the **world** is each rank's data mesh (its device; a ``context.Mesh``
  for more) joined by the host communicator
  (:func:`global_data_mesh`): every reduction of the growers sums the
  local shards and then the ranks (``tree/shards.py RowShards``);
- each process holds ONLY its rows (:class:`ShardedDMatrix`): the cuts
  come from the summary merge of ``collective.distributed_sketch`` and
  the missing-slot layout is agreed by an allreduce, so every rank bins
  alike and every histogram has one shape.

Every process runs the same program::

    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.parallel import launch

    launch.init_distributed("file:///shared/rdv", world_size=2, rank=r,
                            backend="gloo")
    with launch.CommunicatorContext():
        bst = launch.train_per_host(params, X_local, y_local, num_rounds)
    # every process holds the same model

One process (no communicator) is plain training over a mesh of its
device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import collective
from ..context import Mesh, resolve_device
from ..data.binned import BinnedMatrix, search_bin
from ..data.dmatrix import DMatrix


def _local_layout(rank: int, world_size: int):
    """(local rank, ranks on this host) from the launcher's environment
    (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them),
    else one host."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return local, local_world


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the multi-process world (the tracker rendezvous; the JAX
    package's ``init_distributed``). ``init_method``: ``tcp://host:port``
    or ``file:///path``; with no arguments the environment's
    ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` are read, and without
    them the process stays alone. ``backend=None`` takes ``nccl`` when
    every rank on this host has its own CUDA device and ``gloo`` without
    CUDA; ranks that would share a device under NCCL raise and name
    ``backend="gloo"``: the backend is never switched quietly.

    Under ``nccl`` the default group is the rendezvous and pins each rank
    to its device (``torch.cuda.set_device``), and nothing more: every
    reduction of training (histograms, sums, sketches, metrics, trees)
    goes through ``collective.TorchProcessCommunicator``'s own ``gloo``
    group on the host, whatever the backend. NCCL carries no collective
    yet."""
    import torch.distributed as dist

    if dist.is_initialized():
        return  # already initialised
    env = os.environ
    if init_method is None and world_size is None:
        if not (env.get("MASTER_ADDR") and env.get("WORLD_SIZE")):
            return  # no cluster configured: stay one process
        init_method = "env://"
    world_size = int(world_size if world_size is not None
                     else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local, local_world = _local_layout(rank, world_size)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > n_dev:
            raise RuntimeError(
                f"backend='nccl' needs one CUDA device a rank, but "
                f"{local_world} ranks share {n_dev} device(s) on this host; "
                "pass backend='gloo' to run several ranks on one device")
        torch.cuda.set_device(local)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    except Exception as e:
        # a cluster IS configured: going on alone would silently train
        # divergent models, so fail (the reference tracker's rendezvous
        # fails the job the same way)
        raise RuntimeError(
            f"torch.distributed rendezvous at {init_method!r} failed for "
            f"rank {rank} of {world_size}; refusing to continue as one "
            "process") from e


# re-exported: one CommunicatorContext for the whole package
CommunicatorContext = collective.CommunicatorContext


def global_data_mesh(device: Optional[str] = None) -> Mesh:
    """This rank's part of the world (the JAX package's
    ``global_data_mesh``): a mesh of its device (``device``; by default
    the current CUDA device, one rank a device) carrying the active
    communicator, whose reductions go on across the ranks."""
    if device is None or str(device) in ("cuda", "auto"):
        resolve_device("cuda")              # raises without CUDA
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(str(device))
    return Mesh([dev], comm=collective.get_communicator())


def train_per_host(params: Dict[str, Any], X_local: np.ndarray,
                   y_local: np.ndarray, num_boost_round: int = 10,
                   *, weight_local: Optional[np.ndarray] = None,
                   qid_local: Optional[np.ndarray] = None,
                   mesh: Optional[Mesh] = None, **train_kwargs):
    """SPMD entry: every process passes its own rows; one model comes
    back on every process. Without a multi-rank communicator this is
    ``train`` over a mesh of the local device.

    ``mesh``: this rank's shards (default :func:`global_data_mesh` on
    ``params["device"]``); a mesh without a communicator gets the active
    one. ``qid_local``: ranking query ids of the local rows; query
    groups must be WHOLE within a process (lambda gradients couple only
    rows of one group, so the rank-local gradient is exact)."""
    from ..core import train

    comm = collective.get_communicator()
    if mesh is None:
        mesh = global_data_mesh(params.get("device"))
    elif mesh.comm is None:
        mesh = Mesh(mesh.devices, comm=comm)
    if not comm.is_distributed():
        dm = DMatrix(X_local, label=y_local, weight=weight_local,
                     qid=qid_local)
    else:
        dm = ShardedDMatrix(X_local, label=y_local, weight=weight_local,
                            qid=qid_local,
                            max_bin=int(params.get("max_bin", 256)),
                            comm=comm)
    return train({**params, "mesh": mesh}, dm, num_boost_round,
                 **train_kwargs)


class ShardedDMatrix(DMatrix):
    """One process's rows of a global training matrix (the JAX package's
    ``ShardedDMatrix``). Its views (``info``, ``num_row``, ``values``)
    are LOCAL: metrics evaluate the local rows and aggregate through the
    communicator (``metric/base.py global_mean``), the reference's
    GlobalRatio design. The cuts at ``max_bin`` come from
    ``collective.distributed_sketch`` over every rank's rows and the
    missing slot is agreed across the ranks, so every rank's bins share
    one layout; no process holds the global matrix."""

    presharded = True

    def __init__(self, data: Any, label: Any = None, *,
                 weight: Optional[np.ndarray] = None,
                 qid: Optional[np.ndarray] = None, max_bin: int = 256,
                 comm: Optional[collective.Communicator] = None) -> None:
        super().__init__(data, label, weight=weight, qid=qid)
        comm = comm if comm is not None else collective.get_communicator()
        self._comm = comm
        self.max_bin = max_bin
        self._has_missing_g = bool(int(comm.allreduce(
            np.asarray([int(np.isnan(self.X).any())], np.int64),
            op="max")[0]))
        self._cuts[max_bin] = collective.distributed_sketch(
            self.X, max_bin, weights=self.info.weights, comm=comm)

    def _bin(self, cuts, device: torch.device) -> BinnedMatrix:
        """The local rows binned with ``cuts`` under the agreed missing
        slot."""
        hm = self._has_missing_g
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(hm)
        b = search_bin(torch.from_numpy(np.ascontiguousarray(self.X)).to(
            device), cuts, max(max_nbins - 1, 0))
        return BinnedMatrix.from_bin_ids(b, cuts, hm)

    def binned(self, max_bin: int, device: torch.device) -> BinnedMatrix:
        key = (max_bin, str(device))
        if key not in self._binned:
            self._binned[key] = self._bin(self.cuts(max_bin), device)
        return self._binned[key]

    def approx_source(self, max_bin: int, device: torch.device):
        """``tree_method="approx"``'s source: each round's hessian
        re-sketch merged across the ranks (the JAX package's
        ``resketch_binned``; reference ``updater_approx.cc:245``)."""
        return ShardedApproxSource(self, max_bin, device)


class ShardedApproxSource:
    """Each round's re-sketch of a :class:`ShardedDMatrix` with the local
    rows' hessians, the summaries merged across the ranks, and the local
    rows re-binned."""

    def __init__(self, dm: ShardedDMatrix, max_bin: int,
                 device: torch.device) -> None:
        self.dm = dm
        self.max_bin = max_bin
        self.device = device
        self.n_rows = dm.num_row()

    def binned(self, weights: torch.Tensor) -> BinnedMatrix:
        cuts = collective.distributed_sketch(
            self.dm.X, self.max_bin,
            weights=weights.detach().cpu().numpy().astype(np.float64),
            comm=self.dm._comm)
        return self.dm._bin(cuts, self.device)
