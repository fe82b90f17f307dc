"""The rows of one tree's growth over a data mesh.

The port's counterpart of the JAX package's ``shard_map`` over the
``data`` axis (``tree/grow.py TreeGrower._sharded``, ``tree/lossguide.py``
and ``tree/multi.py``'s mesh branches): a :class:`RowShards` holds a
matrix's bins as one block of rows a shard, each on its shard's device
(``context.Mesh``). The growers build each shard's histogram on its own
device from its own rows, gradients and positions, and
:meth:`RowShards.reduce` sums the shards' f32 partials in shard order
onto the first shard's device: the JAX package's ``psum``. The split
search then runs once, and its decisions go back to every shard. Every
shard quantises alike: :meth:`RowShards.scale` is the JAX package's
``pmax`` of the int8x2 scale (and the rows K3's fixed-point exponent
bounds).

A mesh that carries a host communicator (``parallel/launch.py``: one
rank a process, each with its rows) goes on from the local sum across
the ranks through the communicator, labelled for the resilient layer
(``parallel/resilience.py op_context``). One device with no
communicator is one shard, whose reduction is the identity: the
single-device growers' bits.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.histogram import abs_max


def aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy when ``t`` is not contiguous or its first row is
    not 16-byte aligned (the kernels take 16-byte aligned rows)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


class RowShards:
    """Bins [n_s, F] of each shard, each on its device, in shard order;
    ``mesh``: their ``context.Mesh`` (its communicator reduces across
    ranks), or None for one device."""

    def __init__(self, parts: Sequence[torch.Tensor], mesh=None) -> None:
        self.parts = list(parts)
        comm = None if mesh is None else mesh.comm
        # the ranks' reduction, only where there are ranks to reduce over
        self.comm = comm if comm is not None and comm.is_distributed() \
            else None
        self.devices = [p.device for p in self.parts]
        self.bounds = np.concatenate(
            [[0], np.cumsum([p.shape[0] for p in self.parts])]).tolist()

    @staticmethod
    def of(bins) -> "RowShards":
        """``bins`` as shards: itself, or one shard of a resident
        tensor."""
        return bins if isinstance(bins, RowShards) else RowShards([bins])

    @staticmethod
    def split_matrix(bins: torch.Tensor, mesh) -> "RowShards":
        """Bins [n, F] with n a multiple of the mesh's size, cut into its
        equal blocks of rows (shard d holds rows [d * m, (d + 1) * m),
        the JAX package's ``PartitionSpec(DATA_AXIS)``), each on its
        device, 16-byte aligned (a block of a shared device's matrix is
        a view unless it starts off the kernels' alignment)."""
        m = bins.shape[0] // mesh.size
        return RowShards([aligned(bins[d * m:(d + 1) * m].to(dev))
                          for d, dev in enumerate(mesh.devices)], mesh)

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    @property
    def shape(self):
        """(local rows, features): every local shard's rows."""
        return (self.bounds[-1],) + tuple(self.parts[0].shape[1:])

    @property
    def shard_rows(self) -> int:
        """A shard's rows: what ``auto``'s kernel choice and the int8x2
        guard read, as the JAX package's do inside ``shard_map``."""
        return max(p.shape[0] for p in self.parts)

    @property
    def sharded(self) -> bool:
        """More than one shard, here or across ranks."""
        return self.n_shards > 1 or self.comm is not None

    @property
    def device(self) -> torch.device:
        """The first shard's device: where reductions land."""
        return self.devices[0]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A per-row tensor over the local rows (on the first device) ->
        each shard's block on its device."""
        if self.n_shards == 1:
            return [x]
        return [aligned(x[a:b].to(dev)) for a, b, dev in
                zip(self.bounds[:-1], self.bounds[1:], self.devices)]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each shard's per-row tensor -> one over the local rows on the
        first device, in shard order."""
        if self.n_shards == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts])

    def to_shards(self, x):
        """``x`` (a tensor, a tuple of them, or None) on every shard's
        device (the split decisions going back to the shards)."""
        return [_to(x, dev) for dev in self.devices]

    def reduce(self, parts: Sequence[torch.Tensor],
               label: str = "mesh/hist") -> torch.Tensor:
        """The sum of the shards' partials in shard order on the first
        device (the JAX package's ``psum``), then across the ranks."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(out.device)
        if self.comm is not None:
            out = host_allreduce(out, self.comm, "sum", label)
        return out

    def scale(self, gps: Sequence[torch.Tensor]) -> dict:
        """The histogram wrappers' quantiser keywords for the shards'
        gradients [n_s, 2] or [n_s, K, 2]: ``max_abs``, each component's
        max|x| over every shard (the JAX package's ``pmax``; [2] or
        [K, 2]), and ``total_rows``, the rows of every shard; none for
        one shard, whose builds take their own scale."""
        if not self.sharded:
            return {}
        m = torch.stack([abs_max(g.reshape(g.shape[0], -1)).to(self.device)
                         for g in gps]).amax(dim=0)
        m = m.reshape(gps[0].shape[1:])
        rows = self.bounds[-1]
        if self.comm is not None:
            m = host_allreduce(m, self.comm, "max", "mesh/scale")
            rows = int(self.comm.allreduce(np.asarray([rows], np.int64),
                                           op="sum")[0])
        return {"max_abs": m, "total_rows": rows}


def host_allreduce(t: torch.Tensor, comm=None, op: str = "sum",
                   label: str = "paged/hist") -> torch.Tensor:
    """``t`` reduced across the ranks of ``comm`` (by default the current
    thread's communicator, read at every call: growers outlive a
    communicator) on the host, back on ``t``'s device; ``t`` itself
    without a multi-rank communicator. The op is labelled for the
    resilient layer's integrity header, so ranks stuck at two call sites
    raise a ``CollectiveDesync`` naming both (the JAX package's
    ``tree/paged.py _host_allreduce``)."""
    from ..parallel import collective
    from ..parallel.resilience import op_context

    comm = comm if comm is not None else collective.get_communicator()
    if not comm.is_distributed():
        return t
    with op_context(label):
        red = comm.allreduce(t.detach().cpu().numpy(), op=op)
    return torch.from_numpy(np.ascontiguousarray(red)).to(t.device)


def _to(x, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        vals = [_to(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x

