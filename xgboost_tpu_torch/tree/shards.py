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

Column split (``data_split_mode="col"`` on a mesh, the JAX package's
``split_mode="col"`` under ``shard_map``): a :class:`ColShards` holds
every row's bins of one block of features a shard (the feature axis
padded to a multiple of the mesh's size with bin-0 columns whose
real-bin count is 0, ``data/binned.py feature_pad_for_mesh``). Rows
replicate, so nothing is reduced: each shard builds its histograms
over its own features and all the rows, with its own quantiser scale
(every shard's gradients are all of them), and searches its features;
:meth:`ColShards.exchange` then takes each node's best shard (the
lowest one on a tie, which is the pooled search's lowest feature) and
its fields. A shard searches its histograms placed in the pooled
layout (:class:`FeatureBlock`: the other features empty, without real
bins), so that its prefix sums over the bins are one device's bit for
bit: CUDA's ``torch.cumsum`` splits a row's scan by the number of rows
it is given, so the same row summed in a narrower tensor can round
otherwise. A row advances only where its node's split feature lives:
each shard decides the rows of the nodes it owns and
:meth:`ColShards.decide` ORs the shards' bits (an integer sum > 0, in
shard order, on the first device), the reference's partition-bitvector
broadcast.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.binned import feature_pad_for_mesh
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
    def of(bins):
        """``bins`` as shards: itself (row or column shards), or one shard
        of a resident tensor."""
        return (bins if isinstance(bins, (RowShards, ColShards))
                else RowShards([bins]))

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

    @staticmethod
    def blocks(n_rows: int, devices: Sequence[torch.device]) -> "RowShards":
        """Shards of ``n_rows`` rows each on ``devices``, with no bins held
        (zero columns): the per-row layout of a paged matrix, whose bins
        stream (``tree/paged.py``; one device is one shard). No
        communicator: the paged tier reduces across ranks itself
        (:func:`host_allreduce`)."""
        return RowShards([torch.empty((n_rows, 0), dtype=torch.uint8,
                                      device=d) for d in devices])

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


class FeatureBlock(NamedTuple):
    """A shard's (or a vertical party's) features in the pooled layout:
    global features [offset, offset + width) of ``total`` (a block past
    ``total`` holds pad columns), histograms of ``nbins`` bin slots
    (0: the shard's own) with the missing slot last when
    ``has_missing``."""

    offset: int
    width: int
    total: int
    nbins: int = 0
    has_missing: bool = True

    def embed(self, h: torch.Tensor) -> torch.Tensor:
        """The shard's histogram [N, width, B, ...] -> the pooled layout
        [N, total, nbins, ...]: its features at their offset, its real bins
        first and its missing slot last, zeros elsewhere."""
        N, w, B = h.shape[:3]
        nb = self.nbins or B
        out = h.new_zeros((N, self.total, nb) + tuple(h.shape[3:]))
        w = min(w, self.total - self.offset)
        dst, src = out[:, self.offset:self.offset + w], h[:, :w]
        if nb == B:
            dst.copy_(src)
        else:
            real = B - 1 if self.has_missing else B
            dst[:, :, :real] = src[:, :, :real]
            if self.has_missing:
                dst[:, :, nb - 1] = src[:, :, B - 1]
        return out

    def restrict(self, per_feature: torch.Tensor) -> torch.Tensor:
        """A per-feature tensor over the pooled features, zero (False)
        outside the block."""
        idx = torch.arange(self.total, device=per_feature.device)
        own = (idx >= self.offset) & (idx < self.offset + self.width)
        return torch.where(own, per_feature, torch.zeros_like(per_feature))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The block's slice [..., width] of a tensor over the pooled
        features [..., total] (pad columns zero)."""
        out = x[..., self.offset:self.offset + self.width]
        short = self.width - out.shape[-1]
        if short:
            out = torch.cat([out, out.new_zeros(tuple(out.shape[:-1])
                                                + (short,))], dim=-1)
        return out


class ColShards:
    """Bins [n, F_loc] of each feature shard, each on its device, in shard
    order: shard s holds global features [s * F_loc, (s + 1) * F_loc) of
    every row (module docstring). It answers the growers as
    :class:`RowShards` does, for rows that every shard holds."""

    def __init__(self, parts: Sequence[torch.Tensor], pad: int = 0) -> None:
        self.parts = list(parts)
        self.devices = [p.device for p in self.parts]
        self.f_local = self.parts[0].shape[1]
        self.offsets = [s * self.f_local for s in range(len(self.parts))]
        self.pad = pad      # the pad columns past the real features

    @staticmethod
    def split_matrix(bins: torch.Tensor, mesh) -> "ColShards":
        """Bins [n, F] padded with bin-0 columns to a multiple of the
        mesh's size and cut into its equal blocks of features (the JAX
        package's ``pad_features_for_mesh``, ``PartitionSpec(None,
        DATA_AXIS)``), each block on its device."""
        n, F = bins.shape
        pad = feature_pad_for_mesh(F, mesh.size)
        if pad:
            bins = torch.cat([bins, bins.new_zeros((n, pad))], dim=1)
        w = (F + pad) // mesh.size
        return ColShards([bins[:, s * w:(s + 1) * w].to(dev).contiguous()
                          for s, dev in enumerate(mesh.devices)], pad)

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    @property
    def shape(self):
        """(rows, padded features)."""
        return (self.parts[0].shape[0], self.f_local * self.n_shards)

    @property
    def shard_rows(self) -> int:
        return self.parts[0].shape[0]

    @property
    def sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def n_features(self) -> int:
        """The real (unpadded) features."""
        return self.f_local * self.n_shards - self.pad

    def block(self, s: int, has_missing: bool = True) -> FeatureBlock:
        """Shard ``s``'s features in the pooled (unpadded) layout."""
        return FeatureBlock(self.offsets[s], self.f_local, self.n_features,
                            0, has_missing)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A per-row tensor on the first device -> a copy on every
        shard's device (rows replicate)."""
        return [aligned(x.to(dev)) for dev in self.devices]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each shard's copy of a per-row tensor -> the first's."""
        return parts[0]

    def to_shards(self, x):
        return [_to(x, dev) for dev in self.devices]

    def reduce(self, parts: Sequence[torch.Tensor],
               label: str = "mesh/hist") -> torch.Tensor:
        """Every shard's sum over all the rows is the total: the first
        shard's (the JAX package's ``allreduce`` under column split)."""
        return parts[0]

    def scale(self, gps: Sequence[torch.Tensor]) -> dict:
        """Each shard holds every row: its own scale is the pooled one."""
        return {}

    def local(self, x: Optional[torch.Tensor], s: int):
        """Shard ``s``'s slice of a tensor over the padded global features
        (its last axis), on the shard's device; None stays None."""
        if x is None:
            return None
        off = self.offsets[s]
        return x[..., off:off + self.f_local].to(self.devices[s])

    def exchange(self, results: Sequence, with_cat: bool = False):
        """The best-split exchange (the JAX package's
        ``exchange_best_split``; reference ``evaluate_splits.h:294-409``):
        the shards' split results of the same nodes, each over the global
        features -> one, each node's fields from the shard with the
        largest gain, the lowest shard on a tie; the categorical words
        cross bit for bit (``with_cat``)."""
        dev = self.device
        gains = [r.gain.to(dev) for r in results]
        best, win = gains[0], torch.zeros_like(results[0].feature,
                                               device=dev)
        for s in range(1, len(gains)):
            better = gains[s] > best
            best = torch.where(better, gains[s], best)
            win = torch.where(better, torch.full_like(win, s), win)

        def sel(xs):
            out = xs[0].to(dev)
            for s in range(1, len(xs)):
                m = (win == s).view((-1,) + (1,) * (out.dim() - 1))
                out = torch.where(m, xs[s].to(dev), out)
            return out

        fields = dict(
            gain=best,
            feature=sel([r.feature for r in results]),
            bin=sel([r.bin for r in results]),
            default_left=sel([r.default_left for r in results]),
            left_sum=sel([r.left_sum for r in results]),
            right_sum=sel([r.right_sum for r in results]))
        if with_cat:
            fields["is_cat"] = sel([r.is_cat for r in results])
            fields["cat_words"] = sel([r.cat_words for r in results])
        return results[0]._replace(**fields)

    def decide(self, bits: Sequence[torch.Tensor]) -> torch.Tensor:
        """The decision broadcast: each shard's go-right bits [n] (set
        only at the nodes it owns) -> their OR on the first device, an
        integer sum > 0 in shard order."""
        dev = self.device
        total = bits[0].to(dev).to(torch.int32)
        for b in bits[1:]:
            total = total + b.to(dev).to(torch.int32)
        return total > 0


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

