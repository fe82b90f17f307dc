"""External-memory tree growth: the level loop over streamed bin pages.

The port of the JAX package's ``tree/paged.py`` (``_PageKernels``,
``_MeshPageKernels``, ``PagedGrower``, ``PagedLossguideGrower``,
``PagedMultiTargetGrower``, ``PagedMultiLossguideGrower``): the quantized
matrix stays in host memory (``data/binned.py PagedBinnedMatrix``) and
each level is one pass over its row pages, cached pages first and then
the pages the prefetch ring uploads, in page order. The root's pass
builds the histogram; every later pass advances the rows below the
previous level's splits and builds this level's histogram from the same
read of a page (``adv_hist``); a last pass advances below the deepest
splits (``final_advance``). Gradients and positions stay on the device;
a pass updates the positions of a page in place.

A level's histogram is the f32 sum of its pages' histograms, added in
page order from zero, each page's built by ``ops/histogram.py
build_hist`` over that page's rows (so the int8x2 scale is the page's
own ``max|g|``): the JAX package's arithmetic, and not the resident
tier's, whose one build quantises over every row. Packed pages
(``XTPU_PAGE_PACK``) go to the histogram kernels as they are; the
advance reads a row's nibble.

Level width: each level is built at its own width (2^depth nodes), as
``tree/grow.py grow_tree`` builds it, so that ``auto`` takes K4 (u8, at
least 128 bins, pages of at least 65,536 rows) or K2 at levels of at
most 128 nodes and K3 above, as at the resident tier. The JAX package
pads every level to 2^(max_depth - 1) nodes to bound its compiles; the
real nodes' integer sums are the same at either width.

The two-level schedules (``hist_method`` ``coarse``, ``fused``, ``scan``
and ``mega``) are one page-major schedule here, as in the JAX package,
whose page passes are plain builds that ``auto`` picks the kernel of. A
level's one pass advances each page and builds its coarse histogram (20
slots, K2) and its fine histogram (K4, K2 or K3), each added in page
order from zero into one accumulator. The refine window of each (node,
feature) comes from the summed coarse histogram, and the refine
histogram is the window's slice of the summed fine one
(``refine_from_fine``): a gather, so it is the sum of the pages' slices,
each equal bit for bit to that page's direct refine build over
``refine_bin_ids``. A page is read once a level, ``depth + 1``
matrix-equivalents a round; the device holds one fine accumulator
whatever the number of pages; and the model's bytes, the launches and
the device memory do not depend on the page-cache budget. (The JAX
package builds the fine partial of the uploaded pages only and a direct
refine of the cached ones in a second pass; with every page uploaded
its sums are these.)

Categorical features split and advance as at the resident tier (the
heap's ``is_cat_split`` and left-set words); monotone and interaction
constraints keep ``tree/grow.py HeapTree``'s per-node intervals and
paths; ``max_leaves`` truncates the grown heap
(``TreeGrower._truncate_max_leaves``). Leaf-wise growth (scalar and
vector leaves) is the greedy loop of ``tree/lossguide.py`` /
``tree/multi.py`` with its two steps over the pages: the pair's
histogram (:meth:`_PageKernels.pair_hist`) and the popped node's advance
(:meth:`_PageKernels.apply1`). Vector-leaf depthwise growth is the level
loop with K-target page builds.

The level bookkeeping is ``tree/grow.py HeapTree``, shared with the
resident grower; evaluation takes the round's feature masks as there.
The JAX package also stops a tree's passes one level after a level
with no split; the port runs every level (a level without active nodes
splits nothing, so the tree is the same).

Row split across processes: under a multi-rank communicator each rank
streams its own pages, and each level's histograms (the pass's, the
two-level pass's coarse and refine, a leaf-wise pair's) and the root's
sums are summed across the ranks on the host
(``tree/shards.py host_allreduce``, the JAX package's
``_host_allreduce``), so every rank grows the same tree. A page's
int8x2 scale stays its own, as in the JAX package.

Over a data mesh (``data/binned.py PagedMeshMatrix``, the JAX package's
``_MeshPageKernels``): shard d owns rows [d * n_loc, (d + 1) * n_loc)
and a mesh page is a block of ``p_loc`` rows of every shard, each on its
shard's device (``PagedBinnedMatrix.stream_pages_sharded``, its own
cache by the page's local start); gradients [n_pad, ...] come padded
with zero rows, and gradients and positions live as one tensor a shard.
Each shard adds its blocks' builds, cached pages then streamed ones,
into one partial for the pass, each block quantised with its own scale
at its own rows (``auto``'s kernel choice reads ``p_loc``), and the
shards' partials are summed once a pass in shard order
(``RowShards.reduce``, the JAX package's ``psum``). One device is the
same code with one shard. The refine histogram of the two-level
schedule is sliced from each shard's fine partial and then summed (the
same sums: the slice is a gather), and no paged pass launches K5: its
advance runs before a plain build, on one device and on a mesh. The
JAX package's dense ``level_advance`` and deep-tree ``walk_advance`` are
one gather advance here (``ops/partition.py advance_level``).

Spans (``obs/trace.py``), the JAX package's names in its order: each
level ``paged/hist`` (the page passes; ``args={"depth": d}``),
``paged/exchange`` (the shards' sum and the ranks' allreduce),
``paged/eval`` (the split search and the level's record), with
``paged/window`` / ``paged/refine`` and a second ``paged/exchange``
between them in the two-level schedule; after the levels
``paged/advance`` (the last advance) and ``paged/fetch`` (the tree's
weights and rows' deltas: the port records each level as it goes, where
the JAX package pulls every level's decisions here). The ring's
``ring/upload`` (its worker) and ``ring/blocked`` (the pass waiting)
come from ``data/binned.py``; ``obs/memory.py`` samples
``paged/level`` at each level's end.

``"<kernel>+sub"`` builds every node of a page pass here, as in the JAX
package (its paged tier drops the suffix).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..data.binned import PagedMeshMatrix
from ..obs import memory as _mem
from ..obs import trace as _trace
from ..ops.histogram import (build_hist, build_hist_multi,
                             resolve_hist_kernel, split_hist_method)
from ..ops.partition import LevelSplits, advance_level, level_rel
from ..ops.split import (COARSE_B, assemble_two_level,
                         choose_refine_window, coarse_bin_ids,
                         decode_two_level_bin, evaluate_splits,
                         evaluate_splits_multi, refine_from_fine)
from ..ops.xla_order import sum_in_xla_order
from .grow import GrownTree, HeapTree, TreeGrower
from .lossguide import LossguideGrower, apply1
from .multi import MultiLossguideGrower, MultiTargetGrower
from .shards import RowShards, aligned, host_allreduce

TWO_LEVEL = ("coarse", "fused", "scan", "mega")


def _base(hist_method: str) -> str:
    return split_hist_method(hist_method)[0]


def is_two_level(hist_method: str) -> bool:
    return _base(hist_method) in TWO_LEVEL


def page_method(hist_method: str) -> str:
    """The page builds' method (the JAX package's ``_make_kernels``): the
    two-level names run plain builds through ``auto``; a ``+sub`` /
    ``+nosub`` suffix is dropped, as the JAX package's paged tier drops
    it (a page pass builds every node)."""
    return "auto" if is_two_level(hist_method) else _base(hist_method)


def _depth_args(depth: int):
    return {"depth": depth} if _trace.enabled() else None


class _PageKernels:
    """The per-page work of one pass, single device (the JAX package's
    ``_PageKernels``). Per-row vectors come as lists of one tensor a
    shard (``tree/shards.py RowShards``; one device is one shard) and the
    passes return each shard's partial histogram, which the growers sum
    (:meth:`RowShards.reduce`, in the ``paged/exchange`` span)."""

    def __init__(self, max_nbins: int, hist_method: str,
                 has_missing: bool, numeric: bool = True) -> None:
        self.max_nbins = max_nbins
        self.hist_method = page_method(hist_method)
        self.has_missing = has_missing
        self.numeric = numeric
        self.missing_bin = max_nbins - 1 if has_missing else max_nbins

    @staticmethod
    def _drive(paged, device: torch.device, body, carry):
        """``carry = body(carry, page, start, end, uploaded)`` over every
        page: the cached pages, then the others through the ring (page
        order; the ``(cached, streamed)`` pair of ``paged.cached_split`` is
        taken when the pass starts)."""
        cached, streamed = paged.cached_split(device)
        for s, e, page in cached:
            carry = body(carry, page, s, e, False)
        for s, e, page in paged.stream_pages(streamed, device):
            carry = body(carry, page, s, e, True)
            del page    # the ring's next upload may take its place
        return carry

    def _pass(self, src, device: torch.device, body, carry):
        """``carry = body(carry, blocks, start, end, uploaded)`` over every
        page, ``blocks`` each shard's block of the page (here the page)."""
        return self._drive(src, device,
                           lambda c, page, s, e, up: body(c, (page,), s, e,
                                                          up), carry)

    @staticmethod
    def matrix(src):
        """The ``PagedBinnedMatrix`` of ``src``."""
        return src

    def rows(self, src, n: int, device: torch.device) -> RowShards:
        """The per-row layout: one shard of ``n`` rows."""
        _check_rows(src, n)
        return RowShards.blocks(n, [device])

    def page_rows(self, src, n: int) -> int:
        """The rows of one shard's page: what ``auto``'s kernel choice
        reads."""
        return min(src.page_rows, max(n, 1))

    @staticmethod
    def init_positions(rows: RowShards) -> List[torch.Tensor]:
        """Every shard's rows at the root: [n_s] int64 zeros on its
        device."""
        return [torch.zeros((b - a,), dtype=torch.int64, device=dev)
                for a, b, dev in zip(rows.bounds[:-1], rows.bounds[1:],
                                     rows.devices)]

    def _hist(self, paged, page, gp, rel, n_nodes) -> torch.Tensor:
        """A page's full-width histogram; [p, K, 2] gradients build the
        K-target one."""
        packed = paged.n_features if paged.packed else 0
        if gp.dim() == 3:
            return build_hist_multi(page, gp, rel, n_nodes, self.max_nbins,
                                    method=self.hist_method,
                                    has_missing=self.has_missing,
                                    packed_u4=packed)
        return build_hist(page, aligned(gp), rel, n_nodes,
                          self.max_nbins, method=self.hist_method,
                          has_missing=self.has_missing, packed_u4=packed,
                          numeric=self.numeric)

    def _acc_zeros(self, paged, gps, n_nodes, nbins=None):
        """Each shard's zero accumulator, on its device."""
        return [torch.zeros((n_nodes, paged.n_features,
                             nbins or self.max_nbins) + tuple(g.shape[1:]),
                            dtype=torch.float32, device=g.device)
                for g in gps]

    def _advance(self, paged, page, pos_pg, prev: LevelSplits):
        """One page's advance below ``prev``'s splits (the JAX package's
        ``_advance_rows``), reading packed pages' nibbles."""
        return advance_level(page, pos_pg, prev, self.missing_bin,
                             packed=paged.packed)

    def _hist_over_pages(self, src, rows: RowShards, gps, positions,
                         prev: Optional[LevelSplits], rel_fn, n_nodes: int):
        """The shared page loop: each shard's block of each page advanced
        below ``prev``'s splits (when given; its positions in place),
        then its histogram of ``n_nodes`` slots (``rel_fn(positions)``)
        added to the shard's accumulator, pages in the order of the pass
        from zero. -> each shard's partial."""
        paged = self.matrix(src)
        prevs = None if prev is None else rows.to_shards(prev)

        def body(accs, blocks, s, e, _):
            for d, page in enumerate(blocks):
                pos = positions[d][s:e]
                if prevs is not None:
                    pos = self._advance(paged, page, pos, prevs[d])
                    positions[d][s:e] = pos
                accs[d].add_(self._hist(paged, page, gps[d][s:e],
                                        rel_fn(pos), n_nodes))
            return accs

        return self._pass(src, rows.device, body,
                          self._acc_zeros(paged, gps, n_nodes))

    def level_hist(self, src, rows, gps, positions, lo: int,
                   n_level: int):
        """The root level's histogram, each shard's partial."""
        return self._hist_over_pages(
            src, rows, gps, positions, None,
            lambda pos: level_rel(pos, lo, n_level), n_level)

    def adv_hist(self, src, rows, gps, positions,
                 prev: Optional[LevelSplits], lo: int, n_level: int):
        """One read of each page: advance its rows below ``prev``'s splits
        (when given: not at the root), then add its histogram of the
        level of ``n_level`` nodes from heap node ``lo``."""
        return self._hist_over_pages(
            src, rows, gps, positions, prev,
            lambda pos: level_rel(pos, lo, n_level), n_level)

    # -- the page-major two-level schedule (module docstring) -----------------
    def coarse_pass(self, src, rows, gps, positions,
                    prev: Optional[LevelSplits], lo: int, n_level: int):
        """A level's one pass: each page advanced below ``prev``'s splits
        (when given; the positions in place), then its coarse and its fine
        histogram added. -> (each shard's coarse partial [N, F, COARSE_B,
        2], each shard's fine one [N, F, B, 2])."""
        paged = self.matrix(src)
        mb = self.missing_bin
        prevs = None if prev is None else rows.to_shards(prev)

        def body(acc, blocks, s, e, _):
            hist_c, hist_f = acc
            for d, page in enumerate(blocks):
                pos = positions[d][s:e]
                if prevs is not None:
                    pos = self._advance(paged, page, pos, prevs[d])
                    positions[d][s:e] = pos
                rel = level_rel(pos, lo, n_level)
                gp = aligned(gps[d][s:e])
                hist_c[d].add_(build_hist(
                    coarse_bin_ids(paged.decode_page(page), mb), gp, rel,
                    n_level, COARSE_B))
                hist_f[d].add_(self._hist(paged, page, gp, rel, n_level))
            return acc

        return self._pass(src, rows.device, body,
                          (self._acc_zeros(paged, gps, n_level, COARSE_B),
                           self._acc_zeros(paged, gps, n_level)))

    def refine_pass(self, rows, fine, span: torch.Tensor):
        """Each shard's refine histogram, the window ``span`` [N, F] (from
        the summed coarse histogram) sliced from its fine partial
        (``refine_from_fine``: a gather, so the shards' slices sum to the
        slice of the summed fine histogram, and the refine's reduction
        moves ``WINDOW`` slots, not ``B``)."""
        return [refine_from_fine(f, sp, self.missing_bin)
                for f, sp in zip(fine, rows.to_shards(span))]

    def final_advance(self, src, rows, positions,
                      prev: LevelSplits) -> None:
        """The advance below the deepest splits (the positions in place):
        the JAX package's ``level_advance`` and ``walk_advance``, which
        are one gather advance in the port (``ops/partition.py
        advance_level``) at every depth."""
        paged = self.matrix(src)
        prevs = rows.to_shards(prev)

        def body(_, blocks, s, e, __):
            for d, page in enumerate(blocks):
                positions[d][s:e] = self._advance(paged, page,
                                                  positions[d][s:e], prevs[d])

        self._pass(src, rows.device, body, None)

    # -- leaf-wise steps ------------------------------------------------------
    def pair_hist(self, src, rows, gps, positions, i0: int, i1: int):
        """The two-node histogram of nodes ``i0`` / ``i1`` (-1: none) over
        the pages, every other row inactive, each shard's partial;
        K-target for [n, K, 2] gradients (the vector-leaf lossguide)."""
        def rel(pos):
            return torch.where(pos == i0, 0, torch.where(pos == i1, 1, 2)
                               ).to(torch.int32)

        return self._hist_over_pages(src, rows, gps, positions, None, rel, 2)

    def apply1(self, src, rows, positions, *args):
        """The leaf-wise one-node advance (``tree/lossguide.py apply1``'s
        arguments after ``positions``) over the pages, in place."""
        paged = self.matrix(src)
        shard_args = rows.to_shards(args)

        def body(_, blocks, s, e, __):
            for d, page in enumerate(blocks):
                positions[d][s:e] = apply1(page, positions[d][s:e],
                                           *shard_args[d],
                                           packed=paged.packed)

        self._pass(src, rows.device, body, None)
        return positions


class _MeshPageKernels(_PageKernels):
    """The per-page work of one pass over a data mesh (the JAX package's
    ``_MeshPageKernels``): a mesh page is one block of ``p_loc`` rows a
    shard, each on its shard's device (``data/binned.py
    PagedBinnedMatrix.stream_pages_sharded``), and the per-row vectors
    are one tensor a shard of ``n_loc`` rows. Each shard builds its
    block's histogram from its rows with its own quantiser scale (the
    JAX package's page body calls ``build_hist`` on the shard's slice
    with no axis name, so each (shard, page) block quantises with its
    own ``max|g|``; unlike the resident mesh, whose scale is the
    ``pmax`` over shards) and at its block's rows (what ``auto``'s
    kernel choice reads, as the JAX package's page body sees them); it
    adds its pages' builds into one partial for the whole pass, the
    cached pages and then the streamed ones, and the growers sum the
    shards' partials once a pass in shard order (:meth:`RowShards.
    reduce`, the JAX package's ``psum`` over ``acc[0]``)."""

    def _pass(self, src, device: torch.device, body, carry):
        """``carry = body(carry, blocks, s_loc, e_loc, uploaded)`` over
        every mesh page (the JAX package's ``_MeshPageKernels._drive``):
        the mesh cache's pages, then the others through the ring
        (``cached_split_mesh`` taken when the pass starts)."""
        paged, mesh = src.paged, src.mesh
        cached, streamed = paged.cached_split_mesh(mesh)
        for s, e, blocks in cached:
            carry = body(carry, blocks, s, e, False)
        for s, e, blocks in paged.stream_pages_sharded(streamed, mesh):
            carry = body(carry, blocks, s, e, True)
            del blocks  # the ring's next upload may take their place
        return carry

    @staticmethod
    def matrix(src):
        return src.paged

    def rows(self, src, n: int, device: torch.device) -> RowShards:
        """The mesh layout: ``n_loc`` rows a shard on its device; ``n``
        must be ``n_pad``."""
        n_pad, n_loc, _ = src.layout
        if n != n_pad:
            raise ValueError(f"{n} gradient rows for a paged mesh layout "
                             f"of {n_pad} rows")
        return RowShards.blocks(n_loc, src.mesh.devices)

    def page_rows(self, src, n: int) -> int:
        return src.layout[2]


def _make_kernels(grower, src) -> _PageKernels:
    """The page kernels of ``src`` (the JAX package's ``_make_kernels``):
    a paged matrix over a mesh gets :class:`_MeshPageKernels`, one
    device :class:`_PageKernels`, each made once a grower."""
    mesh = isinstance(src, PagedMeshMatrix)
    pk = grower._mk if mesh else grower._pk
    if pk is None:
        cls = _MeshPageKernels if mesh else _PageKernels
        pk = cls(grower.max_nbins, grower.hist_method, grower.has_missing,
                 numeric=not grower.cuts.is_cat().any())
        if mesh:
            grower._mk = pk
        else:
            grower._pk = pk
    return pk


def _check_rows(paged, n: int) -> None:
    if n != paged.n_rows:
        raise ValueError(f"{n} gradient rows for a matrix of "
                         f"{paged.n_rows} rows")


class _PagedLevels:
    """The depthwise level loop over pages, shared by :class:`PagedGrower`
    and :class:`PagedMultiTargetGrower` (vector leaves: ``multi``)."""

    multi = False

    def _init_pages(self) -> None:
        self._pk = self._mk = None

    def _grow_pages(self, src, gpair: torch.Tensor,
                    masks: Optional[List[torch.Tensor]]) -> GrownTree:
        param = self.param
        n = gpair.shape[0]
        dev = gpair.device
        pk = _make_kernels(self, src)
        rows = pk.rows(src, n, dev)
        two_level = is_two_level(self.hist_method)
        page_rows = pk.page_rows(src, n)
        for depth in range(param.max_depth):  # refuse an unported method
            resolve_hist_kernel(pk.hist_method, page_rows, 2 ** depth,
                                self.max_nbins, self.has_missing, pk.numeric)
        n_real = self._n_real_on(dev)
        monotone, sets = self.constraints_on(dev)
        cat = None if self.multi else self.cat_on(dev)
        n_real_slots = (self.max_nbins - 1 if self.has_missing
                        else self.max_nbins)
        gps = rows.split(gpair)
        root = rows.reduce([sum_in_xla_order(g, 0) if self.multi
                            else g.sum(dim=0) for g in gps])
        tree = HeapTree(
            param.max_depth, host_allreduce(root, label="paged/root-sum"),
            param, n_words=0 if cat is None else (n_real_slots - 1) // 32 + 1,
            monotone=None if self.multi else monotone, constraint_sets=sets)
        positions = pk.init_positions(rows)
        prev = None
        for depth in range(param.max_depth):
            lo, n_level = 2 ** depth - 1, 2 ** depth
            parent = tree.node_sum[lo:lo + n_level]
            fmask, mono_kw = tree.constraint_args(
                lo, n_level, None if masks is None else masks[depth])
            if two_level:
                res = self._two_level_level(src, rows, gps, positions, prev,
                                            lo, n_level, parent, n_real,
                                            fmask, mono_kw, depth)
            else:
                with _trace.span("paged/hist", args=_depth_args(depth)):
                    parts = (pk.level_hist(src, rows, gps, positions, lo,
                                           n_level) if prev is None
                             else pk.adv_hist(src, rows, gps, positions,
                                              prev, lo, n_level))
                    _trace.sync(parts)
                with _trace.span("paged/exchange"):
                    hist = host_allreduce(rows.reduce(parts))
                    del parts
                    _trace.sync(hist)
                with _trace.span("paged/eval"):
                    if self.multi:
                        res = evaluate_splits_multi(
                            hist, parent, n_real, param,
                            has_missing=self.has_missing, feature_mask=fmask)
                    else:
                        res = evaluate_splits(
                            hist, parent, n_real, param,
                            has_missing=self.has_missing, feature_mask=fmask,
                            cat=cat, **mono_kw)
                    del hist
                    _trace.sync(res)
            prev = tree.level_splits(lo, n_level,
                                     tree.record(lo, n_level, res))
            _mem.sample("paged/level")
        if prev is not None:
            with _trace.span("paged/advance"):
                pk.final_advance(src, rows, positions, prev)
                _trace.sync(positions)
        with _trace.span("paged/fetch"):
            g = tree.finish(rows.gather(positions))
            if param.max_leaves > 0:
                g = self._truncate_max_leaves(g)
        return g

    def _two_level_level(self, src, rows, gps, positions, prev, lo, n_level,
                         parent, n_real, fmask, mono_kw, depth):
        """One level of the page-major two-level schedule (module
        docstring) -> its split search."""
        pk = _make_kernels(self, src)
        with _trace.span("paged/hist", args=_depth_args(depth)):
            parts_c, parts_f = pk.coarse_pass(src, rows, gps, positions,
                                              prev, lo, n_level)
            _trace.sync(parts_f)
        with _trace.span("paged/exchange"):
            hist_c = host_allreduce(rows.reduce(parts_c))
            del parts_c
        with _trace.span("paged/window"):
            span = choose_refine_window(hist_c, parent, n_real, self.param,
                                        self.has_missing)
            _trace.sync(span)
        with _trace.span("paged/refine"):
            parts_r = pk.refine_pass(rows, parts_f, span)
            del parts_f
        with _trace.span("paged/exchange"):
            hist_r = host_allreduce(rows.reduce(parts_r))
            del parts_r
        with _trace.span("paged/eval"):
            hist, n_real_eval = assemble_two_level(hist_c, hist_r, span,
                                                   n_real, self.has_missing)
            res = evaluate_splits(hist, parent, n_real_eval, self.param,
                                  has_missing=self.has_missing,
                                  feature_mask=fmask, **mono_kw)
            span_sel = torch.gather(span, 1,
                                    res.feature.clamp(min=0)[:, None])
            res = res._replace(bin=decode_two_level_bin(res.bin,
                                                        span_sel[:, 0]))
            _trace.sync(res)
        return res


class PagedGrower(_PagedLevels, TreeGrower):
    """Grows one tree from a ``PagedBinnedMatrix``, or from one over a
    mesh (``PagedMeshMatrix``; module docstring)."""

    def __init__(self, param, max_nbins: int, cuts, hist_method: str = "auto",
                 has_missing: bool = True, monotone=None,
                 constraint_sets=None) -> None:
        super().__init__(param, max_nbins, cuts, hist_method=hist_method,
                         has_missing=has_missing, monotone=monotone,
                         constraint_sets=constraint_sets)
        if is_two_level(hist_method) and (
                cuts.is_cat().any()
                or max_nbins > 256 + int(has_missing)):
            raise NotImplementedError(
                f"hist_method='{_base(hist_method)}' supports numeric "
                "features and max_bin <= 256")
        self._init_pages()

    def grow(self, paged, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from the paged matrix and gpair [n, 2] f32 on the
        device ([n_pad, 2] on the first shard's device over a mesh);
        ``masks`` as :meth:`TreeGrower.grow`'s."""
        return self._grow_pages(paged, gpair, masks)


class PagedMultiTargetGrower(_PagedLevels, MultiTargetGrower):
    """Depthwise vector-leaf growth over pages (the JAX package's
    ``PagedMultiTargetGrower``): the level loop with K-target page
    builds, the split search of ``evaluate_splits_multi``."""

    multi = True

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._init_pages()

    def grow(self, paged, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from gpair [n, K, 2]; ``masks`` from
        :meth:`feature_masks`, or None."""
        return self._grow_pages(paged, gpair, masks)


def _refuse_paged_two_level(hist_method: str) -> None:
    """Leaf-wise growth on pages builds the pair in one pass, as the JAX
    package's paged lossguide growers do."""
    if is_two_level(hist_method):
        raise NotImplementedError(
            f"hist_method={hist_method!r} with grow_policy=lossguide runs on "
            "resident matrices only (the paged per-split kernels use the "
            "one-pass build)")


class _PagedPairs:
    """The leaf-wise grower's two steps over pages (module docstring)."""

    def _init_pages(self) -> None:
        _refuse_paged_two_level(self.hist_method)
        self._pk = self._mk = None
        self._page_rows: Optional[RowShards] = None

    def _rows(self, src, gpair: torch.Tensor):
        """``LossguideGrower._rows`` over pages: the matrix, each shard's
        gradients and row nodes (one device: one shard), the root's sums
        over the shards and across the ranks, and the rows of a shard's
        page."""
        pk = _make_kernels(self, src)
        n = gpair.shape[0]
        rows = self._page_rows = pk.rows(src, n, gpair.device)
        gps = rows.split(gpair)
        root = rows.reduce([self._root(g) for g in gps])
        return (src, gps, pk.init_positions(rows),
                host_allreduce(root, label="paged/root-sum"),
                pk.page_rows(src, n), {})

    def _final(self, src, positions) -> torch.Tensor:
        return self._page_rows.gather(positions)

    def _apply1(self, src, positions, *args):
        return _make_kernels(self, src).apply1(src, self._page_rows,
                                               positions, *args)

    def _pair_hist(self, src, gps, positions, i0, i1):
        """The pair's histogram over this rank's pages, summed over the
        shards and across the ranks."""
        parts = _make_kernels(self, src).pair_hist(src, self._page_rows, gps,
                                                   positions, i0, i1)
        return host_allreduce(self._page_rows.reduce(parts))


class PagedLossguideGrower(_PagedPairs, LossguideGrower):
    """Leaf-wise growth over pages (the JAX package's
    ``PagedLossguideGrower``): ``LossguideGrower.grow``'s loop with the
    pair's histogram and the popped node's advance streamed."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._init_pages()

    def _eval2(self, paged, gps, positions, i0, i1, psums, fmask, n_real,
               *, cat=None, monotone=None, node_lower=None, node_upper=None,
               **_):
        hist = self._pair_hist(paged, gps, positions, i0, i1)
        return evaluate_splits(hist, psums, n_real, self.param,
                               has_missing=self.has_missing,
                               feature_mask=fmask, cat=cat, monotone=monotone,
                               node_lower=node_lower, node_upper=node_upper)


class PagedMultiLossguideGrower(_PagedPairs, MultiLossguideGrower):
    """Leaf-wise vector-leaf growth over pages (the JAX package's
    ``PagedMultiLossguideGrower``): the K-target pair build streamed."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._init_pages()

    def _eval2(self, paged, gps, positions, i0, i1, psums, fmask, n_real,
               **_):
        hist = self._pair_hist(paged, gps, positions, i0, i1)
        return evaluate_splits_multi(hist, psums, n_real, self.param,
                                     has_missing=self.has_missing,
                                     feature_mask=fmask)
