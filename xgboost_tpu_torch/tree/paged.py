"""External-memory tree growth: the level loop over streamed bin pages.

The port of the JAX package's ``tree/paged.py`` on one device
(``_PageKernels``, ``PagedGrower``, ``PagedLossguideGrower``,
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
two-level pass's coarse and fine, a leaf-wise pair's) and the root's
sums are summed across the ranks on the host
(``tree/shards.py host_allreduce``, the JAX package's
``_host_allreduce``), so every rank grows the same tree. A page's
int8x2 scale stays its own, as in the JAX package.

Not in the port yet (each raises): sibling subtraction (ROADMAP A.6) and
the paged mesh tier (A.8).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.histogram import build_hist, build_hist_multi, resolve_hist_kernel
from ..ops.partition import LevelSplits, advance_level, level_rel
from ..ops.split import (COARSE_B, assemble_two_level,
                         choose_refine_window, coarse_bin_ids,
                         decode_two_level_bin, evaluate_splits,
                         evaluate_splits_multi, refine_from_fine)
from ..ops.xla_order import sum_in_xla_order
from .grow import GrownTree, HeapTree, TreeGrower
from .lossguide import LossguideGrower, apply1
from .multi import MultiLossguideGrower, MultiTargetGrower
from .shards import aligned, host_allreduce

TWO_LEVEL = ("coarse", "fused", "scan", "mega")


def _base(hist_method: str) -> str:
    return hist_method[:-len("+nosub")] if hist_method.endswith(
        "+nosub") else hist_method


def is_two_level(hist_method: str) -> bool:
    return _base(hist_method) in TWO_LEVEL


def page_method(hist_method: str) -> str:
    """The page builds' method (the JAX package's ``_make_kernels``): the
    two-level names run plain builds through ``auto``; ``+sub`` keeps its
    refusal (ROADMAP A.6)."""
    return "auto" if is_two_level(hist_method) else hist_method


class _PageKernels:
    """The per-page work of one pass, single device (the JAX package's
    ``_PageKernels``; ``_make_kernels`` there, for one chip)."""

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

    def _zeros(self, paged, gpair, n_nodes, nbins=None) -> torch.Tensor:
        shape = ((n_nodes, paged.n_features, nbins or self.max_nbins)
                 + tuple(gpair.shape[1:]))
        return torch.zeros(shape, dtype=torch.float32, device=gpair.device)

    def _advance(self, paged, page, pos_pg, prev: LevelSplits):
        """One page's advance below ``prev``'s splits (the JAX package's
        ``_advance_rows``), reading packed pages' nibbles."""
        return advance_level(page, pos_pg, prev, self.missing_bin,
                             packed=paged.packed)

    def adv_hist(self, paged, gpair: torch.Tensor, positions: torch.Tensor,
                 prev: Optional[LevelSplits], lo: int,
                 n_level: int) -> torch.Tensor:
        """One read of each page: advance its rows below ``prev``'s splits
        (when given: not at the root; ``positions`` updated in place),
        then add its histogram of the level of ``n_level`` nodes from heap
        node ``lo``."""
        def body(acc, page, s, e, _):
            pos = positions[s:e]
            if prev is not None:
                pos = self._advance(paged, page, pos, prev)
                positions[s:e] = pos
            rel = level_rel(pos, lo, n_level)
            return acc.add_(self._hist(paged, page, gpair[s:e], rel,
                                       n_level))

        return self._drive(paged, gpair.device, body,
                           self._zeros(paged, gpair, n_level))

    # -- the page-major two-level schedule (module docstring) -----------------
    def two_level_pass(self, paged, gpair: torch.Tensor,
                       positions: torch.Tensor, prev: Optional[LevelSplits],
                       lo: int, n_level: int):
        """A level's one pass: each page advanced below ``prev``'s splits
        (when given; ``positions`` in place), then its coarse and its fine
        histogram added. -> (the level's coarse histogram
        [N, F, COARSE_B, 2], its fine one [N, F, B, 2])."""
        mb = self.missing_bin

        def body(acc, page, s, e, _):
            hist_c, hist_f = acc
            pos = positions[s:e]
            if prev is not None:
                pos = self._advance(paged, page, pos, prev)
                positions[s:e] = pos
            rel = level_rel(pos, lo, n_level)
            gp = aligned(gpair[s:e])
            hist_c.add_(build_hist(coarse_bin_ids(paged.decode_page(page),
                                                  mb),
                                   gp, rel, n_level, COARSE_B))
            hist_f.add_(self._hist(paged, page, gp, rel, n_level))
            return acc

        return self._drive(paged, gpair.device, body,
                           (self._zeros(paged, gpair, n_level, COARSE_B),
                            self._zeros(paged, gpair, n_level)))

    def final_advance(self, paged, positions: torch.Tensor,
                      prev: LevelSplits) -> None:
        """The advance below the deepest splits (``positions`` in place)."""
        def body(_, page, s, e, __):
            positions[s:e] = self._advance(paged, page, positions[s:e], prev)

        self._drive(paged, positions.device, body, None)

    # -- leaf-wise steps ------------------------------------------------------
    def pair_hist(self, paged, gpair: torch.Tensor, positions: torch.Tensor,
                  i0: int, i1: int) -> torch.Tensor:
        """The two-node histogram of nodes ``i0`` / ``i1`` (-1: none) over
        the pages, every other row inactive; K-target for [n, K, 2]
        gradients (the vector-leaf lossguide)."""
        def body(acc, page, s, e, _):
            pos = positions[s:e]
            rel = torch.where(pos == i0, 0, torch.where(pos == i1, 1, 2)).to(
                torch.int32)
            return acc.add_(self._hist(paged, page, gpair[s:e], rel, 2))

        return self._drive(paged, gpair.device, body,
                           self._zeros(paged, gpair, 2))

    def apply1(self, paged, positions: torch.Tensor, *args) -> torch.Tensor:
        """The leaf-wise one-node advance (``tree/lossguide.py apply1``'s
        arguments after ``positions``) over the pages, in place."""
        def body(_, page, s, e, __):
            positions[s:e] = apply1(page, positions[s:e], *args,
                                    packed=paged.packed)

        self._drive(paged, positions.device, body, None)
        return positions


def _check_rows(paged, n: int) -> None:
    if n != paged.n_rows:
        raise ValueError(f"{n} gradient rows for a matrix of "
                         f"{paged.n_rows} rows")


class _PagedLevels:
    """The depthwise level loop over pages, shared by :class:`PagedGrower`
    and :class:`PagedMultiTargetGrower` (vector leaves: ``multi``)."""

    multi = False

    def _init_pages(self) -> None:
        self._pk = _PageKernels(self.max_nbins, self.hist_method,
                                self.has_missing,
                                numeric=not self.cuts.is_cat().any())

    def _grow_pages(self, paged, gpair: torch.Tensor,
                    masks: Optional[List[torch.Tensor]]) -> GrownTree:
        param = self.param
        n = gpair.shape[0]
        _check_rows(paged, n)
        dev = gpair.device
        pk = self._pk
        two_level = is_two_level(self.hist_method)
        page_rows = min(paged.page_rows, max(n, 1))
        for depth in range(param.max_depth):  # refuse an unported method
            resolve_hist_kernel(pk.hist_method, page_rows, 2 ** depth,
                                self.max_nbins, self.has_missing, pk.numeric)
        n_real = self._n_real_on(dev)
        monotone, sets = self.constraints_on(dev)
        cat = None if self.multi else self.cat_on(dev)
        n_real_slots = (self.max_nbins - 1 if self.has_missing
                        else self.max_nbins)
        tree = HeapTree(
            param.max_depth,
            host_allreduce(sum_in_xla_order(gpair, 0) if self.multi
                           else gpair.sum(dim=0), label="paged/root-sum"),
            param, n_words=0 if cat is None else (n_real_slots - 1) // 32 + 1,
            monotone=None if self.multi else monotone, constraint_sets=sets)
        positions = torch.zeros((n,), dtype=torch.int64, device=dev)
        prev = None
        for depth in range(param.max_depth):
            lo, n_level = 2 ** depth - 1, 2 ** depth
            parent = tree.node_sum[lo:lo + n_level]
            fmask, mono_kw = tree.constraint_args(
                lo, n_level, None if masks is None else masks[depth])
            if two_level:
                res = self._two_level_level(paged, gpair, positions, prev,
                                            lo, n_level, parent, n_real,
                                            fmask, mono_kw)
            else:
                hist = host_allreduce(pk.adv_hist(paged, gpair, positions,
                                                  prev, lo, n_level))
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
            prev = tree.level_splits(lo, n_level,
                                     tree.record(lo, n_level, res))
        if prev is not None:
            pk.final_advance(paged, positions, prev)
        g = tree.finish(positions)
        if param.max_leaves > 0:
            g = self._truncate_max_leaves(g)
        return g

    def _two_level_level(self, paged, gpair, positions, prev, lo, n_level,
                         parent, n_real, fmask, mono_kw):
        """One level of the page-major two-level schedule (module
        docstring) -> its split search."""
        hist_c, hist_f = (host_allreduce(h) for h in self._pk.two_level_pass(
            paged, gpair, positions, prev, lo, n_level))
        span = choose_refine_window(hist_c, parent, n_real, self.param,
                                    self.has_missing)
        hist_r = refine_from_fine(hist_f, span, self._pk.missing_bin)
        del hist_f
        hist, n_real_eval = assemble_two_level(hist_c, hist_r, span, n_real,
                                               self.has_missing)
        res = evaluate_splits(hist, parent, n_real_eval, self.param,
                              has_missing=self.has_missing,
                              feature_mask=fmask, **mono_kw)
        span_sel = torch.gather(span, 1, res.feature.clamp(min=0)[:, None])
        return res._replace(bin=decode_two_level_bin(res.bin, span_sel[:, 0]))


class PagedGrower(_PagedLevels, TreeGrower):
    """Grows one tree from a ``PagedBinnedMatrix`` (module docstring)."""

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
        device; ``masks`` as :meth:`TreeGrower.grow`'s."""
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
        self._pk = _PageKernels(self.max_nbins, self.hist_method,
                                self.has_missing,
                                numeric=not self.cuts.is_cat().any())

    def _rows(self, paged, gpair: torch.Tensor):
        """``LossguideGrower._rows`` over pages: the matrix, the whole
        gradients and row nodes as the one entry of their lists, and the
        root's sums across the ranks."""
        return (paged, [gpair], [torch.zeros((gpair.shape[0],),
                                             dtype=torch.int64,
                                             device=gpair.device)],
                host_allreduce(self._root(gpair), label="paged/root-sum"),
                paged.shape[0], {})

    @staticmethod
    def _final(paged, positions) -> torch.Tensor:
        return positions[0]

    def _apply1(self, paged, positions, *args):
        _check_rows(paged, positions[0].shape[0])
        return [self._pk.apply1(paged, positions[0], *args)]

    def _pair_hist(self, paged, gps, positions, i0, i1):
        """The pair's histogram over this rank's pages, summed across the
        ranks."""
        return host_allreduce(self._pk.pair_hist(paged, gps[0], positions[0],
                                                 i0, i1))


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
