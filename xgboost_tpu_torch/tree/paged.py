"""External-memory tree growth: the depthwise level loop over streamed
bin pages.

The port of the JAX package's ``tree/paged.py`` on one device
(``_PageKernels``, ``PagedGrower.grow``'s one-pass depthwise schedule):
the quantized matrix stays in host memory (``data/binned.py
PagedBinnedMatrix``) and each level is one pass over its row pages,
cached pages first and then the pages the prefetch ring uploads, in
page order. The root's pass builds the histogram; every later pass
advances the rows below the previous level's splits and builds this
level's histogram from the same read of a page (``adv_hist``); a last
pass advances below the deepest splits (``final_advance``). Gradients
and positions stay on the device; a pass updates the positions of a
page in place.

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

The level bookkeeping is ``tree/grow.py HeapTree``, shared with the
resident grower; evaluation takes the round's feature masks as there.
The JAX package also stops a tree's passes one level after a level
with no split; the port runs every level (a level without active nodes
splits nothing, so the tree is the same).

Not in the port yet (each raises): the paged two-level schedules
(``coarse``, ``fused``, ``scan``, ``mega``), categorical features,
lossguide, ``max_leaves`` and constraints (ROADMAP A.7), multi-output
(A.5.7), and the paged mesh tier (A.8).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.histogram import build_hist, resolve_hist_kernel
from ..ops.partition import LevelSplits, advance_level, level_rel
from ..ops.split import evaluate_splits
from .grow import GrownTree, HeapTree, TreeGrower

_PAGED_UNPORTED = ("coarse", "fused", "scan", "mega")


def _advance_rows(paged, page: torch.Tensor, pos_pg: torch.Tensor,
                  prev: LevelSplits) -> torch.Tensor:
    """One page's advance below ``prev``'s splits (the JAX package's
    ``_advance_rows``), reading packed pages' nibbles."""
    return advance_level(page, pos_pg, prev, paged.missing_bin,
                         packed=paged.packed)


class _PageKernels:
    """The per-page work of one pass, single device (the JAX package's
    ``_PageKernels``; ``_make_kernels`` there, for one chip)."""

    def __init__(self, max_nbins: int, hist_method: str,
                 has_missing: bool) -> None:
        self.max_nbins = max_nbins
        self.hist_method = hist_method
        self.has_missing = has_missing

    @staticmethod
    def _drive(paged, device: torch.device, body, carry):
        """``carry = body(carry, page, start, end)`` over every page: the
        cached pages, then the others through the ring (page order; the
        split is fixed when the pass starts)."""
        cached, streamed = paged.cached_split(device)
        for s, e, page in cached:
            carry = body(carry, page, s, e)
        for s, e, page in paged.stream_pages(streamed, device):
            carry = body(carry, page, s, e)
        return carry

    def _hist(self, paged, page, gp, rel, n_level) -> torch.Tensor:
        if gp.data_ptr() % 16:       # the kernels take 16-byte aligned rows
            gp = gp.clone()
        return build_hist(page, gp, rel, n_level, self.max_nbins,
                          method=self.hist_method,
                          has_missing=self.has_missing,
                          packed_u4=paged.n_features if paged.packed else 0)

    def _zeros(self, paged, gpair, n_level) -> torch.Tensor:
        return torch.zeros((n_level, paged.n_features, self.max_nbins, 2),
                           dtype=torch.float32, device=gpair.device)

    def level_hist(self, paged, gpair: torch.Tensor, positions: torch.Tensor,
                   lo: int, n_level: int) -> torch.Tensor:
        """The histogram of the level of ``n_level`` nodes from heap node
        ``lo`` (the root's pass)."""
        def body(acc, page, s, e):
            rel = level_rel(positions[s:e], lo, n_level)
            return acc.add_(self._hist(paged, page, gpair[s:e], rel,
                                       n_level))

        return self._drive(paged, gpair.device, body,
                           self._zeros(paged, gpair, n_level))

    def adv_hist(self, paged, gpair: torch.Tensor, positions: torch.Tensor,
                 prev: LevelSplits, lo: int, n_level: int) -> torch.Tensor:
        """One read of each page: advance its rows below ``prev``'s splits
        (``positions`` updated in place), then add its histogram of this
        level."""
        def body(acc, page, s, e):
            pos = _advance_rows(paged, page, positions[s:e], prev)
            positions[s:e] = pos
            rel = level_rel(pos, lo, n_level)
            return acc.add_(self._hist(paged, page, gpair[s:e], rel,
                                       n_level))

        return self._drive(paged, gpair.device, body,
                           self._zeros(paged, gpair, n_level))

    def final_advance(self, paged, positions: torch.Tensor,
                      prev: LevelSplits) -> None:
        """The advance below the deepest splits (``positions`` in place)."""
        def body(_, page, s, e):
            positions[s:e] = _advance_rows(paged, page, positions[s:e], prev)

        self._drive(paged, positions.device, body, None)


class PagedGrower(TreeGrower):
    """Grows one tree from a ``PagedBinnedMatrix`` (module docstring)."""

    def __init__(self, param, max_nbins: int, cuts, hist_method: str = "auto",
                 has_missing: bool = True, monotone=None,
                 constraint_sets=None) -> None:
        # the resident grower takes these; the paged tier does not yet, and
        # must not inherit them and grow unconstrained trees
        for asked, what in (
                (param.grow_policy == "lossguide", "grow_policy=lossguide"),
                (param.max_leaves > 0, "max_leaves > 0"),
                (monotone is not None or constraint_sets is not None,
                 "monotone and interaction constraints")):
            if asked:
                raise NotImplementedError(
                    f"{what} on a paged (external-memory) matrix is not in "
                    "the PyTorch port yet (paged lossguide, constraints "
                    "and max_leaves, ROADMAP A.7)")
        base = hist_method[:-len("+nosub")] if hist_method.endswith(
            "+nosub") else hist_method
        if base in _PAGED_UNPORTED:
            raise NotImplementedError(
                f"hist_method={hist_method!r} on a paged (external-memory) "
                "matrix is not in the PyTorch port yet (the paged two-level "
                "schedules, ROADMAP A.7)")
        if cuts.is_cat().any():
            raise NotImplementedError(
                "categorical features on a paged (external-memory) matrix "
                "are not in the PyTorch port yet (ROADMAP A.7)")
        super().__init__(param, max_nbins, cuts, hist_method=hist_method,
                         has_missing=has_missing)
        self._pk = _PageKernels(max_nbins, hist_method, has_missing)

    def grow(self, paged, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from the paged matrix and gpair [n, 2] f32 on the
        device; ``masks`` as :meth:`TreeGrower.grow`'s."""
        param = self.param
        n = gpair.shape[0]
        if n != paged.n_rows:
            raise ValueError(f"{n} gradient rows for a matrix of "
                             f"{paged.n_rows} rows")
        page_rows = min(paged.page_rows, max(n, 1))
        for depth in range(param.max_depth):  # refuse an unported method
            resolve_hist_kernel(self.hist_method, page_rows, 2 ** depth,
                                self.max_nbins, self.has_missing)
        dev = gpair.device
        n_real = self._n_real_on(dev)
        pk = self._pk
        tree = HeapTree(param.max_depth, gpair.sum(dim=0), param)
        positions = torch.zeros((n,), dtype=torch.int64, device=dev)
        prev = None
        for depth in range(param.max_depth):
            lo, n_level = 2 ** depth - 1, 2 ** depth
            if prev is None:
                hist = pk.level_hist(paged, gpair, positions, lo, n_level)
            else:
                hist = pk.adv_hist(paged, gpair, positions, prev, lo,
                                   n_level)
            res = evaluate_splits(
                hist, tree.node_sum[lo:lo + n_level], n_real, param,
                has_missing=self.has_missing,
                feature_mask=None if masks is None else masks[depth])
            prev = tree.level_splits(lo, n_level,
                                     tree.record(lo, n_level, res))
        if prev is not None:
            pk.final_advance(paged, positions, prev)
        return tree.finish(positions)
