"""Leaf-wise (best-first) tree growing: ``grow_policy="lossguide"``.

The port of the JAX package's ``tree/lossguide.py`` on one device
(reference ``Driver`` with ``LossGuide`` ordering,
``src/tree/driver.h``): the candidate with the largest loss change is
popped one at a time (a heap keyed by ``(-gain, push order)``),
``max_leaves`` caps the leaves and ``max_depth=0`` leaves the depth
unbounded. The tree lives on the host in compact arrays, ids in
allocation order (every parent before its children); the device holds
each row's node (``positions``). Each split runs two steps on the device:
the popped node's rows move to its two new children (:func:`apply1`),
then the children's histograms are built in one pass, every other row
inactive (N = 2), and their best splits found (:func:`eval2`). One
packed copy of the two results comes to the host a split.

``hist_method``: ``auto`` and the K2/K3 names keep the exact search, and
the histogram's kernel is whatever ``ops/histogram.py
resolve_hist_kernel`` gives N = 2: K4 (the sorted build) from 65,536
rows at 128 to 256 bins on numeric data, K2 below. (The TPU's ``auto``
would promote lossguide to its two-level schedules; the port keeps the
exact search, as its depthwise ``auto`` does.) ``coarse``, ``fused`` and
``scan`` run the two-level search of ``tree/grow.py search_splits`` on
the pair. The JAX package's ``fused`` differs from its ``coarse`` only in
dispatching the advance and the evaluation as one program
(``_apply_eval2``, the same numerics); eager calls have no such
boundary, so here the two run the same calls. On categorical data or
more than 256 bins they warn and fall back to ``auto``, as the JAX
package's do. ``mega`` raises (ROADMAP A.6).

The grower's state is one shape whatever holds the bins: a list of
gradients and a list of row nodes, one entry a shard (:meth:`_rows`).
Under a data mesh (``tree/shards.py RowShards``) each shard keeps its
rows' nodes; the pair's histogram is built on every shard and summed
over them (the JAX package's four ``psum``s of a pair, one a build),
the root's sums likewise, and the popped node's advance runs on every
shard. A paged matrix is one entry (``tree/paged.py``). Over a column
mesh (``ColShards``, the JAX package's ``_eval2_col`` / ``_apply1_col``)
each shard searches the pair over its own features and the best-split
exchange picks each node's winner; the popped node's rows move on the
shard that owns its split feature, whose decisions go to every shard
(every other shard's bits are zero, so they are the OR of all).

Column samples are drawn on the host from ``np.random.RandomState(seed &
0x7FFFFFFF)``, ``seed`` the last word of the tree's key, in the order the
nodes are evaluated (:func:`col_masks`). Monotone constraints keep each
node's weight interval on the host; the children's bounds come from
their weights computed as the JAX package computes them there (the
division in float64, one rounding to f32; :func:`host_weight`) and are
stored in f32. Interaction constraints keep each node's path.
"""

from __future__ import annotations

import heapq
import math
import warnings
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.histogram import resolve_hist_kernel
from ..ops.partition import cat_goes_right, gather_bins
from ..ops.split import CatInfo, SplitResult, coarse_bin_ids
from ..utils import random as xrandom
from .grow import (TreeGrower, interaction_allowed_host, search_splits,
                   two_level_schedule)
from .param import TrainParam, _f32, calc_weight
from .shards import ColShards, RowShards
from .tree import TreeModel

_EPS = 1e-6  # reference kRtEps


class LossguideGrown(NamedTuple):
    """A grown leaf-wise tree: each row's node and leaf value on the
    device, and the finished tree."""

    positions: torch.Tensor     # [n] int64 compact node id per row
    delta: torch.Tensor         # [n] f32 leaf value per row
    tree: TreeModel


def pair_rel(positions: torch.Tensor, id0: int, id1: int) -> torch.Tensor:
    """Each row's slot in a pair's histogram: 0 at node ``id0``, 1 at
    ``id1``, 2 (inactive) elsewhere."""
    return torch.where(positions == id0, 0,
                       torch.where(positions == id1, 1, 2)).to(torch.int32)


def eval2(rows: RowShards, gps, positions, id0: int, id1: int, parent_sums,
          fmask, n_real_bins, *, param: TrainParam, max_nbins: int,
          hist_method: str, has_missing: bool, schedule: Optional[str],
          cbs=None, cat: Optional[CatInfo] = None, scale=None,
          **monotone_kw) -> SplitResult:
    """The best splits of nodes ``id0`` and ``id1`` (-1: none) from one
    histogram build over every row, the others inactive (the JAX
    package's ``_eval2``), on every shard of ``rows`` (each shard's
    gradients ``gps`` and nodes ``positions``) and summed over them:
    parent_sums [2, 2] f32, fmask [2, F] bool."""
    return search_splits(rows, gps, [pair_rel(p, id0, id1)
                                     for p in positions], 2, parent_sums,
                         n_real_bins, param=param, max_nbins=max_nbins,
                         hist_method=hist_method, has_missing=has_missing,
                         schedule=schedule, cbs=cbs, feature_mask=fmask,
                         cat=cat, scale=scale, **monotone_kw)


def apply1(bins, positions, nid: int, feat: int, sbin: int, dleft: bool,
           is_cat: bool, words: Optional[torch.Tensor], left_id: int,
           right_id: int, missing_bin: int, packed: bool = False
           ) -> torch.Tensor:
    """The rows at node ``nid`` moved to its children ``left_id`` /
    ``right_id`` (the JAX package's ``_apply1``): right where the bin is
    above ``sbin`` (a categorical split: where the code is not in the
    left set ``words`` [W]), missing values the default way. ``packed``:
    ``bins`` is a u4-packed page."""
    rows = torch.arange(positions.shape[0], device=positions.device)
    b = gather_bins(bins, rows, torch.full_like(rows, max(feat, 0)), packed)
    if is_cat:
        go_right = cat_goes_right(b, words[None, :], torch.zeros_like(rows))
    else:
        go_right = b > sbin
    go_right = torch.where(b == missing_bin, torch.full_like(go_right,
                                                             not dleft),
                           go_right)
    child = torch.where(go_right, right_id, left_id)
    return torch.where(positions == nid, child, positions)


def col_masks(param: TrainParam, seed: int, F: int,
              base: Optional[np.ndarray] = None) -> Callable[[int],
                                                             np.ndarray]:
    """A tree's column sampler (the JAX package's ``col_masks``; reference
    ``ColumnSampler``): the tree's mask is drawn now from ``base`` (the
    features with real bins), a level's on its first node, and each call
    ``node_mask(depth)`` draws a node's from its level's, all from one
    ``np.random.RandomState(seed & 0x7FFFFFFF)`` in call order. A draw
    keeps ``max(1, ceil(frac * count))`` features; a fraction of 1 draws
    nothing."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)

    def draw(base: np.ndarray, frac: float) -> np.ndarray:
        if frac >= 1.0:
            return base
        idx = np.nonzero(base)[0]
        k = max(1, int(math.ceil(frac * len(idx))))
        keep = rng.choice(idx, size=min(k, len(idx)), replace=False)
        out = np.zeros(F, bool)
        out[keep] = True
        return out

    tree_mask = draw(np.ones(F, bool) if base is None
                     else np.asarray(base, bool), param.colsample_bytree)
    level_cache = {}

    def node_mask(depth: int) -> np.ndarray:
        if depth not in level_cache:
            level_cache[depth] = draw(tree_mask, param.colsample_bylevel)
        return draw(level_cache[depth], param.colsample_bynode)

    return node_mask


def host_weight(g: float, h: float, param: TrainParam) -> np.float32:
    """A node's weight from its float64 sums, as the JAX package's
    ``calc_weight`` computes it on host scalars with 64-bit types off:
    without ``alpha`` the division in float64 and one rounding to f32;
    with it the numerator in f32 over the f32 rounding of ``h +
    lambda``; zero where ``h <= 0``; clipped to ``max_delta_step`` in
    f32."""
    lam = param.reg_lambda
    if param.reg_alpha == 0.0:
        w = np.float32(-g / (h + lam))
    else:
        gf = np.float32(g)
        num = np.sign(gf) * np.maximum(np.abs(gf)
                                       - np.float32(param.reg_alpha),
                                       np.float32(0.0))
        w = np.float32(-num / np.float32(h + lam))
    if h <= 0.0:
        w = np.float32(0.0)
    if param.max_delta_step != 0.0:
        m = np.float32(param.max_delta_step)
        w = np.clip(w, -m, m)
    return w


def pack_result(res: SplitResult, n_words: int) -> torch.Tensor:
    """The fields of a pair's :class:`SplitResult` as one float64 tensor
    [2, 9 + W] (gain, feature, bin, default_left, left_sum, right_sum,
    is_cat, the left set's words; every value exact in float64), so that
    one copy brings a split's results to the host."""
    cols = [res.gain[:, None], res.feature[:, None], res.bin[:, None],
            res.default_left[:, None], res.left_sum, res.right_sum]
    if res.is_cat is None:
        cols.append(torch.zeros((2, 1 + n_words), dtype=torch.float64,
                                device=res.gain.device))
    else:
        cols += [res.is_cat[:, None], res.cat_words]
    return torch.cat([c.to(torch.float64) for c in cols], dim=1)


class LossguideGrower(TreeGrower):
    """Leaf-wise growth of one tree at a time (module docstring): the
    depthwise grower's tensors and column state, its own greedy loop."""

    def __init__(self, param: TrainParam, max_nbins: int, cuts,
                 hist_method: str = "auto", has_missing: bool = True,
                 monotone: Optional[Sequence[int]] = None,
                 constraint_sets: Optional[np.ndarray] = None,
                 feature_pad: int = 0) -> None:
        if param.max_leaves <= 0 and param.max_depth <= 0:
            raise ValueError(
                "grow_policy=lossguide needs max_leaves > 0 or max_depth > 0")
        super().__init__(param, max_nbins, cuts, hist_method=hist_method,
                         has_missing=has_missing, monotone=monotone,
                         constraint_sets=constraint_sets,
                         feature_pad=feature_pad)
        numeric = not cuts.is_cat().any()
        base = hist_method
        sfx = ""
        for s in ("+sub", "+nosub"):
            if base.endswith(s):
                base, sfx = base[:-len(s)], s
        if base == "mega":
            raise NotImplementedError(
                "hist_method='mega' with grow_policy=lossguide is not in the "
                "PyTorch port yet (lossguide's mega tier, ROADMAP A.6)")
        if base in ("coarse", "fused", "scan") and (
                not numeric or max_nbins > 256 + int(has_missing)):
            # the JAX package's warn-and-fall-back: an explicit two-level
            # request outside its preconditions trains with the exact search
            why = ("categorical features" if not numeric
                   else f"max_bin > 256 (max_nbins={max_nbins})")
            warnings.warn(
                f"hist_method='{base}' with grow_policy=lossguide supports "
                f"numeric features and max_bin <= 256; got {why} — falling "
                "back to the exact one-pass histogram (hist_method='auto')",
                UserWarning, stacklevel=3)
            base = "auto"
            self.hist_method = "auto" + sfx
        self.schedule = two_level_schedule(base, max_nbins, has_missing)
        self.n_words = ((max_nbins - int(has_missing) - 1) // 32 + 1
                        if not numeric else 1)

    @staticmethod
    def check_depth(param: TrainParam) -> None:
        """``max_depth`` 0 is no depth limit for leaf-wise growth."""

    def feature_masks(self, tkeys: Sequence[xrandom.Key],
                      device: torch.device) -> List[Callable]:
        """Each tree's column sampler (:func:`col_masks`) from the last
        word of its key, as the JAX package seeds it; its draws come as
        the tree's nodes are evaluated (a column mesh's pad columns have
        no real bin and take no draw)."""
        base = self.padded(self.cuts.n_real_bins()) > 0
        return [col_masks(self.param, k[1], len(base), base) for k in tkeys]

    def _eval2(self, rows, *args, **kwargs) -> SplitResult:
        """:func:`eval2` over resident shards (the paged grower's pass
        over the pages, ``tree/paged.py``)."""
        return eval2(rows, *args, **kwargs)

    def _apply1(self, rows, positions, nid, feat, *args):
        """:func:`apply1` on every shard (the paged grower's pass); over a
        column mesh on the shard that owns ``feat``, whose rows' nodes go
        to every shard (module docstring)."""
        if isinstance(rows, ColShards):
            s = feat // rows.f_local
            a = rows.to_shards(args)[s]
            moved = apply1(rows.parts[s], positions[s], nid,
                           feat - rows.offsets[s], *a)
            return rows.split(moved.to(rows.device))
        return [apply1(b, p, nid, feat, *a) for b, p, a in
                zip(rows.parts, positions, rows.to_shards(args))]

    @staticmethod
    def _root(gp: torch.Tensor) -> torch.Tensor:
        """A block of rows' gradient sums (the vector-leaf grower sums in
        the JAX package's order)."""
        return gp.sum(dim=0)

    def _rows(self, bins, gpair: torch.Tensor):
        """(the shards, each shard's gradients, each shard's row nodes, the
        root's sums, the rows ``auto``'s kernel choice reads, the quantiser
        keywords) over resident bins or a mesh's shards, row or column
        (the paged grower's, one entry a list: ``tree/paged.py``)."""
        rows = RowShards.of(bins)
        gps = rows.split(gpair)
        positions = [torch.zeros((b.shape[0],), dtype=torch.int64,
                                 device=b.device) for b in rows.parts]
        root = rows.reduce([self._root(g) for g in gps], "mesh/root-sum")
        return rows, gps, positions, root, rows.shard_rows, rows.scale(gps)

    def _feature_width(self, F: int) -> int:
        """The width of the column samples and interaction paths: the
        bins' (the vertical grower's: every party's features)."""
        return F

    @staticmethod
    def _final(rows, positions) -> torch.Tensor:
        """Each row's node over the local rows, in row order."""
        return rows.gather(positions)

    def grow(self, bins, gpair: torch.Tensor,
             node_mask: Callable[[int], np.ndarray]) -> LossguideGrown:
        """One tree from bins [n, F], a mesh's ``RowShards`` or a paged
        matrix (through :meth:`_eval2` / :meth:`_apply1`) and gpair
        [n, 2] f32 on the (first) device; ``node_mask``: its column
        sampler from :meth:`feature_masks`."""
        param = self.param
        F = self._feature_width(bins.shape[1])
        dev = gpair.device
        max_leaves = param.max_leaves if param.max_leaves > 0 else (
            2 ** max(param.max_depth, 1))
        cap = 2 * max_leaves - 1
        cat = self.cat_on(dev)
        rows, gps, positions, root, n_k, scale = self._rows(bins, gpair)
        # refuse an unported method before the loop
        resolve_hist_kernel(self.hist_method, n_k, 2, self.max_nbins,
                            self.has_missing, cat is None,
                            isinstance(rows, ColShards))
        n_real = self._n_real_on(dev)
        monotone, _ = self.constraints_on(dev)
        mono = self.monotone
        cons = (None if self.constraint_sets is None
                else self.padded(self.constraint_sets))
        mb = self.max_nbins - 1 if self.has_missing else self.max_nbins
        kw = dict(param=param, max_nbins=self.max_nbins,
                  hist_method=self.hist_method, has_missing=self.has_missing,
                  schedule=self.schedule, cat=cat, scale=scale,
                  cbs=([coarse_bin_ids(b, mb) for b in rows.parts]
                       if self.schedule in ("coarse", "fused") else None))

        # the tree's host arrays, ids in allocation order
        sf = np.full(cap, -1, np.int32)
        sb = np.zeros(cap, np.int32)
        dl = np.zeros(cap, bool)
        lc = np.full(cap, -1, np.int32)
        rc = np.full(cap, -1, np.int32)
        pa = np.full(cap, -1, np.int32)
        gn = np.zeros(cap, np.float32)
        gh = np.zeros((cap, 2), np.float64)
        ics = np.zeros(cap, bool)
        cwords = np.zeros((cap, self.n_words), np.uint32)
        depth_of = np.zeros(cap, np.int32)
        lower = np.full(cap, -np.inf, np.float32)
        upper = np.full(cap, np.inf, np.float32)
        paths = np.zeros((cap, F), bool) if cons is not None else None

        gh[0] = root.cpu().numpy()
        n_nodes, n_leaves, counter = 1, 1, 0
        pq: list = []       # (-gain, push order, node, split payload)
        min_gain = max(param.gamma, _EPS)

        def eval_nodes(id0: int, id1: int, apply_args=None) -> None:
            """Evaluate one or two sibling nodes and push their valid
            splits; ``apply_args``: the popped parent's advance, run
            first."""
            nonlocal counter, positions
            ids = [i for i in (id0, id1) if i >= 0]
            if param.max_depth > 0:
                ids = [i for i in ids if depth_of[i] < param.max_depth]
            if not ids:
                if apply_args is not None:
                    positions = self._apply1(rows, positions, *apply_args)
                return
            i0 = ids[0]
            i1 = ids[1] if len(ids) > 1 else -1
            fm = np.stack([node_mask(int(depth_of[i])) if i >= 0
                           else np.zeros(F, bool) for i in (i0, i1)])
            if paths is not None:
                # (the JAX package's ``_allowed`` lets every feature through
                # where no set holds the path; a path is built from allowed
                # features only, so some set always holds it)
                fm[0] &= interaction_allowed_host(paths[i0][None], cons)[0]
                if i1 >= 0:
                    fm[1] &= interaction_allowed_host(paths[i1][None],
                                                      cons)[0]
            psums = torch.from_numpy(np.stack(
                [gh[i0], gh[i1] if i1 >= 0 else np.zeros(2)]).astype(
                    np.float32)).to(dev)
            fm_t = torch.from_numpy(fm).to(dev)
            mono_kw = {}
            if mono is not None:
                j1 = i1 if i1 >= 0 else 0
                mono_kw = dict(
                    monotone=monotone,
                    node_lower=torch.from_numpy(np.asarray(
                        [lower[i0], lower[j1]], np.float32)).to(dev),
                    node_upper=torch.from_numpy(np.asarray(
                        [upper[i0], upper[j1]], np.float32)).to(dev))
            if apply_args is not None:
                positions = self._apply1(rows, positions, *apply_args)
            res = self._eval2(rows, gps, positions, i0, i1, psums, fm_t,
                              n_real, **kw, **mono_kw)
            host = pack_result(res, self.n_words).cpu().numpy()
            for slot, nid in ((0, i0), (1, i1)):
                if nid < 0:
                    continue
                g = float(np.float32(host[slot, 0]))
                if not np.isfinite(g) or g <= min_gain:
                    continue
                heapq.heappush(pq, (-g, counter, nid, host[slot].copy()))
                counter += 1

        eval_nodes(0, -1)
        while pq and n_leaves < max_leaves:
            neg_gain, _, nid, row = heapq.heappop(pq)
            feat, rbin, rdl = int(row[1]), int(row[2]), bool(row[3])
            lsum, rsum = row[4:6], row[6:8]
            ric = bool(row[8])
            rcw = row[9:9 + self.n_words].astype(np.uint32)
            li, ri = n_nodes, n_nodes + 1
            n_nodes += 2
            n_leaves += 1
            sf[nid], sb[nid], dl[nid] = feat, rbin, rdl
            gn[nid] = -neg_gain
            ics[nid] = ric
            cwords[nid] = rcw if ric else 0
            lc[nid], rc[nid] = li, ri
            pa[li] = pa[ri] = nid
            gh[li], gh[ri] = lsum, rsum
            depth_of[li] = depth_of[ri] = depth_of[nid] + 1
            if mono is not None:
                wl = float(np.clip(host_weight(lsum[0], lsum[1], param),
                                   lower[nid], upper[nid]))
                wr = float(np.clip(host_weight(rsum[0], rsum[1], param),
                                   lower[nid], upper[nid]))
                mid = 0.5 * (wl + wr)
                mc = int(mono[max(feat, 0)])
                lower[li] = mid if mc < 0 else lower[nid]
                upper[li] = mid if mc > 0 else upper[nid]
                lower[ri] = mid if mc > 0 else lower[nid]
                upper[ri] = mid if mc < 0 else upper[nid]
            else:
                lower[li] = lower[ri] = lower[nid]
                upper[li] = upper[ri] = upper[nid]
            if paths is not None:
                paths[li] = paths[ri] = paths[nid]
                paths[li, feat] = paths[ri, feat] = True
            words = (torch.from_numpy(rcw.astype(np.int64)).to(dev)
                     if ric else None)
            eval_nodes(li, ri, apply_args=(nid, feat, rbin, rdl, ric, words,
                                           li, ri, mb))

        # the weights: f32 from the f32 sums, clipped into each node's
        # interval, times eta
        w = calc_weight(torch.from_numpy(gh[:n_nodes, 0].astype(np.float32)),
                        torch.from_numpy(gh[:n_nodes, 1].astype(np.float32)),
                        param)
        w = (torch.clamp(w, torch.from_numpy(lower[:n_nodes]),
                         torch.from_numpy(upper[:n_nodes]))
             * _f32(param.eta)).numpy()
        is_leaf = lc[:n_nodes] < 0
        leaf_value = np.where(is_leaf, w, 0.0).astype(np.float32)
        tree = TreeModel.from_compact(
            left_child=lc[:n_nodes].copy(), right_child=rc[:n_nodes].copy(),
            parent=pa[:n_nodes].copy(), split_feature=sf[:n_nodes].copy(),
            split_bin=sb[:n_nodes].copy(),
            split_value=self._split_values(sf[:n_nodes], sb[:n_nodes]),
            default_left=dl[:n_nodes].copy(), is_leaf=is_leaf,
            leaf_value=leaf_value,
            sum_hess=gh[:n_nodes, 1].astype(np.float32),
            gain=np.where(is_leaf, 0.0, gn[:n_nodes]).astype(np.float32),
            is_cat_split=ics[:n_nodes].copy(),
            cat_words=cwords[:n_nodes].copy(),
            base_weight=w.astype(np.float32))
        positions = self._final(rows, positions)
        delta = torch.from_numpy(leaf_value).to(dev)[positions]
        return LossguideGrown(positions=positions, delta=delta, tree=tree)

    def to_tree_model(self, g: LossguideGrown) -> TreeModel:
        return g.tree
