"""Depth-wise tree growing on the device.

The port of the exact depthwise branch of the JAX package's
``tree/grow.py _grow`` and ``TreeGrower`` (reference
``QuantileHistMaker::UpdateTree``): the tree is a fixed-capacity heap
(node i has children 2i+1 / 2i+2), and each level runs four stages on
the device: build the level's histogram (kernel K2, K3 or K4 through
``ops/histogram.py build_hist``), evaluate splits, record the heap
bookkeeping, advance row positions. Nothing leaves the device inside the
level loop. Per-row margin deltas are the leaf values at each row's
final node, which is what the JAX package's level-by-level accumulation
adds up to.

The two-level schedules of ``_grow`` are ported as the explicit
``hist_method`` values ``coarse``, ``fused`` and ``scan`` (``auto`` keeps
the exact search): each level scores 16 coarse slots, refines a window
of 32 fine bins per (node, feature) and evaluates splits exactly on the
synthetic layout of ``ops/split.py assemble_two_level``. ``fused`` and
``scan`` defer each level's advance to the next level's sweep
(``ops/histogram.py fused_advance_coarse`` / ``scan_advance_level``) and
advance below the last level after the loop. The three build the same
integer histograms and grow the same trees.

Column sampling (``colsample_bytree``, ``_bylevel``, ``_bynode``) is
the JAX package's ``_sample_features`` over the threefry stream of
``utils/random.py``: a tree's features are drawn from those with real
bins under ``fold_in(tkey, 0xC0)``; the tree's key is then
``fold_in(tkey, 0x5EED)``, level d's ``fold_in(key, d)`` and its nodes'
``split(fold_in(level_key, 1), n_level)``. No draw depends on the data,
so :func:`draw_feature_masks` makes every mask of a round's trees at
once on the device, before the trees grow; each level's split search
takes its masks (``evaluate_splits(feature_mask=)``), on every
schedule, as the JAX package's ``_grow`` does.

Categorical features (``cuts.is_cat()``: bin == category code) split
one-hot or by sorted partition (``ops/split.py CatInfo``); the heap
keeps each node's ``is_cat_split`` and its left set as ``(nb - 1) // 32
+ 1`` uint32 words held in int64, and the advance routes by them. Their
histograms go through ``auto``'s K2 and K3, never the sorted build, and
the two-level schedules refuse them, as the JAX package's.

Monotone constraints keep a weight interval per node (``node_lower`` /
``node_upper``, f32 on the device): the split search clips children's
weights into it, each split divides it at the midpoint of its children's
clipped weights by the feature's sign, and the final weights are
clipped into it. Interaction constraints keep each node's path (the
features split on above it) and AND the union of the constraint sets
that hold the path into the level's feature mask
(:func:`interaction_allowed_dev`). ``max_leaves`` on depthwise growth
truncates the grown heap as the reference's depth-wise driver would have
stopped (:func:`select_max_leaves`, ``TreeGrower._truncate_max_leaves``).
Leaf-wise growth is ``tree/lossguide.py``.

Row-split training over a data mesh (``context.Mesh``): ``bins`` is a
``tree/shards.py RowShards``, each shard builds its histograms on its
own device from its rows, with the scale reduced over the shards, and
the shards' partials are summed in shard order before the one split
search (the JAX package's ``_grow`` under ``shard_map``: its
``allreduce`` and ``root_sum``). Sibling subtraction stays refused under
a mesh, as in the JAX package.

Column split over a data mesh (``data_split_mode="col"``, the JAX
package's ``_grow`` with ``split_mode="col"``): ``bins`` is a
``tree/shards.py ColShards``, every shard holding all the rows of one
block of features. Each shard builds its histograms (no reduction:
every shard has every row) and searches its own features, with the
monotone, categorical, column-sample and interaction arrays sliced to
them (in the pooled layout, ``tree/shards.py FeatureBlock``: the
prefix sums then round as one device's); :meth:`ColShards.exchange`
keeps each node's best shard and the heap records the winner with its
global feature. Rows advance in two
passes (``ops/partition.py``): each shard decides the rows of the nodes
it owns, and the ORed bits move the rows on every shard. ``fused`` and
``scan`` advance at the end of each level, as ``coarse`` does, and
build the next level's histograms through K2 / K4 alone: the JAX
package runs its XLA body there too, never the fused kernel. ``auto``
never takes the sorted build under column split
(``ops/histogram.py auto_selects_scan``).

Not ported here (each raises where it is asked for): the mega schedule
and sibling subtraction (ROADMAP A.6).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.histogram import (build_hist, fused_advance_coarse,
                             refuse_categorical_two_level,
                             resolve_hist_kernel, scan_advance_level,
                             scan_level_hists)
from ..ops.partition import (LevelSplits, advance_level, level_rel,
                             update_positions)
from ..ops.split import (COARSE_B, WINDOW, CatInfo, assemble_two_level,
                         choose_refine_window, coarse_bin_ids,
                         decode_two_level_bin, evaluate_splits,
                         refine_bin_ids, refine_from_fine)
from ..utils import random as xrandom
from .param import TrainParam, _f32, calc_weight
from .shards import ColShards, FeatureBlock, RowShards
from .tree import TreeModel

_EPS = 1e-6  # reference kRtEps


class GrownTree(NamedTuple):
    """Device-side tree arrays (heap layout) plus per-row results."""

    split_feature: torch.Tensor  # [max_nodes] int64, -1 at leaves
    split_bin: torch.Tensor      # [max_nodes] int64
    default_left: torch.Tensor   # [max_nodes] bool
    is_leaf: torch.Tensor        # [max_nodes] bool
    active: torch.Tensor         # [max_nodes] bool
    # vector-leaf trees (``tree/multi.py``) carry a trailing target axis K
    # on leaf_value, base_weight and delta, and node_sum is [max_nodes, K, 2]
    leaf_value: torch.Tensor     # [max_nodes] f32 (eta applied)
    node_sum: torch.Tensor       # [max_nodes, 2] f32
    gain: torch.Tensor           # [max_nodes] f32
    positions: torch.Tensor      # [n_rows] int64 final heap node per row
    delta: torch.Tensor          # [n_rows] f32 leaf value per row
    base_weight: torch.Tensor    # [max_nodes] f32 node weight * eta
    # categorical splits: [max_nodes] bool and the left sets [max_nodes, W]
    # (uint32 words in int64); None without categorical features
    is_cat_split: Optional[torch.Tensor] = None
    cat_words: Optional[torch.Tensor] = None


def sample_features(keys, base_mask: torch.Tensor,
                    frac: float) -> torch.Tensor:
    """The JAX package's ``_sample_features``: a draw without replacement
    of ``ceil(frac * count)`` of the features in ``base_mask`` [..., F]
    (count its True entries; the product in f32, as JAX's weakly typed
    float times int32), by the smallest uniforms of ``keys`` (one key
    pair, or [..., 2] key words, one draw per key) -> bool [..., F]."""
    if frac >= 1.0:
        return base_mask
    F = base_mask.shape[-1]
    u = xrandom.uniform(keys, (F,), device=base_mask.device)
    base = base_mask.expand(u.shape)
    u = torch.where(base, u, torch.full_like(u, float("inf")))
    count = base.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    k = torch.ceil(torch.tensor(_f32(frac), dtype=torch.float32,
                                device=u.device) * count)
    k = torch.clamp(k.to(torch.int64), 1, F)
    thr = torch.gather(torch.sort(u, dim=-1).values, -1, (k - 1)[..., None])
    return base & (u <= thr)


def draw_feature_masks(tkeys: Sequence[xrandom.Key], base_mask: torch.Tensor,
                       param: TrainParam, max_depth: int
                       ) -> Optional[List[List[torch.Tensor]]]:
    """Every feature mask of the trees with keys ``tkeys`` (the trees of
    one round): per tree, per level d, a [2^d, F] (node sampling) or
    [1, F] bool mask; None when no column is sampled. ``base_mask`` [F]:
    the features with real bins. Four draws in all, each over every tree
    at once: the trees', the levels', the nodes' keys and the nodes'."""
    if min(param.colsample_bytree, param.colsample_bylevel,
           param.colsample_bynode) >= 1.0:
        return None
    dev = base_mask.device
    T = len(tkeys)

    def words(pairs):
        return torch.tensor(pairs, dtype=torch.int64, device=dev)

    tree = sample_features(
        words([xrandom.fold_in(k, 0xC0) for k in tkeys]), base_mask,
        param.colsample_bytree).expand(T, -1)                    # [T, F]
    gkeys = [xrandom.fold_in(k, 0x5EED) for k in tkeys]
    lkeys = [[xrandom.fold_in(g, d) for d in range(max_depth)]
             for g in gkeys]
    level = sample_features(words(lkeys), tree[:, None, :].expand(
        T, max_depth, -1), param.colsample_bylevel)              # [T, D, F]
    if param.colsample_bynode >= 1.0:
        return [[level[t, d][None] for d in range(max_depth)]
                for t in range(T)]
    # node i of level d (heap node 2^d - 1 + i) has key i of
    # split(fold_in(level_key, 1), 2^d): the hash of counter (0, i)
    split_keys = words([[xrandom.fold_in(lk, 1) for lk in row]
                        for row in lkeys])                       # [T, D, 2]
    depth = torch.cat([torch.full((1 << d,), d, dtype=torch.int64,
                                  device=dev) for d in range(max_depth)])
    local = torch.cat([torch.arange(1 << d, dtype=torch.int64, device=dev)
                       for d in range(max_depth)])
    k0, k1 = xrandom.threefry2x32(split_keys[:, depth, 0],
                                  split_keys[:, depth, 1], 0, local[None])
    node = sample_features(torch.stack([k0, k1], dim=-1),
                           level[:, depth, :],
                           param.colsample_bynode)               # [T, nodes, F]
    return [[node[t, (1 << d) - 1:(2 << d) - 1] for d in range(max_depth)]
            for t in range(T)]


def two_level_schedule(hist_method: str, max_nbins: int,
                       has_missing: bool, numeric: bool = True):
    """``"coarse"``, ``"fused"`` or ``"scan"`` when ``hist_method`` asks
    for a two-level schedule, else None. Like the JAX package's, they
    take numeric features (``numeric``) and at most 256 real bins."""
    base = hist_method[:-len("+nosub")] if hist_method.endswith("+nosub") \
        else hist_method
    if base not in ("coarse", "fused", "scan"):
        return None
    if not numeric:
        refuse_categorical_two_level(hist_method)
    if max_nbins > 256 + int(has_missing):
        raise NotImplementedError(
            f"hist_method={hist_method!r} supports numeric features and "
            "max_bin <= 256")
    return base


def interaction_allowed_dev(path_level: torch.Tensor,
                            cons: torch.Tensor) -> torch.Tensor:
    """allowed(n) = the union of the constraint sets that hold path(n)
    (reference ``FeatureInteractionConstraintHost``; the JAX package's
    ``interaction_allowed_dev``). path_level [N, F] bool; cons [S, F]
    bool -> [N, F] bool."""
    compat = ~(path_level[:, None, :] & ~cons[None, :, :]).any(dim=2)
    return (compat[:, :, None] & cons[None, :, :]).any(dim=1)


def interaction_allowed_host(path_level: np.ndarray,
                             cons: np.ndarray) -> np.ndarray:
    """:func:`interaction_allowed_dev` in numpy, for the host loops."""
    compat = ~np.any(path_level[:, None, :] & ~cons[None, :, :], axis=2)
    return np.any(compat[:, :, None] & cons[None, :, :], axis=1)


def monotone_child_bounds(ls: torch.Tensor, rs: torch.Tensor,
                          mc: torch.Tensor, plo: torch.Tensor,
                          phi: torch.Tensor, param: TrainParam):
    """The children's weight intervals below N splits (reference
    ``TreeEvaluator``): the children's weights, from their sums ls / rs
    [N, 2], clipped into the parent's interval [plo, phi], and the
    interval divided at their midpoint by the split feature's sign ``mc``
    [N] (+1: left below, right above; -1 mirrored). f32, as the JAX
    package's ``_grow`` computes them on the device. Returns
    ((l_lo, l_hi), (r_lo, r_hi))."""
    wl = torch.clamp(calc_weight(ls[:, 0], ls[:, 1], param), plo, phi)
    wr = torch.clamp(calc_weight(rs[:, 0], rs[:, 1], param), plo, phi)
    mid = (wl + wr) * 0.5
    l_hi = torch.where(mc > 0, mid, phi)
    r_lo = torch.where(mc > 0, mid, plo)
    l_lo = torch.where(mc < 0, mid, plo)
    r_hi = torch.where(mc < 0, mid, phi)
    return (l_lo, l_hi), (r_lo, r_hi)


def monotone_child_bounds_host(ls: np.ndarray, rs: np.ndarray,
                               feat: np.ndarray, plo: np.ndarray,
                               phi: np.ndarray, mono: np.ndarray,
                               param: TrainParam):
    """:func:`monotone_child_bounds` for host arrays (the JAX package's
    ``monotone_child_bounds_host``): ls / rs [N, 2], feat [N], plo / phi
    [N] f32 and the per-feature signs ``mono`` [F]; the weights in f32
    through the same torch ops. Returns numpy ((l_lo, l_hi), (r_lo,
    r_hi))."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    mc = torch.from_numpy(np.asarray(mono)[np.maximum(feat, 0)])
    out = monotone_child_bounds(t(ls), t(rs), mc, t(plo), t(phi), param)
    return tuple(tuple(x.numpy() for x in pair) for pair in out)


def select_max_leaves(active: np.ndarray, is_leaf: np.ndarray,
                      max_leaves: int):
    """The reference driver's depth-wise schedule under a ``max_leaves``
    cap (``CPUExpandEntry::IsValid``) over a fully grown heap: nodes are
    popped in heap (breadth-first) order and split while the leaf count
    is under the cap. A split does not depend on the order, so this
    gives the tree that schedule grows. Returns (exists, selected,
    changed): the surviving nodes, the kept splits, and whether the cap
    bound."""
    cap = len(is_leaf)
    exists = np.zeros(cap, bool)
    exists[0] = True
    selected = np.zeros(cap, bool)
    n_leaves = 1
    for nid in range(cap):
        if not exists[nid] or is_leaf[nid] or not active[nid]:
            continue
        if n_leaves >= max_leaves:
            continue
        selected[nid] = True
        n_leaves += 1
        exists[2 * nid + 1] = exists[2 * nid + 2] = True
    was_split = active & ~is_leaf
    return exists, selected, not (selected == was_split).all()


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-node mask [N] shaped to broadcast over ``like``'s trailing
    axes ([N], [N, 2], [N, K], [N, K, 2])."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


class HeapTree:
    """The heap arrays of one growing tree (node i has children 2i+1 /
    2i+2) and the bookkeeping of a level, shared by :func:`grow_tree`,
    ``tree/paged.py PagedGrower`` and the vector-leaf grower of
    ``tree/multi.py``: each level's split results go in through
    :meth:`record`, and :meth:`finish` turns the heap and the rows' final
    nodes into a :class:`GrownTree`. ``root_sum`` is the root's (g, h)
    [2], or [K, 2] for a vector-leaf tree, whose nodes then hold K
    sums and K weights."""

    def __init__(self, max_depth: int, root_sum: torch.Tensor,
                 param: TrainParam, n_words: int = 0,
                 monotone: Optional[torch.Tensor] = None,
                 constraint_sets: Optional[torch.Tensor] = None) -> None:
        dev = root_sum.device
        self.max_nodes = max_nodes = 2 ** (max_depth + 1) - 1
        self.param = param
        self.split_feature = torch.full((max_nodes,), -1, dtype=torch.int64,
                                        device=dev)
        self.split_bin = torch.zeros((max_nodes,), dtype=torch.int64,
                                     device=dev)
        self.default_left = torch.zeros((max_nodes,), dtype=torch.bool,
                                        device=dev)
        self.is_leaf = torch.ones((max_nodes,), dtype=torch.bool, device=dev)
        self.active = torch.zeros((max_nodes,), dtype=torch.bool, device=dev)
        self.active[0] = True
        self.gain = torch.zeros((max_nodes,), dtype=torch.float32, device=dev)
        self.node_sum = torch.zeros((max_nodes,) + tuple(root_sum.shape),
                                    dtype=torch.float32, device=dev)
        self.node_sum[0] = root_sum
        self.min_gain = _f32(max(param.gamma, _EPS))
        # ``n_words`` > 0: categorical splits, their left sets in that many
        # words
        self.is_cat_split = self.cat_words = None
        if n_words:
            self.is_cat_split = torch.zeros((max_nodes,), dtype=torch.bool,
                                            device=dev)
            self.cat_words = torch.zeros((max_nodes, n_words),
                                         dtype=torch.int64, device=dev)
        # monotone constraints: each node's weight interval (reference
        # TreeEvaluator lower / upper bounds)
        self.monotone = monotone
        self.node_lower = self.node_upper = None
        if monotone is not None:
            self.node_lower = torch.full((max_nodes,), float("-inf"),
                                         dtype=torch.float32, device=dev)
            self.node_upper = torch.full((max_nodes,), float("inf"),
                                         dtype=torch.float32, device=dev)
        # interaction constraints: the features on each node's path
        self.constraint_sets = constraint_sets
        self.node_path = None
        if constraint_sets is not None:
            self.node_path = torch.zeros(
                (max_nodes, constraint_sets.shape[1]), dtype=torch.bool,
                device=dev)

    def constraint_args(self, lo: int, n_level: int, feature_mask):
        """The split search's constraint arguments for the level of
        ``n_level`` nodes from heap node ``lo``: ``feature_mask`` ANDed
        with the interaction constraints' allowance, and the monotone
        keywords of ``ops/split.py evaluate_splits``."""
        hi = lo + n_level
        if self.node_path is not None:
            allowed = interaction_allowed_dev(self.node_path[lo:hi],
                                              self.constraint_sets)
            feature_mask = (allowed if feature_mask is None
                            else feature_mask & allowed)
        kw = {}
        if self.monotone is not None:
            kw = dict(monotone=self.monotone,
                      node_lower=self.node_lower[lo:hi],
                      node_upper=self.node_upper[lo:hi])
        return feature_mask, kw

    def record(self, lo: int, n_level: int, res) -> torch.Tensor:
        """Record the split search ``res`` (``ops/split.py
        evaluate_splits``) of the level of ``n_level`` nodes from heap node
        ``lo``: a node exists iff its parent split, and expands unless its
        best gain fails the gamma / kRtEps test. Returns can_split
        [n_level]."""
        hi = lo + n_level
        can_split = (self.active[lo:hi] & (res.gain > self.min_gain)
                     & torch.isfinite(res.gain))
        self.split_feature[lo:hi] = torch.where(
            can_split, res.feature, torch.full_like(res.feature, -1))
        self.split_bin[lo:hi] = torch.where(can_split, res.bin,
                                            torch.zeros_like(res.bin))
        self.default_left[lo:hi] = can_split & res.default_left
        self.is_leaf[lo:hi] = ~can_split
        self.gain[lo:hi] = torch.where(can_split, res.gain,
                                       torch.zeros_like(res.gain))
        if self.is_cat_split is not None:
            cat = can_split & res.is_cat
            self.is_cat_split[lo:hi] = cat
            self.cat_words[lo:hi] = torch.where(
                cat[:, None], res.cat_words,
                torch.zeros_like(res.cat_words))
        children = slice(2 * lo + 1, 2 * hi + 1)    # [l0, r0, l1, r1, ...]
        self.active[children] = can_split.repeat_interleave(2)
        zero2 = torch.zeros_like(res.left_sum)
        cs = _rows(can_split, res.left_sum)
        self.node_sum[children] = torch.stack(
            [torch.where(cs, res.left_sum, zero2),
             torch.where(cs, res.right_sum, zero2)],
            dim=1).reshape((-1,) + tuple(res.left_sum.shape[1:]))
        feat = res.feature.clamp(min=0)
        if self.monotone is not None:
            plo, phi = self.node_lower[lo:hi], self.node_upper[lo:hi]
            (l_lo, l_hi), (r_lo, r_hi) = monotone_child_bounds(
                res.left_sum, res.right_sum, self.monotone[feat], plo, phi,
                self.param)
            zero = torch.zeros_like(plo)

            def pair(a, b):
                return torch.stack([torch.where(can_split, a, zero),
                                    torch.where(can_split, b, zero)],
                                   dim=1).reshape(-1)

            self.node_lower[children] = pair(l_lo, r_lo)
            self.node_upper[children] = pair(l_hi, r_hi)
        if self.node_path is not None:
            fsel = (torch.arange(self.node_path.shape[1],
                                 device=feat.device)[None, :]
                    == feat[:, None]) & can_split[:, None]
            self.node_path[children] = (self.node_path[lo:hi] | fsel
                                        ).repeat_interleave(2, dim=0)
        return can_split

    def level_splits(self, lo: int, n_level: int,
                     can_split: torch.Tensor) -> LevelSplits:
        """The splits of the recorded level, for the advance below it."""
        hi = lo + n_level
        cat = self.is_cat_split is not None
        return LevelSplits(lo, self.split_feature[lo:hi],
                           self.split_bin[lo:hi], self.default_left[lo:hi],
                           can_split,
                           self.is_cat_split[lo:hi] if cat else None,
                           self.cat_words[lo:hi] if cat else None)

    def finish(self, positions: torch.Tensor) -> GrownTree:
        """The grown tree, with ``positions`` [n] the rows' final heap
        nodes: leaf weights ``calc_weight * eta`` and each row's delta, the
        leaf value at its node."""
        w = calc_weight(self.node_sum[..., 0], self.node_sum[..., 1],
                        self.param)
        if self.monotone is not None:
            w = torch.clamp(w, self.node_lower, self.node_upper)
        w = w * _f32(self.param.eta)
        zero = torch.zeros_like(w)
        leaf_value = torch.where(_rows(self.active & self.is_leaf, w), w,
                                 zero)
        return GrownTree(
            split_feature=self.split_feature, split_bin=self.split_bin,
            default_left=self.default_left, is_leaf=self.is_leaf,
            active=self.active, leaf_value=leaf_value,
            node_sum=self.node_sum, gain=self.gain, positions=positions,
            delta=leaf_value[positions],
            base_weight=torch.where(_rows(self.active, w), w, zero),
            is_cat_split=self.is_cat_split, cat_words=self.cat_words)


def search_splits(rows: RowShards, gps: Sequence[torch.Tensor],
                  rels: Sequence[torch.Tensor], n_nodes: int,
                  parent_sum: torch.Tensor, n_real_bins: torch.Tensor, *,
                  param: TrainParam, max_nbins: int, hist_method: str,
                  has_missing: bool, schedule: Optional[str],
                  cbs: Optional[Sequence[torch.Tensor]] = None,
                  hist_c: Optional[torch.Tensor] = None,
                  hist_f: Optional[torch.Tensor] = None,
                  feature_mask: Optional[torch.Tensor] = None,
                  cat: Optional[CatInfo] = None, scale: Optional[dict] = None,
                  block: Optional[FeatureBlock] = None, **monotone_kw):
    """The best split of each of ``n_nodes`` nodes over the shards of
    ``rows`` (each shard's gradients ``gps`` and node of each row
    ``rels``, the inactive ones at ``n_nodes``): each shard's histogram,
    summed over the shards (``RowShards.reduce``), and
    ``evaluate_splits``, exact over every bin (``schedule`` None), or the
    two-level search of ``coarse`` / ``fused`` (the shards' coarse ids
    ``cbs``) and ``scan``, its winning slot decoded to a fine bin.
    ``hist_c`` / ``hist_f``: the summed coarse (and, under ``scan``,
    fine) histograms when a level boundary's sweep already built them.
    ``scale``: the mesh's quantiser keywords (``tree/shards.py
    RowShards.scale``). ``monotone_kw``: ``evaluate_splits``' monotone
    arguments. Shared by :func:`grow_tree`'s levels and
    ``tree/lossguide.py``'s node pairs.

    Over a column mesh's ``ColShards`` each shard runs this search on
    its own features and the shards' results go through the best-split
    exchange. ``block``: the bins are the features ``block`` of the
    pooled layout (a column shard, or a vertical party), whose
    per-feature arguments ``n_real_bins``, ``feature_mask``, ``cat`` and
    ``monotone`` cover the pooled features: the shard's histograms are
    placed in that layout (``tree/shards.py FeatureBlock``), its
    features the only ones with real bins, so that the search is one
    device's over them; the result's features are global, and ``auto``
    keeps off K4."""
    if isinstance(rows, ColShards):
        # the pooled layout is the unpadded one, as one device's
        F = rows.n_features
        results = []
        for s, (b, g, r) in enumerate(zip(rows.parts, gps, rels)):
            dev = rows.devices[s]
            kw = {k: v[..., :F].to(dev) if k == "monotone" else v.to(dev)
                  for k, v in monotone_kw.items()}
            results.append(search_splits(
                RowShards([b]), [g], [r], n_nodes, parent_sum.to(dev),
                n_real_bins[:F].to(dev), param=param, max_nbins=max_nbins,
                hist_method=hist_method, has_missing=has_missing,
                schedule=schedule, cbs=None if cbs is None else [cbs[s]],
                feature_mask=None if feature_mask is None
                else feature_mask[..., :F].to(dev),
                cat=None if cat is None else CatInfo(
                    cat.is_cat[:F].to(dev), cat.is_onehot[:F].to(dev)),
                block=rows.block(s, has_missing), **kw))
        return rows.exchange(results, with_cat=cat is not None)
    scale = scale or {}
    missing_bin = max_nbins - 1 if has_missing else max_nbins
    shards = list(zip(rows.parts, gps, rels))
    embed = (lambda h: h) if block is None else block.embed
    if block is not None:
        n_real_bins = block.restrict(n_real_bins)
    if schedule is None:
        hist = embed(rows.reduce([build_hist(b, g, r, n_nodes, max_nbins,
                                             method=hist_method,
                                             has_missing=has_missing,
                                             numeric=cat is None,
                                             col_split=block is not None,
                                             **scale)
                                  for b, g, r in shards]))
        return evaluate_splits(hist, parent_sum, n_real_bins, param,
                               has_missing=has_missing,
                               feature_mask=feature_mask, cat=cat,
                               **monotone_kw)
    if schedule == "scan" and hist_f is None:
        parts = [scan_level_hists(b, g, r, n_nodes, max_nbins, missing_bin,
                                  **scale) for b, g, r in shards]
        hist_f = embed(rows.reduce([f for f, _ in parts]))
        hist_c = embed(rows.reduce([c for _, c in parts]))
    if hist_c is None:
        hist_c = embed(rows.reduce([build_hist(cb, g, r, n_nodes, COARSE_B,
                                               col_split=block is not None,
                                               **scale)
                                    for cb, (_, g, r) in zip(cbs, shards)]))
    span = choose_refine_window(hist_c, parent_sum, n_real_bins, param,
                                has_missing)
    if schedule == "scan":
        hist_r = refine_from_fine(hist_f, span, missing_bin)
    else:
        parts = []
        own_span = span if block is None else block.local(span)
        for (b, g, r), sp in zip(shards, rows.to_shards(own_span)):
            # each row's window is its node's (rows outside the nodes take
            # window 0 and add nothing)
            span_row = torch.cat([sp, torch.zeros_like(sp[:1])]).to(
                torch.int32)[r.long()]
            rb = refine_bin_ids(b, span_row, missing_bin)
            parts.append(build_hist(rb, g, r, n_nodes, WINDOW + 4,
                                    col_split=block is not None,
                                    **scale)[:, :, :WINDOW])
        hist_r = embed(rows.reduce(parts))
    hist, n_real_eval = assemble_two_level(hist_c, hist_r, span,
                                           n_real_bins, has_missing)
    res = evaluate_splits(hist, parent_sum, n_real_eval, param,
                          has_missing=has_missing,
                          feature_mask=feature_mask, **monotone_kw)
    span_sel = torch.gather(span, 1, res.feature.clamp(min=0)[:, None])[:, 0]
    return res._replace(bin=decode_two_level_bin(res.bin, span_sel))


def advance_heap(rows, positions: List[torch.Tensor], heap,
                 missing_bin: int) -> List[torch.Tensor]:
    """Each shard's rows one level down below the heap's splits ``heap``
    (split feature, bin, default direction, is-split, and the
    categorical flags and words or None, [max_nodes] on the first
    device): ``update_positions`` on every shard, or, over a column
    mesh's ``ColShards``, its two passes, the shards' owned bits ORed
    between them."""
    sf, sb, dl, isp, ics, cw = heap
    if isinstance(rows, ColShards):
        bits = rows.decide([
            update_positions(b, p, *h[:4], missing_bin, h[4], h[5],
                             feat_offset=off)
            for b, p, h, off in zip(rows.parts, positions,
                                    rows.to_shards(heap), rows.offsets)])
        return rows.split(update_positions(None, positions[0], sf, sb, dl,
                                           isp, missing_bin, ics, cw,
                                           decided=bits))
    return [update_positions(b, p, *h[:4], missing_bin, h[4], h[5])
            for b, p, h in zip(rows.parts, positions, rows.to_shards(heap))]


def grow_tree(bins, gpair: torch.Tensor,
              n_real_bins: torch.Tensor, *, param: TrainParam,
              max_nbins: int, hist_method: str = "auto",
              has_missing: bool = True,
              feature_masks: Optional[List[torch.Tensor]] = None,
              cat: Optional[CatInfo] = None,
              monotone: Optional[torch.Tensor] = None,
              constraint_sets: Optional[torch.Tensor] = None) -> GrownTree:
    """One tree from bins [n, F] on one device, or the shards of a data
    mesh (``tree/shards.py RowShards``), and gpair [n, 2] f32 over the
    same rows on the (first) device; ``n_real_bins`` [F] int64 on that
    device; ``feature_masks``: per level a [n_level or 1, F] bool mask of
    the features its nodes may split on (:func:`draw_feature_masks`), or
    None; ``cat``: the categorical features (on the same device), or
    None; ``monotone`` [F] int64 signs and ``constraint_sets`` [S, F]
    bool (the parsed constraints, on the same device), or None.

    Under a mesh each shard builds its histograms from its rows and
    advances its rows' positions; the sums and the split search are the
    first device's, and the decisions go back to the shards (the JAX
    package's ``_grow`` under ``shard_map``, ``allreduce`` and
    ``root_sum``). Over a column mesh's ``ColShards`` the per-feature
    arguments cover the padded global features (module docstring)."""
    rows = RowShards.of(bins)
    col = isinstance(rows, ColShards)
    gps = rows.split(gpair)
    scale = rows.scale(gps)
    dev = rows.device
    max_depth = param.max_depth
    numeric = cat is None
    # out-of-range sentinel when the matrix carries no missing slot
    missing_bin = max_nbins - 1 if has_missing else max_nbins
    for depth in range(max_depth):      # refuse an unported method up front
        resolve_hist_kernel(hist_method, rows.shard_rows, 2 ** depth,
                            max_nbins, has_missing, numeric, col)
    schedule = two_level_schedule(hist_method, max_nbins, has_missing,
                                  numeric)
    # column split: the decision OR stands between the advance and the
    # next build, so every schedule advances at the end of its level
    deferred = schedule in ("fused", "scan") and not col
    cbs = ([coarse_bin_ids(b, missing_bin) for b in rows.parts]
           if schedule in ("coarse", "fused") else None)
    n_real_slots = max_nbins - 1 if has_missing else max_nbins

    tree = HeapTree(max_depth, rows.reduce([g.sum(dim=0) for g in gps],
                                           "mesh/root-sum"), param,
                    n_words=0 if numeric else (n_real_slots - 1) // 32 + 1,
                    monotone=monotone, constraint_sets=constraint_sets)
    positions = [torch.zeros((b.shape[0],), dtype=torch.int64,
                             device=b.device) for b in rows.parts]
    pending = None      # fused/scan: the splits whose advance is deferred

    for depth in range(max_depth):
        lo = 2 ** depth - 1
        n_level = 2 ** depth
        hi = lo + n_level
        hist_c = hist_f = None
        if pending is not None:
            # the boundary sweep: advance below the previous level's
            # splits and build this level's histograms in one pass
            outs = []
            for b, g, p, pend in zip(rows.parts, gps, positions,
                                     rows.to_shards(pending)):
                if schedule == "scan":
                    outs.append(scan_advance_level(
                        b, g, p, pend, lo, n_level, missing_bin, max_nbins,
                        **scale))
                else:
                    outs.append(fused_advance_coarse(
                        b, g, p, pend, lo, n_level, missing_bin, **scale))
            positions = [o[0] for o in outs]
            if schedule == "scan":
                hist_f = rows.reduce([o[1] for o in outs])
            hist_c = rows.reduce([o[-1] for o in outs])
            pending = None
        rels = [level_rel(p, lo, n_level) for p in positions]
        fmask, mono_kw = tree.constraint_args(
            lo, n_level, None if feature_masks is None
            else feature_masks[depth])
        res = search_splits(
            rows, gps, rels, n_level, tree.node_sum[lo:hi], n_real_bins,
            param=param, max_nbins=max_nbins, hist_method=hist_method,
            has_missing=has_missing, schedule=schedule, cbs=cbs,
            hist_c=hist_c, hist_f=hist_f, feature_mask=fmask, cat=cat,
            scale=scale, **mono_kw)
        can_split = tree.record(lo, n_level, res)
        if deferred:
            pending = tree.level_splits(lo, n_level, can_split)
        else:
            is_split = torch.zeros((tree.max_nodes,), dtype=torch.bool,
                                   device=dev)
            is_split[lo:hi] = can_split
            positions = advance_heap(
                rows, positions, (tree.split_feature, tree.split_bin,
                                  tree.default_left, is_split,
                                  tree.is_cat_split, tree.cat_words),
                missing_bin)
    if pending is not None:     # below the last level: the advance alone
        positions = [advance_level(b, p, pend, missing_bin) for b, p, pend
                     in zip(rows.parts, positions, rows.to_shards(pending))]
    return tree.finish(rows.gather(positions))


# the device tensors of TreeGrower._on that are made from the cuts
_CUTS_KEYS = ("n_real", "is_cat", "is_onehot")


class TreeGrower:
    """Host-side wrapper of depthwise growth: runs :func:`grow_tree`,
    truncates its heap under ``max_leaves`` and turns it into a
    :class:`TreeModel`. ``monotone`` (one sign a feature) and
    ``constraint_sets`` (bool [S, F]): the parsed constraints
    (``tree/param.py``), or None. ``feature_pad``: the columns a column
    mesh pads the features by (``data/binned.py
    feature_pad_for_mesh``); every per-feature array the grower makes
    is padded with them (no real bin, no constraint, numeric)."""

    def __init__(self, param: TrainParam, max_nbins: int, cuts,
                 hist_method: str = "auto", has_missing: bool = True,
                 monotone: Optional[Sequence[int]] = None,
                 constraint_sets: Optional[np.ndarray] = None,
                 feature_pad: int = 0) -> None:
        if param.sampling_method not in ("uniform", "gradient_based"):
            raise ValueError(
                f"unknown sampling_method {param.sampling_method!r}; use "
                "'uniform' or 'gradient_based'")
        self.check_depth(param)
        self.param = param
        self.max_nbins = max_nbins
        self.cuts = cuts
        self.hist_method = hist_method
        self.has_missing = has_missing
        self.monotone = (None if monotone is None
                         else np.asarray(monotone, np.int64))
        self.constraint_sets = (None if constraint_sets is None
                                else np.asarray(constraint_sets, bool))
        self.feature_pad = feature_pad
        self._on = {}

    def padded(self, a: np.ndarray) -> np.ndarray:
        """A per-feature host array (features on its last axis) padded
        with zeros (False) for the column mesh's pad columns."""
        if not self.feature_pad:
            return a
        width = [(0, 0)] * (a.ndim - 1) + [(0, self.feature_pad)]
        return np.pad(a, width)

    @staticmethod
    def check_depth(param: TrainParam) -> None:
        if param.max_depth < 1:
            raise ValueError("grow_policy=depthwise requires max_depth > 0")

    def _host_on(self, name: str, device: torch.device, make):
        """``make()``'s tensor on ``device``, made once per device."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = make()
            if self._on[key] is not None:
                self._on[key] = self._on[key].to(device)
        return self._on[key]

    def set_cuts(self, cuts) -> None:
        """Grow from new cuts of the same bin slots and with no
        categorical feature (``tree_method="approx"``'s next sketch): the
        device copies made from the old ones are dropped, so every tree
        reads its own cuts' real-bin counts."""
        self.cuts = cuts
        for key in [k for k in self._on if k[0] in _CUTS_KEYS]:
            del self._on[key]

    def _n_real_on(self, device: torch.device) -> torch.Tensor:
        return self._host_on("n_real", device, lambda: torch.from_numpy(
            self.padded(self.cuts.n_real_bins().astype(np.int64))))

    def constraints_on(self, device: torch.device):
        """(monotone [F] int64, constraint_sets [S, F] bool) on
        ``device``, each None when unconstrained."""
        return (self._host_on("monotone", device, lambda: None
                              if self.monotone is None
                              else torch.from_numpy(
                                  self.padded(self.monotone))),
                self._host_on("sets", device, lambda: None
                              if self.constraint_sets is None
                              else torch.from_numpy(
                                  self.padded(self.constraint_sets))))

    def cat_on(self, device: torch.device) -> Optional[CatInfo]:
        """The categorical features on ``device`` (one-hot with at most
        ``max_cat_to_onehot`` categories), or None when every feature is
        numeric."""
        is_cat = self.cuts.is_cat()
        if not is_cat.any():
            return None
        onehot = is_cat & (self.cuts.n_real_bins()
                           <= self.param.max_cat_to_onehot)
        return CatInfo(
            self._host_on("is_cat", device,
                          lambda: torch.from_numpy(self.padded(is_cat))),
            self._host_on("is_onehot", device,
                          lambda: torch.from_numpy(self.padded(onehot))))

    def feature_masks(self, tkeys: Sequence[xrandom.Key],
                      device: torch.device):
        """:func:`draw_feature_masks` of the trees with keys ``tkeys``
        over the features with real bins (features without any are never
        candidates and take no draw)."""
        return draw_feature_masks(tkeys, self._n_real_on(device) > 0,
                                  self.param, self.param.max_depth)

    def grow(self, bins, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from bins [n, F] or a mesh's ``RowShards`` and gpair
        [n, 2] on the (first) device; ``masks``: its column samples from
        :meth:`feature_masks`, or None when no column is sampled."""
        dev = gpair.device
        monotone, sets = self.constraints_on(dev)
        g = grow_tree(bins, gpair, self._n_real_on(dev),
                      param=self.param, max_nbins=self.max_nbins,
                      hist_method=self.hist_method,
                      has_missing=self.has_missing, feature_masks=masks,
                      cat=self.cat_on(dev), monotone=monotone,
                      constraint_sets=sets)
        if self.param.max_leaves > 0:
            g = self._truncate_max_leaves(g)
        return g

    def _truncate_max_leaves(self, g: GrownTree) -> GrownTree:
        """Depth-wise growth under a ``max_leaves`` cap
        (:func:`select_max_leaves` over the grown heap, the JAX package's
        ``_truncate_max_leaves``): the splits past the cap go, and the
        rows of a truncated subtree are re-parked on its deepest
        surviving ancestor, whose weight becomes their delta."""
        exists, selected, changed = select_max_leaves(
            g.active.cpu().numpy(), g.is_leaf.cpu().numpy(),
            self.param.max_leaves)
        if not changed:
            return g
        dev = g.active.device
        exists_t = torch.from_numpy(exists).to(dev)
        sel = torch.from_numpy(selected).to(dev)
        new_is_leaf = exists_t & ~sel
        zero = torch.zeros_like(g.base_weight)
        leaf_value = torch.where(_rows(new_is_leaf, zero), g.base_weight,
                                 zero)
        pos = g.positions
        for _ in range(self.param.max_depth):
            pos = torch.where(exists_t[pos], pos, (pos - 1) // 2)
        cat = g.is_cat_split is not None
        return GrownTree(
            split_feature=torch.where(sel, g.split_feature,
                                      torch.full_like(g.split_feature, -1)),
            split_bin=torch.where(sel, g.split_bin,
                                  torch.zeros_like(g.split_bin)),
            default_left=g.default_left & sel, is_leaf=new_is_leaf,
            active=exists_t, leaf_value=leaf_value, node_sum=g.node_sum,
            gain=torch.where(sel, g.gain, torch.zeros_like(g.gain)),
            positions=pos, delta=leaf_value[pos],
            base_weight=torch.where(_rows(exists_t, zero), g.base_weight,
                                    zero),
            is_cat_split=g.is_cat_split & sel if cat else None,
            cat_words=(torch.where(sel[:, None], g.cat_words,
                                   torch.zeros_like(g.cat_words))
                       if cat else None))

    def _split_values(self, sf: np.ndarray, sb: np.ndarray) -> np.ndarray:
        """The raw thresholds of split features ``sf`` at bins ``sb``
        (the vertical growers': from each feature's owner)."""
        return self.cuts.split_values(sf, sb)

    def to_tree_model(self, g: GrownTree) -> TreeModel:
        """Pull the heap to the host, compact it, attach raw thresholds."""
        sf = g.split_feature.cpu().numpy()
        sb = g.split_bin.cpu().numpy()
        cat = g.is_cat_split is not None
        return TreeModel.from_heap(
            split_feature=sf, split_bin=sb,
            split_value=self._split_values(sf, sb),
            default_left=g.default_left.cpu().numpy(),
            is_leaf=g.is_leaf.cpu().numpy(), active=g.active.cpu().numpy(),
            leaf_value=g.leaf_value.cpu().numpy(),
            sum_hess=g.node_sum[:, 1].cpu().numpy(),
            gain=g.gain.cpu().numpy(),
            base_weight=g.base_weight.cpu().numpy(),
            is_cat_split=g.is_cat_split.cpu().numpy() if cat else None,
            cat_words=(g.cat_words.cpu().numpy().astype(np.uint32) if cat
                       else None))
