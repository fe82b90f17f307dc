"""Vertical (column-split) federated tree growing over a host communicator.

The port of the JAX package's ``tree/vertical.py`` (reference: column-split
``hist`` training, where each party holds some features of every row and
only the label rank holds labels; ``HistEvaluator::EvaluateSplits`` with
column split, ``src/tree/hist/evaluate_splits.h:294-409``, and the
partition-bitvector broadcast of ``src/tree/common_row_partitioner.h``).
Gradients, the base score, leaf refreshes and metrics reach the other
parties through ``parallel/collective.py apply_with_labels``, wired in
``core.Booster`` and ``boosting/gbtree.py``.

The parties are ranks of a ``parallel/collective.py`` communicator
(threads, ``torch.distributed`` processes or the gRPC federated server,
``parallel/federated.py``), each holding a contiguous block of features,
in rank order. A tree grows as on one device: each rank builds its
histograms over its own features and every row (``ops/histogram.py
build_hist``: K2 / K3 / K4 on the card) and searches them
(``ops/split.py evaluate_splits``, the histograms placed in the pooled
layout, ``tree/shards.py FeatureBlock``, so that their prefix sums
round as one device's); one object allgather a level (a
split a lossguide pair) carries each rank's best split of every node up,
each node goes to the rank with the largest gain (the lowest rank on a
tie: the pooled search's lowest feature), and every rank records the
winner in the same heap (``tree/grow.py HeapTree``). The owner of a
node's split feature decides its rows; one sum-allreduce of the [n]
decision bits moves them on every rank. So the grown model is the one
that one device grows on the pooled columns, bit for bit, and every
party holds it.

Monotone and interaction constraints are over the global features (every
party passes the same parameters); categorical left sets cross as uint32
words padded to the widest party's. A finished tree's thresholds come
from each split feature's owner (each party's cuts cover its own
features), one allreduce a tree.
``federated_vertical_margin`` predicts by the same protocol.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.partition import level_rel, update_positions
from ..ops.split import CatInfo, SplitResult
from ..parallel import collective
from ..parallel.resilience import op_context
from ..utils import random as xrandom
from .grow import (GrownTree, HeapTree, TreeGrower, draw_feature_masks,
                   search_splits)
from .lossguide import LossguideGrower, apply1, col_masks, pair_rel
from .param import TrainParam
from .shards import FeatureBlock, RowShards


def row_split_hist_method(hist_method: str) -> str:
    """``hist_method`` for the vertical growers (the JAX package's
    ``row_split_hist_method``): ``coarse`` / ``fused`` are row-split
    schemes and train with the exact one-pass kernels after a warning;
    ``mega`` trains as ``scan``, its one-level-at-a-time schedule."""
    base, sfx = hist_method, ""
    for s in ("+sub", "+nosub"):
        if base.endswith(s):
            base, sfx = base[:-len(s)], s
    if base in ("coarse", "fused"):
        warnings.warn(
            f"hist_method='{base}' requires row split; vertical federated "
            "(column split) trains with the exact one-pass histogram "
            "kernels instead (docs/performance.md round 7)", UserWarning,
            stacklevel=3)
        return "auto" + sfx
    if base == "mega":
        return "scan" + sfx
    return hist_method


def exchange_feature_topology(comm, base_local: np.ndarray, max_nbins: int,
                              has_missing: bool, has_cat: bool = False):
    """Every rank's (features with real bins, bin slots, whether it holds
    a categorical feature) through one object allgather -> (this rank's
    feature offset, the global mask, the pooled bin slots, whether any
    rank holds a categorical feature), feature blocks in rank order. The
    pooled slots keep a missing slot where any rank has one (parity with
    the pooled run needs every rank to agree on it, as in the JAX
    package)."""
    with op_context("vertical/topology"):
        parts = comm.allgather_objects((
            np.asarray(base_local, bool),
            int(max_nbins) - int(has_missing), bool(has_missing),
            bool(has_cat)))
    widths = [len(p[0]) for p in parts]
    off = int(sum(widths[:comm.get_rank()]))
    base_global = np.concatenate([np.asarray(p[0], bool) for p in parts])
    nbins = (max(int(p[1]) for p in parts)
             + int(any(bool(p[2]) for p in parts)))
    return off, base_global, nbins, any(bool(p[3]) for p in parts)


def exchange_splits(comm, res: SplitResult, n_words: int) -> SplitResult:
    """The best-split exchange across the parties: this rank's split
    results of the nodes (global features) -> the winners' results on
    this rank's device, categorical words ``n_words`` wide."""
    dev = res.gain.device
    words = (np.zeros((res.gain.shape[0], n_words), np.int64)
             if res.cat_words is None else res.cat_words.cpu().numpy())
    words = np.pad(words, ((0, 0), (0, n_words - words.shape[1])))
    payload = {
        "gain": res.gain.cpu().numpy(),
        "feature": res.feature.cpu().numpy(),
        "bin": res.bin.cpu().numpy(),
        "default_left": res.default_left.cpu().numpy(),
        "left_sum": res.left_sum.cpu().numpy(),
        "right_sum": res.right_sum.cpu().numpy(),
        "is_cat": (np.zeros(res.gain.shape[0], bool) if res.is_cat is None
                   else res.is_cat.cpu().numpy()),
        "cat_words": words,
    }
    with op_context("vertical/best-split"):
        cands = comm.allgather_objects(payload)
    gains = np.stack([c["gain"] for c in cands])              # [P, N]
    # the first maximum: the lowest rank, the pooled lowest feature
    winner = np.argmax(gains, axis=0)
    sel = np.arange(gains.shape[1])

    def pick(k):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([c[k] for c in cands])[winner, sel])).to(dev)

    return SplitResult(gain=pick("gain"), feature=pick("feature"),
                       bin=pick("bin"), default_left=pick("default_left"),
                       left_sum=pick("left_sum"),
                       right_sum=pick("right_sum"), is_cat=pick("is_cat"),
                       cat_words=pick("cat_words"))


def decide_rows(comm, bits: torch.Tensor) -> torch.Tensor:
    """The decision-bit broadcast: this rank's go-right bits [n] (set only
    at the nodes it owns) summed over the ranks, > 0, on its device."""
    with op_context("vertical/decisions"):
        total = comm.allreduce(bits.to(torch.uint8).cpu().numpy(), op="sum")
    return torch.from_numpy(np.asarray(total) > 0).to(bits.device)


class _Parties:
    """The feature topology of a vertical grower, exchanged again before
    every tree's column samples are drawn (``approx`` re-sketches each
    round, and a feature may lose its real bins on one rank only), and
    the grower's per-feature arrays in the pooled layout: this rank's
    features at its offset, every other one without real bins."""

    def bind_features(self) -> None:
        self.comm = collective.get_communicator()
        n_real = self.cuts.n_real_bins()
        self.f_local = len(n_real)
        (self.f_offset, self.base_global, nbins,
         self.any_cat) = exchange_feature_topology(
            self.comm, n_real > 0, self.max_nbins, self.has_missing,
            bool(self.cuts.is_cat().any()))
        self.block = FeatureBlock(self.f_offset, self.f_local,
                                  len(self.base_global), nbins,
                                  self.has_missing)
        nb = nbins - 1 if self.has_missing else nbins
        # the pooled categorical word width (the numeric trees' one word)
        self.n_words = (max(nb, 1) - 1) // 32 + 1 if self.any_cat else 1
        self._on = {k: v for k, v in self._on.items()
                    if k[0] not in ("n_real", "is_cat", "is_onehot")}

    def pooled(self, a: np.ndarray) -> np.ndarray:
        """A per-feature host array of this rank -> the pooled layout."""
        out = np.zeros(len(self.base_global), a.dtype)
        out[self.f_offset:self.f_offset + self.f_local] = a
        return out

    def _n_real_on(self, device: torch.device) -> torch.Tensor:
        return self._host_on("n_real", device, lambda: torch.from_numpy(
            self.pooled(self.cuts.n_real_bins().astype(np.int64))))

    def cat_on(self, device: torch.device) -> Optional[CatInfo]:
        if not self.any_cat:
            return None
        is_cat = self.cuts.is_cat()
        onehot = is_cat & (self.cuts.n_real_bins()
                           <= self.param.max_cat_to_onehot)
        return CatInfo(
            self._host_on("is_cat", device, lambda: torch.from_numpy(
                self.pooled(is_cat))),
            self._host_on("is_onehot", device, lambda: torch.from_numpy(
                self.pooled(onehot))))

    def _split_values(self, sf: np.ndarray, sb: np.ndarray) -> np.ndarray:
        """A finished tree's thresholds: each owner resolves its features'
        from its cuts, one sum-allreduce assembles them (leaves and the
        other parties add 0)."""
        local = sf - self.f_offset
        mine = (local >= 0) & (local < self.f_local)
        vals = np.zeros(len(sf), np.float32)
        if mine.any():
            vals[mine] = self.cuts.split_values(local[mine], sb[mine])
        with op_context("vertical/split-values"):
            return np.asarray(self.comm.allreduce(vals, op="sum"),
                              np.float32)


class VerticalFederatedGrower(_Parties, TreeGrower):
    """Depthwise growth across vertical parties (module docstring): the
    ``TreeGrower`` of the pooled features, whose level loop exchanges a
    level's best splits and decision bits through the communicator.
    ``monotone`` and ``constraint_sets`` are over the global features."""

    def __init__(self, param: TrainParam, max_nbins: int, cuts,
                 hist_method: str = "auto", has_missing: bool = True,
                 monotone: Optional[Sequence[int]] = None,
                 constraint_sets: Optional[np.ndarray] = None) -> None:
        super().__init__(param, max_nbins, cuts,
                         hist_method=row_split_hist_method(hist_method),
                         has_missing=has_missing, monotone=monotone,
                         constraint_sets=constraint_sets)

    def feature_masks(self, tkeys: Sequence[xrandom.Key],
                      device: torch.device):
        """The topology exchange, then the trees' column samples over the
        global features with real bins, as the pooled run draws them."""
        self.bind_features()
        return draw_feature_masks(
            tkeys, torch.from_numpy(self.base_global).to(device),
            self.param, self.param.max_depth)

    def grow(self, bins: torch.Tensor, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from this rank's bins [n, F_local] and the replicated
        gpair [n, 2]; ``masks`` from :meth:`feature_masks`."""
        param, comm = self.param, self.comm
        dev = gpair.device
        monotone, sets = self.constraints_on(dev)
        cat = self.cat_on(dev)
        n_real = self._n_real_on(dev)
        missing_bin = self.max_nbins - 1 if self.has_missing \
            else self.max_nbins
        rows = RowShards([bins])
        # rows replicate: the local sum is the pooled root sum
        tree = HeapTree(param.max_depth, gpair.sum(dim=0), param,
                        n_words=self.n_words if self.any_cat else 0,
                        monotone=monotone, constraint_sets=sets)
        positions = torch.zeros((bins.shape[0],), dtype=torch.int64,
                                device=dev)
        for depth in range(param.max_depth):
            lo, n_level = 2 ** depth - 1, 2 ** depth
            hi = lo + n_level
            fmask, mono_kw = tree.constraint_args(
                lo, n_level, None if masks is None else masks[depth])
            res = search_splits(
                rows, [gpair], [level_rel(positions, lo, n_level)], n_level,
                tree.node_sum[lo:hi], n_real, param=param,
                max_nbins=self.max_nbins, hist_method=self.hist_method,
                has_missing=self.has_missing, schedule=None,
                feature_mask=fmask, cat=cat, block=self.block, **mono_kw)
            can_split = tree.record(lo, n_level, exchange_splits(
                comm, res, self.n_words))
            if not bool(can_split.any()):
                break
            is_split = torch.zeros((tree.max_nodes,), dtype=torch.bool,
                                   device=dev)
            is_split[lo:hi] = can_split
            heap = (tree.split_feature, tree.split_bin, tree.default_left,
                    is_split)
            cats = (tree.is_cat_split, tree.cat_words)
            bits = update_positions(bins, positions, *heap, missing_bin,
                                    *cats, feat_offset=self.f_offset)
            positions = update_positions(None, positions, *heap, missing_bin,
                                         *cats,
                                         decided=decide_rows(comm, bits))
        g = tree.finish(positions)
        if param.max_leaves > 0:
            g = self._truncate_max_leaves(g)
        return g


class VerticalLossguideGrower(_Parties, LossguideGrower):
    """Leaf-wise growth across vertical parties: the greedy loop of
    ``LossguideGrower`` runs on every rank alike; each split's pair is
    searched over the rank's features and exchanged
    (:func:`exchange_splits`), and the popped node's rows move by its
    owner's decision bits."""

    def __init__(self, param: TrainParam, max_nbins: int, cuts,
                 hist_method: str = "auto", has_missing: bool = True,
                 monotone: Optional[Sequence[int]] = None,
                 constraint_sets: Optional[np.ndarray] = None) -> None:
        super().__init__(param, max_nbins, cuts,
                         hist_method=row_split_hist_method(hist_method),
                         has_missing=has_missing, monotone=monotone,
                         constraint_sets=constraint_sets)
        self.schedule = None        # the exact one-pass search a pair

    def feature_masks(self, tkeys: Sequence[xrandom.Key],
                      device: torch.device):
        """The topology exchange, then each tree's host sampler over the
        global features (every one a candidate, as the JAX package's
        vertical sampler draws)."""
        self.bind_features()
        F = len(self.base_global)
        return [col_masks(self.param, k[1], F) for k in tkeys]

    def _feature_width(self, F: int) -> int:
        return len(self.base_global)

    def _eval2(self, rows, gps, positions, id0, id1, parent_sums, fmask,
               n_real_bins, **kw):
        kw.pop("cbs", None)
        res = search_splits(rows, gps, [pair_rel(positions[0], id0, id1)],
                            2, parent_sums, n_real_bins, feature_mask=fmask,
                            block=self.block, **kw)
        return exchange_splits(self.comm, res, self.n_words)

    def _apply1(self, rows, positions, nid, feat, sbin, dleft, is_cat,
                words, left_id, right_id, missing_bin):
        """The popped node's rows moved by its owner's decisions."""
        pos = positions[0]
        at_node = pos == nid
        local = feat - self.f_offset
        if 0 <= local < self.f_local:
            moved = apply1(rows.parts[0], pos, nid, local, sbin, dleft,
                           is_cat, words, left_id, right_id, missing_bin)
            bits = at_node & (moved == right_id)
        else:
            bits = torch.zeros_like(at_node)
        right = decide_rows(self.comm, bits)
        return [torch.where(at_node, torch.where(right, right_id, left_id),
                            pos)]


def federated_vertical_margin(trees, tree_info, n_groups: int,
                              X_local: np.ndarray, f_offset: int, comm,
                              tree_weights=None) -> np.ndarray:
    """Prediction of vertically partitioned rows by the decision-bit
    protocol (the JAX package's ``federated_vertical_margin``; reference
    column-split predictor, ``src/predictor/cpu_predictor.cc``): each
    party decides, for its rows, every node whose split feature it owns
    from its raw values ``X_local`` [n, F_local] (features ``f_offset``
    on), one sum-allreduce ORs the parties' bits, and every party walks
    the whole tree. Returns the margin [n, n_groups] without the base
    score, in float32 and tree order."""
    n, F_loc = X_local.shape
    out = np.zeros((n, n_groups), np.float32)
    info = np.asarray(tree_info, np.int64)
    weights = (np.ones(len(trees), np.float32) if tree_weights is None
               else np.asarray(tree_weights, np.float32))
    rows = np.arange(n)
    for t, tree in enumerate(trees):
        sf = np.asarray(tree.split_feature)
        leaf = np.asarray(tree.is_leaf, bool)
        owned = ~leaf & (sf >= f_offset) & (sf < f_offset + F_loc)
        x = X_local[:, np.clip(sf - f_offset, 0, F_loc - 1)]     # [n, M]
        go_right = x > np.asarray(tree.split_value)[None, :]
        if np.any(tree.is_cat_split):
            cw = np.asarray(tree.cat_words, np.uint32)            # [M, W]
            code = np.maximum(np.nan_to_num(x, nan=0.0), 0.0).astype(
                np.int64)
            widx = np.clip(code // 32, 0, cw.shape[1] - 1)
            word = cw[np.arange(len(sf))[None, :], widx]
            bit = (word >> (code % 32).astype(np.uint32)) & np.uint32(1)
            go_right = np.where(np.asarray(tree.is_cat_split)[None, :],
                                bit == 0, go_right)
        go_right = np.where(np.isnan(x),
                            ~np.asarray(tree.default_left, bool)[None, :],
                            go_right)
        with op_context("vertical/predict"):
            bits = np.asarray(comm.allreduce(
                (go_right & owned[None, :]).astype(np.uint8),
                op="sum")) > 0
        lc, rc = np.asarray(tree.left_child), np.asarray(tree.right_child)
        pos = np.zeros(n, np.int64)
        for _ in range(tree.max_depth()):
            nxt = np.where(bits[rows, pos], rc[pos], lc[pos])
            pos = np.where(leaf[pos], pos, nxt)
        vals = np.asarray(tree.leaf_value, np.float32)[pos] * weights[t]
        out[:, info[t]] += vals
    return out
