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

Not ported here (each raises where it is asked for): the coarse / fused
/ scan / mega schedules and sibling subtraction (ROADMAP A.6), sampling
(A.5.2), monotone and interaction constraints (A.5.4), categorical
splits (A.5.5), ``max_leaves`` truncation and lossguide (A.5.6), meshes
and column split (A.8).
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from ..ops.histogram import build_hist, resolve_hist_kernel
from ..ops.partition import update_positions
from ..ops.split import evaluate_splits
from .param import TrainParam, _f32, calc_weight
from .tree import TreeModel

_EPS = 1e-6  # reference kRtEps


class GrownTree(NamedTuple):
    """Device-side tree arrays (heap layout) plus per-row results."""

    split_feature: torch.Tensor  # [max_nodes] int64, -1 at leaves
    split_bin: torch.Tensor      # [max_nodes] int64
    default_left: torch.Tensor   # [max_nodes] bool
    is_leaf: torch.Tensor        # [max_nodes] bool
    active: torch.Tensor         # [max_nodes] bool
    leaf_value: torch.Tensor     # [max_nodes] f32 (eta applied)
    node_sum: torch.Tensor       # [max_nodes, 2] f32
    gain: torch.Tensor           # [max_nodes] f32
    positions: torch.Tensor      # [n_rows] int64 final heap node per row
    delta: torch.Tensor          # [n_rows] f32 leaf value per row
    base_weight: torch.Tensor    # [max_nodes] f32 node weight * eta


def grow_tree(bins: torch.Tensor, gpair: torch.Tensor,
              n_real_bins: torch.Tensor, *, param: TrainParam,
              max_nbins: int, hist_method: str = "auto",
              has_missing: bool = True) -> GrownTree:
    """One tree from bins [n, F] and gpair [n, 2] f32 on one device;
    ``n_real_bins`` [F] int64 on the same device."""
    n, F = bins.shape
    dev = bins.device
    max_depth = param.max_depth
    max_nodes = 2 ** (max_depth + 1) - 1
    # out-of-range sentinel when the matrix carries no missing slot
    missing_bin = max_nbins - 1 if has_missing else max_nbins
    for depth in range(max_depth):      # refuse an unported method up front
        resolve_hist_kernel(hist_method, n, 2 ** depth, max_nbins,
                            has_missing)

    split_feature = torch.full((max_nodes,), -1, dtype=torch.int64,
                               device=dev)
    split_bin = torch.zeros((max_nodes,), dtype=torch.int64, device=dev)
    default_left = torch.zeros((max_nodes,), dtype=torch.bool, device=dev)
    is_leaf = torch.ones((max_nodes,), dtype=torch.bool, device=dev)
    active = torch.zeros((max_nodes,), dtype=torch.bool, device=dev)
    active[0] = True
    gain = torch.zeros((max_nodes,), dtype=torch.float32, device=dev)
    node_sum = torch.zeros((max_nodes, 2), dtype=torch.float32, device=dev)
    node_sum[0] = gpair.sum(dim=0)
    positions = torch.zeros((n,), dtype=torch.int64, device=dev)
    min_gain = _f32(max(param.gamma, _EPS))

    for depth in range(max_depth):
        lo = 2 ** depth - 1
        n_level = 2 ** depth
        hi = lo + n_level
        in_level = (positions >= lo) & (positions < hi)
        rel = torch.where(in_level, positions - lo,
                          torch.full_like(positions, n_level))
        hist = build_hist(bins, gpair, rel, n_level, max_nbins,
                          method=hist_method, has_missing=has_missing)
        res = evaluate_splits(hist, node_sum[lo:hi], n_real_bins, param,
                              has_missing=has_missing)
        # a node exists at this level iff its parent split; it expands
        # unless the best gain fails the gamma / kRtEps test
        can_split = (active[lo:hi] & (res.gain > min_gain)
                     & torch.isfinite(res.gain))
        split_feature[lo:hi] = torch.where(can_split, res.feature,
                                           torch.full_like(res.feature, -1))
        split_bin[lo:hi] = torch.where(can_split, res.bin,
                                       torch.zeros_like(res.bin))
        default_left[lo:hi] = can_split & res.default_left
        is_leaf[lo:hi] = ~can_split
        gain[lo:hi] = torch.where(can_split, res.gain,
                                  torch.zeros_like(res.gain))
        children = slice(2 * lo + 1, 2 * hi + 1)    # [l0, r0, l1, r1, ...]
        active[children] = can_split.repeat_interleave(2)
        zero2 = torch.zeros_like(res.left_sum)
        node_sum[children] = torch.stack(
            [torch.where(can_split[:, None], res.left_sum, zero2),
             torch.where(can_split[:, None], res.right_sum, zero2)],
            dim=1).reshape(-1, 2)
        is_split = torch.zeros((max_nodes,), dtype=torch.bool, device=dev)
        is_split[lo:hi] = can_split
        positions = update_positions(bins, positions, split_feature,
                                     split_bin, default_left, is_split,
                                     missing_bin)

    w = calc_weight(node_sum[:, 0], node_sum[:, 1], param) * _f32(param.eta)
    zero = torch.zeros_like(w)
    leaf_value = torch.where(active & is_leaf, w, zero)
    base_weight = torch.where(active, w, zero)
    return GrownTree(split_feature=split_feature, split_bin=split_bin,
                     default_left=default_left, is_leaf=is_leaf,
                     active=active, leaf_value=leaf_value, node_sum=node_sum,
                     gain=gain, positions=positions,
                     delta=leaf_value[positions], base_weight=base_weight)


class TreeGrower:
    """Host-side wrapper: checks what this slice can grow, runs
    :func:`grow_tree` and turns its heap into a :class:`TreeModel`."""

    def __init__(self, param: TrainParam, max_nbins: int, cuts,
                 hist_method: str = "auto", has_missing: bool = True) -> None:
        if param.grow_policy != "depthwise":
            raise NotImplementedError(
                f"grow_policy={param.grow_policy!r} is not in the PyTorch "
                "port yet (ROADMAP A.5.6)")
        if param.max_leaves > 0:
            raise NotImplementedError(
                "max_leaves > 0 is not in the PyTorch port yet "
                "(ROADMAP A.5.6)")
        if min(param.subsample, param.colsample_bytree,
               param.colsample_bylevel, param.colsample_bynode) < 1.0:
            raise NotImplementedError(
                "row and column sampling below 1 are not in the PyTorch "
                "port yet (ROADMAP A.5.2)")
        if any(int(c) for c in re.findall(r"-?\d+",
                                          param.monotone_constraints)) \
                or param.interaction_constraints.strip():
            raise NotImplementedError(
                "monotone and interaction constraints are not in the "
                "PyTorch port yet (ROADMAP A.5.4)")
        if cuts.is_cat().any():
            raise NotImplementedError(
                "categorical features are not in the PyTorch port yet "
                "(ROADMAP A.5.5)")
        if param.max_depth < 1:
            raise ValueError("grow_policy=depthwise requires max_depth > 0")
        self.param = param
        self.max_nbins = max_nbins
        self.cuts = cuts
        self.hist_method = hist_method
        self.has_missing = has_missing
        self._n_real = {}

    def grow(self, bins: torch.Tensor, gpair: torch.Tensor) -> GrownTree:
        key = str(bins.device)
        if key not in self._n_real:
            self._n_real[key] = torch.from_numpy(
                self.cuts.n_real_bins().astype(np.int64)).to(bins.device)
        return grow_tree(bins, gpair, self._n_real[key], param=self.param,
                         max_nbins=self.max_nbins,
                         hist_method=self.hist_method,
                         has_missing=self.has_missing)

    def to_tree_model(self, g: GrownTree) -> TreeModel:
        """Pull the heap to the host, compact it, attach raw thresholds."""
        sf = g.split_feature.cpu().numpy()
        sb = g.split_bin.cpu().numpy()
        return TreeModel.from_heap(
            split_feature=sf, split_bin=sb,
            split_value=self.cuts.split_values(sf, sb),
            default_left=g.default_left.cpu().numpy(),
            is_leaf=g.is_leaf.cpu().numpy(), active=g.active.cpu().numpy(),
            leaf_value=g.leaf_value.cpu().numpy(),
            sum_hess=g.node_sum[:, 1].cpu().numpy(),
            gain=g.gain.cpu().numpy(),
            base_weight=g.base_weight.cpu().numpy())
