"""Row partitioning: heap positions advanced one level at a time.

The port of the JAX package's ``ops/partition.py update_positions``
(reference ``CommonRowPartitioner::UpdatePosition``) in gather form:
``positions [n]`` holds each row's heap node (root 0, children of i at
2i+1 / 2i+2); a row at a node that just split moves to
``2 * node + 1 + go_right``. The JAX package runs shallow levels through
``advance_positions_level``, a one-hot matmul shaped for the TPU's matrix
unit; its integer result equals this gather's. Categorical splits wait
with ROADMAP A.5.5.
"""

from __future__ import annotations

import torch


def gather_bins(bins: torch.Tensor, rows: torch.Tensor,
                feat: torch.Tensor) -> torch.Tensor:
    """bins[rows, feat] as int64 for uint8/uint16/int32 bins (uint16 is
    gathered through its int16 view, which every backend supports)."""
    src = bins.view(torch.int16) if bins.dtype == torch.uint16 else bins
    b = src[rows, feat].to(torch.int64)
    return b & 0xFFFF if bins.dtype == torch.uint16 else b


def update_positions(bins: torch.Tensor, positions: torch.Tensor,
                     split_feature: torch.Tensor, split_bin: torch.Tensor,
                     default_left: torch.Tensor, is_split: torch.Tensor,
                     missing_bin: int) -> torch.Tensor:
    """bins [n, F]; positions [n] int64 heap ids; split_* / is_split
    [max_nodes] (is_split True where the node was just expanded) -> new
    positions [n]. Rows at nodes that did not split stay put."""
    feat = split_feature[positions]
    thr = split_bin[positions]
    dleft = default_left[positions]
    splitting = is_split[positions]
    rows = torch.arange(positions.shape[0], device=positions.device)
    b = gather_bins(bins, rows, torch.clamp(feat, min=0))
    go_right = torch.where(b == missing_bin, ~dleft, b > thr)
    return torch.where(splitting, 2 * positions + 1 + go_right.long(),
                       positions)
