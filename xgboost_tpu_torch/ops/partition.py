"""Row partitioning: heap positions advanced one level at a time.

The port of the JAX package's ``ops/partition.py update_positions``
(reference ``CommonRowPartitioner::UpdatePosition``) in gather form:
``positions [n]`` holds each row's heap node (root 0, children of i at
2i+1 / 2i+2); a row at a node that just split moves to
``2 * node + 1 + go_right``. The JAX package runs shallow levels through
``advance_positions_level``, a one-hot matmul shaped for the TPU's matrix
unit; its integer result equals this gather's. At a categorical split
(bin == category code) a row goes right unless its code is in the
node's left set, uint32 words held in int64 (:func:`cat_goes_right`);
a missing value goes the default way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LevelSplits(NamedTuple):
    """The splits of one level of ``n`` nodes starting at heap node ``lo``
    (the JAX package's ``"dense"`` payload of ``fused_advance_coarse``):
    feature (-1 where the node did not split), threshold bin, default
    direction and whether the node split, [n] each."""

    lo: int
    feat: torch.Tensor
    thr: torch.Tensor
    dleft: torch.Tensor
    can_split: torch.Tensor
    # categorical splits: [n] bool and the left sets [n, W]
    is_cat: Optional[torch.Tensor] = None
    cat_words: Optional[torch.Tensor] = None


def gather_bins(bins: torch.Tensor, rows: torch.Tensor,
                feat: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """bins[rows, feat] as int64 for uint8/uint16/int32 bins (uint16 is
    gathered through its int16 view, which every backend supports).
    ``packed``: ``bins`` is a u4-packed page (``ops/histogram.py
    unpack_u4``) and the id is feature ``feat``'s nibble."""
    if packed:
        b = bins[rows, feat >> 1].to(torch.int64)
        return (b >> (4 * (feat & 1))) & 0xF
    src = bins.view(torch.int16) if bins.dtype == torch.uint16 else bins
    b = src[rows, feat].to(torch.int64)
    return b & 0xFFFF if bins.dtype == torch.uint16 else b


def cat_goes_right(b: torch.Tensor, words: torch.Tensor,
                   node: torch.Tensor) -> torch.Tensor:
    """b [n] int64 category codes (>= 0); words [N, W] int64 left sets;
    node [n] each row's row of ``words`` -> True where the code is NOT in
    the left set (the JAX package's ``cat_goes_right``)."""
    W = words.shape[1]
    word = words[node, torch.clamp(b >> 5, max=W - 1)]
    return ((word >> (b & 31)) & 1) == 0


def _route(bins, positions, feat, thr, dleft, splitting, missing_bin,
           packed=False, is_cat=None, words=None, node=None):
    """Advance the rows that are ``splitting``; a categorical split
    (``is_cat`` [n]) tests the row's code against ``words[node]``."""
    rows = torch.arange(positions.shape[0], device=positions.device)
    b = gather_bins(bins, rows, torch.clamp(feat, min=0), packed)
    go_right = b > thr
    if is_cat is not None:
        go_right = torch.where(is_cat, cat_goes_right(b, words, node),
                               go_right)
    go_right = torch.where(b == missing_bin, ~dleft, go_right)
    return torch.where(splitting, 2 * positions + 1 + go_right.long(),
                       positions)


def level_rel(positions: torch.Tensor, lo: int, n_level: int) -> torch.Tensor:
    """[n] int32 position relative to the level of ``n_level`` nodes
    starting at heap node ``lo``; ``n_level`` outside it (inactive)."""
    in_level = (positions >= lo) & (positions < lo + n_level)
    return torch.where(in_level, positions - lo,
                       torch.full_like(positions, n_level)).to(torch.int32)


def update_positions(bins: torch.Tensor, positions: torch.Tensor,
                     split_feature: torch.Tensor, split_bin: torch.Tensor,
                     default_left: torch.Tensor, is_split: torch.Tensor,
                     missing_bin: int,
                     is_cat_split: Optional[torch.Tensor] = None,
                     cat_words: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """bins [n, F]; positions [n] int64 heap ids; split_* / is_split
    [max_nodes] (is_split True where the node was just expanded) -> new
    positions [n]. Rows at nodes that did not split stay put.
    ``is_cat_split`` [max_nodes] / ``cat_words`` [max_nodes, W]: the
    categorical splits and their left sets."""
    return _route(bins, positions, split_feature[positions],
                  split_bin[positions], default_left[positions],
                  is_split[positions], missing_bin,
                  is_cat=(None if is_cat_split is None
                          else is_cat_split[positions]),
                  words=cat_words, node=positions)


def advance_level(bins: torch.Tensor, positions: torch.Tensor,
                  prev: LevelSplits, missing_bin: int,
                  packed: bool = False) -> torch.Tensor:
    """The same advance below one level's splits given as a per-level
    payload (the plain advance of ``fused_advance_coarse``, and of the
    paged grower's pages, u4-packed when ``packed``): rows outside the
    level, and rows at its nodes that did not split, stay put. Equal to
    the JAX package's ``advance_positions_level`` and, over the whole
    heap, ``update_positions``."""
    n_prev = prev.feat.shape[0]
    in_prev = (positions >= prev.lo) & (positions < prev.lo + n_prev)
    rel = torch.where(in_prev, positions - prev.lo,
                      torch.zeros_like(positions))
    return _route(bins, positions, prev.feat[rel], prev.thr[rel],
                  prev.dleft[rel], in_prev & prev.can_split[rel],
                  missing_bin, packed,
                  is_cat=None if prev.is_cat is None else prev.is_cat[rel],
                  words=prev.cat_words, node=rel)
