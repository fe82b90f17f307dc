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

Column split (the JAX package's ``decision_axis`` and ``feat_offset``):
a shard holds global features [``feat_offset``, ``feat_offset`` + F) and
can decide only the rows whose node splits on one of them. Each advance
then runs twice. First on every shard with its ``feat_offset``: the
result is the shard's go-right bits [n] bool, set only at the nodes it
owns. The caller ORs the shards' bits (``tree/shards.py
ColShards.decide``) and calls the advance again with ``decided=`` those
bits, which moves the rows as the pooled bins would have.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LevelSplits(NamedTuple):
    """The splits of one level of ``n`` nodes starting at heap node ``lo``
    (the JAX package's ``"dense"`` payload of ``fused_advance_coarse``):
    feature (-1 where the node did not split), threshold bin, default
    direction and whether the node split, [n] each. Under the ``mega``
    schedule ``lo`` is a 0-d device tensor and the level is padded to its
    capacity with nodes that did not split (:func:`advance_level` takes
    both)."""

    lo: "int | torch.Tensor"
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
           packed=False, is_cat=None, words=None, node=None,
           feat_offset=None, decided=None):
    """Advance the rows that are ``splitting``; a categorical split
    (``is_cat`` [n]) tests the row's code against ``words[node]``.
    ``feat_offset``: this shard's go-right bits at the nodes it owns;
    ``decided``: the ORed bits, which move the rows (module
    docstring)."""
    if decided is None:
        rows = torch.arange(positions.shape[0], device=positions.device)
        owned = None
        if feat_offset is not None:
            feat = feat - feat_offset
            owned = (feat >= 0) & (feat < bins.shape[1]) & splitting
            feat = torch.clamp(feat, max=bins.shape[1] - 1)
        b = gather_bins(bins, rows, torch.clamp(feat, min=0), packed)
        go_right = b > thr
        if is_cat is not None:
            go_right = torch.where(is_cat, cat_goes_right(b, words, node),
                                   go_right)
        go_right = torch.where(b == missing_bin, ~dleft, go_right)
        if owned is not None:
            return owned & go_right
    else:
        go_right = decided
    return torch.where(splitting, 2 * positions + 1 + go_right.long(),
                       positions)


def level_rel(positions: torch.Tensor, lo, n_level,
              n_cap: Optional[int] = None) -> torch.Tensor:
    """[n] int32 position relative to the level of ``n_level`` nodes
    starting at heap node ``lo``; ``n_level`` outside it (inactive).
    ``n_cap``: the level padded to ``n_cap`` nodes (the ``mega``
    schedule's capacity, ``tree/grow.py``): rows outside it take
    ``n_cap``, and ``lo`` / ``n_level`` may be 0-d device tensors."""
    cap = n_level if n_cap is None else n_cap
    in_level = (positions >= lo) & (positions < lo + n_level)
    return torch.where(in_level, positions - lo,
                       torch.full_like(positions, cap)).to(torch.int32)


def update_positions(bins: torch.Tensor, positions: torch.Tensor,
                     split_feature: torch.Tensor, split_bin: torch.Tensor,
                     default_left: torch.Tensor, is_split: torch.Tensor,
                     missing_bin: int,
                     is_cat_split: Optional[torch.Tensor] = None,
                     cat_words: Optional[torch.Tensor] = None,
                     feat_offset: Optional[int] = None,
                     decided: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """bins [n, F]; positions [n] int64 heap ids; split_* / is_split
    [max_nodes] (is_split True where the node was just expanded) -> new
    positions [n]. Rows at nodes that did not split stay put.
    ``is_cat_split`` [max_nodes] / ``cat_words`` [max_nodes, W]: the
    categorical splits and their left sets. ``feat_offset`` /
    ``decided``: the two passes of column split (module docstring;
    ``split_feature`` holds global ids, and ``bins`` is unused with
    ``decided``)."""
    return _route(bins, positions, split_feature[positions],
                  split_bin[positions], default_left[positions],
                  is_split[positions], missing_bin,
                  is_cat=(None if is_cat_split is None
                          else is_cat_split[positions]),
                  words=cat_words, node=positions, feat_offset=feat_offset,
                  decided=decided)


def advance_level(bins: torch.Tensor, positions: torch.Tensor,
                  prev: LevelSplits, missing_bin: int,
                  packed: bool = False, feat_offset: Optional[int] = None,
                  decided: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same advance below one level's splits given as a per-level
    payload (the plain advance of ``fused_advance_coarse``, and of the
    paged grower's pages, u4-packed when ``packed``): rows outside the
    level, and rows at its nodes that did not split, stay put. Equal to
    the JAX package's ``advance_positions_level`` and, over the whole
    heap, ``update_positions``; ``feat_offset`` / ``decided`` as
    there."""
    n_prev = prev.feat.shape[0]
    in_prev = (positions >= prev.lo) & (positions < prev.lo + n_prev)
    rel = torch.where(in_prev, positions - prev.lo,
                      torch.zeros_like(positions))
    return _route(bins, positions, prev.feat[rel], prev.thr[rel],
                  prev.dleft[rel], in_prev & prev.can_split[rel],
                  missing_bin, packed,
                  is_cat=None if prev.is_cat is None else prev.is_cat[rel],
                  words=prev.cat_words, node=rel, feat_offset=feat_offset,
                  decided=decided)
