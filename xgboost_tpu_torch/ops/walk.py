"""The packed-forest walk.

``walk_packed`` chooses by the device of ``X`` alone: on a CUDA tensor
it launches the hand-written Hopper kernel (``ops/cuda/walk.py``), on a
CPU tensor it runs :func:`walk_packed_reference`. Nothing else.

:func:`walk_packed_reference` is a line-by-line twin of the JAX
package's ``ops/walk.py walk_packed`` on tensors: the same
``max_depth`` loop of gathers, the same per-chunk
``leaf_v[:, lo:hi] @ group_onehot[lo:hi]`` left fold, and ``base``
added strictly AFTER the fold. The CPU tests hold it against JAX, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

:func:`walk_fold_kernel_order` replays, in PyTorch, the one order in which
the kernel sums a row's leaf terms in every schedule and batch; the tests
and ``chip_smoke.py`` hold the kernel's margins to it bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..serve.packed import (CAT_BIT, DL_BIT, FEAT_BITS, LEAF_BIT,
                            OFFSET_BITS)

_OFF_MASK = (1 << OFFSET_BITS) - 1
_FEAT_MASK = (1 << FEAT_BITS) - 1


def _bit(w: torch.Tensor, b: int) -> torch.Tensor:
    # words are int32 holding uint32 bits: >> is arithmetic, so mask
    # after every shift (bit 31 would otherwise read as -1)
    return ((w >> b) & 1) == 1


def walk_packed_reference(words: torch.Tensor, values: torch.Tensor,
                          tree_offsets: torch.Tensor,
                          tree_weight: torch.Tensor,
                          group_onehot: torch.Tensor, X: torch.Tensor,
                          base: torch.Tensor,
                          cat_words: Optional[torch.Tensor] = None, *,
                          max_depth: int, tree_chunk: int,
                          leaf_index: bool = False):
    """-> margin [n, G] (plus the final flat node index [n, Tp] int32
    when ``leaf_index``), in plain PyTorch on any device."""
    n = X.shape[0]
    Tp = tree_offsets.shape[0]
    idx = tree_offsets.long()[None, :].expand(n, Tp)
    if cat_words is not None:
        n_cats = cat_words.shape[-1] * 32

    for _ in range(max_depth):
        w = words[idx]
        leaf = _bit(w, LEAF_BIT)
        cat_node = _bit(w, CAT_BIT)
        dl = _bit(w, DL_BIT)
        feat = ((w >> OFFSET_BITS) & _FEAT_MASK).long()
        delta = (w & _OFF_MASK).long()
        x = torch.gather(X, 1, feat)
        go_right = x > values[idx]
        missing = torch.isnan(x)
        if cat_words is not None:
            # code = trunc(x) toward zero, in range when 0 <= code < n_cats;
            # compared in float so NaN and huge values never reach an int
            # conversion (the JAX walk's astype saturates to the same
            # out-of-range verdict)
            xt = torch.trunc(x)
            in_range = (xt >= 0) & (xt < n_cats)
            code = torch.where(in_range, xt, torch.zeros_like(xt)).long()
            word = cat_words[idx, code // 32]
            left = ((word >> (code % 32)) & 1) == 1
            go_right = torch.where(cat_node, ~left, go_right)
            missing = missing | (cat_node & ~in_range)
        go_right = torch.where(missing, ~dl, go_right)
        nxt = idx + delta + go_right.long()
        idx = torch.where(leaf, idx, nxt)

    leaf_v = values[idx] * tree_weight[None, :]        # [n, Tp]
    m_total = None
    for lo in range(0, Tp, tree_chunk):
        hi = min(lo + tree_chunk, Tp)
        m = leaf_v[:, lo:hi] @ group_onehot[lo:hi]
        m_total = m if m_total is None else m_total + m
    margin = m_total + base[None, :]
    if leaf_index:
        return margin, idx.to(torch.int32)
    return margin


def walk_fold_kernel_order(leaf_v: torch.Tensor, tree_weight: torch.Tensor,
                           tree_group: torch.Tensor,
                           base: torch.Tensor) -> torch.Tensor:
    """Margin [n, G] from the leaf values ``leaf_v`` [n, Tp] (``values``
    at :func:`walk_packed_reference`'s leaf indices), summed in the
    kernel's order (``csrc/walk.cu``): each term is ``leaf * weight``
    rounded once. One group: partial l folds the terms of slots t = l mod
    32 in increasing t, from 0; then a[l] += a[l + o] for o = 16, 8, 4,
    2, 1; then ``base``. Several groups: each group's terms folded left in
    slot order, from 0; then ``base``. Used by the tests and
    ``chip_smoke.py`` only."""
    terms = leaf_v * tree_weight[None, :]
    n, Tp = terms.shape
    G = base.shape[0]
    if G == 1:
        acc = torch.zeros((n, 32), dtype=terms.dtype, device=terms.device)
        for t0 in range(0, Tp, 32):
            block = terms[:, t0:t0 + 32]
            acc[:, :block.shape[1]] = acc[:, :block.shape[1]] + block
        for o in (16, 8, 4, 2, 1):
            acc = acc[:, :o] + acc[:, o:2 * o]
        return acc + base[None, :]
    acc = torch.zeros((n, G), dtype=terms.dtype, device=terms.device)
    for t, g in enumerate(tree_group.tolist()):
        acc[:, g] = acc[:, g] + terms[:, t]
    return acc + base[None, :]


def walk_packed(words: torch.Tensor, values: torch.Tensor,
                tree_offsets: torch.Tensor, tree_weight: torch.Tensor,
                group_onehot: torch.Tensor, X: torch.Tensor,
                base: torch.Tensor,
                cat_words: Optional[torch.Tensor] = None, *,
                max_depth: int, tree_chunk: int, tree_group: torch.Tensor,
                max_feature: int, leaf_index: bool = False,
                nodes: Optional[torch.Tensor] = None, spans=None,
                plans: Optional[dict] = None,
                schedule: Optional[str] = None):
    """Margin [n, G] of a packed forest (plus ``leaf_index`` [n, Tp] on
    request). A CUDA ``X`` goes through the Hopper kernel, a CPU ``X``
    through :func:`walk_packed_reference`. ``tree_group`` (each tree's
    output group) and ``max_feature`` (the largest split feature id) are
    what the kernel takes in place of ``group_onehot`` and a device-side
    bounds check; ``nodes``, ``spans``, ``plans`` and ``schedule`` (the
    forest's interleaved nodes and tree spans, its cache of launch plans
    and a forced schedule, ``ops/cuda/walk.py``) only the kernel reads."""
    if X.device.type == "cpu":
        return walk_packed_reference(
            words, values, tree_offsets, tree_weight, group_onehot, X, base,
            cat_words, max_depth=max_depth, tree_chunk=tree_chunk,
            leaf_index=leaf_index)
    from .cuda.walk import walk_packed_cuda

    margin, leaves = walk_packed_cuda(
        words, values, tree_offsets, tree_weight, tree_group, X, base,
        cat_words, max_depth=max_depth, max_feature=max_feature,
        leaf_index=leaf_index, nodes=nodes, spans=spans, plans=plans,
        schedule=schedule)
    return (margin, leaves) if leaf_index else margin
