"""The forest walk over bin ids (the JAX package's ``boosting/predict.py
_predict_margin_binned`` and ``ForestPredictor.margin_binned``), as torch
ops.

This is the margin cache's walk on an iterator-built matrix, whose raw
values were never kept, and dart's walk of the training matrix: every
(row, tree) pair steps one level at a time through the trees' compact
arrays, comparing the row's bin id with the node's split bin (``bin >
split_bin`` goes right, the missing bin the default way; at a
categorical node, where bin == category code, a code outside the node's
left set goes right), and the leaves, each times its tree's weight
(dart's ``weight_drop``; 1 otherwise), are summed per output group. The
JAX package runs it as an XLA function, not a Pallas kernel. Trees are
walked in chunks so that the [rows, trees] positions stay small; a
paged matrix is walked page by page (``boosting/gbtree.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.partition import cat_goes_right, gather_bins
from ..tree.tree import TreeModel

# the [rows, trees] position arrays of one chunk hold at most this many
# entries
WALK_CHUNK_ELEMENTS = 1 << 24


class StackedForest(NamedTuple):
    """Trees' compact arrays padded to M nodes, flattened to [T * M], and
    each tree's output group as a one-hot [T, G]; ``tree_weight`` [T]
    (None: every weight 1); ``is_cat_split`` [T * M] and ``cat_words``
    [T * M, W] (uint32 words in int64) when a tree splits a category."""

    split_feature: torch.Tensor
    split_bin: torch.Tensor
    default_left: torch.Tensor
    is_leaf: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    leaf_value: torch.Tensor
    group_onehot: torch.Tensor
    n_nodes: int                # M
    max_depth: int
    tree_weight: Optional[torch.Tensor] = None
    is_cat_split: Optional[torch.Tensor] = None
    cat_words: Optional[torch.Tensor] = None


def stack_trees(trees: Sequence[TreeModel], tree_info: Sequence[int],
                n_groups: int, device: torch.device,
                tree_weights: Optional[np.ndarray] = None) -> StackedForest:
    """The trees as a :class:`StackedForest` on ``device``."""
    T = len(trees)
    M = max(t.num_nodes() for t in trees)
    cats = None
    if any(t.is_cat_split.any() for t in trees):
        W = max(t.cat_words.shape[1] for t in trees)
        words = np.zeros((T, M, W), np.int64)
        for i, t in enumerate(trees):
            words[i, :t.num_nodes(), :t.cat_words.shape[1]] = t.cat_words
        cats = torch.from_numpy(words.reshape(T * M, W)).to(device)

    def pad(name, fill, dtype):
        out = np.full((T, M), fill, dtype)
        for i, t in enumerate(trees):
            out[i, :t.num_nodes()] = getattr(t, name)
        return torch.from_numpy(out.reshape(-1)).to(device)

    onehot = np.zeros((T, n_groups), np.float32)
    onehot[np.arange(T), np.asarray(tree_info, np.int64)] = 1.0
    return StackedForest(
        split_feature=pad("split_feature", -1, np.int64),
        split_bin=pad("split_bin", 0, np.int64),
        default_left=pad("default_left", False, bool),
        is_leaf=pad("is_leaf", True, bool),
        left_child=pad("left_child", 0, np.int64),
        right_child=pad("right_child", 0, np.int64),
        leaf_value=pad("leaf_value", 0.0, np.float32),
        group_onehot=torch.from_numpy(onehot).to(device), n_nodes=M,
        max_depth=max(t.max_depth() for t in trees),
        tree_weight=None if tree_weights is None else torch.from_numpy(
            np.asarray(tree_weights, np.float32)).to(device),
        is_cat_split=None if cats is None
        else pad("is_cat_split", False, bool),
        cat_words=cats)


def margin_binned(forest: StackedForest, bins: torch.Tensor,
                  missing_bin: int, base: torch.Tensor,
                  packed: bool = False) -> torch.Tensor:
    """Margins [n, G] of ``forest`` over bin ids ``bins`` [n, F] (a
    u4-packed page when ``packed``), plus ``base`` [G]."""
    n = bins.shape[0]
    dev = bins.device
    M, T = forest.n_nodes, forest.group_onehot.shape[0]
    chunk = max(1, min(T, WALK_CHUNK_ELEMENTS // max(n, 1)))
    rows = torch.arange(n, device=dev)[:, None]
    margin = base[None, :].expand(n, -1).clone()
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        tofs = (torch.arange(t0, t1, device=dev) * M)[None, :]
        pos = torch.zeros((n, t1 - t0), dtype=torch.int64, device=dev)
        for _ in range(forest.max_depth):
            gi = tofs + pos
            feat = forest.split_feature[gi].clamp(min=0)
            b = gather_bins(bins, rows.expand_as(feat), feat, packed)
            go_right = b > forest.split_bin[gi]
            if forest.cat_words is not None:
                go_right = torch.where(
                    forest.is_cat_split[gi],
                    cat_goes_right(b, forest.cat_words, gi), go_right)
            go_right = torch.where(b == missing_bin, ~forest.default_left[gi],
                                   go_right)
            child = torch.where(go_right, forest.right_child[gi],
                                forest.left_child[gi])
            pos = torch.where(forest.is_leaf[gi], pos, child)
        leaf = forest.leaf_value[tofs + pos]
        if forest.tree_weight is not None:
            leaf = leaf * forest.tree_weight[None, t0:t1]
        margin = margin + leaf @ forest.group_onehot[t0:t1]
    return margin
