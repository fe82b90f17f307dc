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

:func:`leaf_positions` is the same level walk over raw values (the JAX
package's ``_predict_margin`` positions): ``x > split_value`` goes
right, NaN the default way, and at a categorical node a code outside
the left set right and a code out of range the default way. It gives
``predict(pred_leaf=True)``.

Vector-leaf trees (``tree/multi.py``) stack with their [K] leaves, and
a row's margin is the sum of its leaves' K weights over the trees plus
the base (the JAX package's ``_predict_margin_multi`` and
``_predict_margin_binned_multi``, XLA code there too): through the bins
(:func:`margin_binned`) or the raw values (:func:`margin_raw`, which
``predict`` and the evaluation sets use, since the packed walk, K1,
takes scalar trees only, in both packages).
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
    [T * M, W] (uint32 words in int64) when a tree splits a category.
    Vector-leaf trees: ``leaf_value`` [T * M, K], and every tree adds to
    all K groups."""

    split_feature: torch.Tensor
    split_bin: torch.Tensor
    split_value: torch.Tensor
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
        first = getattr(trees[0], name)
        out = np.full((T, M) + first.shape[1:], fill, dtype)
        for i, t in enumerate(trees):
            out[i, :t.num_nodes()] = getattr(t, name)
        return torch.from_numpy(out.reshape((T * M,) + first.shape[1:])).to(
            device)

    onehot = np.zeros((T, n_groups), np.float32)
    onehot[np.arange(T), np.asarray(tree_info, np.int64)] = 1.0
    return StackedForest(
        split_feature=pad("split_feature", -1, np.int64),
        split_bin=pad("split_bin", 0, np.int64),
        split_value=pad("split_value", 0.0, np.float32),
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


def _chunks(forest: StackedForest, n: int):
    """Tree ranges [t0, t1) whose [rows, trees] (and, with vector leaves,
    [rows, trees, K]) walk arrays stay within ``WALK_CHUNK_ELEMENTS``."""
    T = forest.group_onehot.shape[0]
    width = max(n, 1) * (forest.leaf_value.shape[1]
                         if forest.leaf_value.dim() == 2 else 1)
    chunk = max(1, min(T, WALK_CHUNK_ELEMENTS // width))
    return [(t0, min(T, t0 + chunk)) for t0 in range(0, T, chunk)]


def _walk(forest: StackedForest, n: int, dev: torch.device, t0: int,
          t1: int, go_right):
    """Every row's compact node in trees [t0, t1) after ``max_depth``
    steps: (the trees' node offsets [1, t], positions [n, t] int64).
    ``go_right(gi)``: the rows' direction at the flat nodes ``gi``."""
    tofs = (torch.arange(t0, t1, device=dev) * forest.n_nodes)[None, :]
    pos = torch.zeros((n, t1 - t0), dtype=torch.int64, device=dev)
    for _ in range(forest.max_depth):
        gi = tofs + pos
        child = torch.where(go_right(gi), forest.right_child[gi],
                            forest.left_child[gi])
        pos = torch.where(forest.is_leaf[gi], pos, child)
    return tofs, pos


def _add_leaves(margin: torch.Tensor, forest: StackedForest,
                leaf_ids: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """``margin`` [n, G] plus the leaves at ``leaf_ids`` [n, t] of trees
    [t0, t1): each at its weight into its group, or, vector leaves, their
    K weights summed over the trees."""
    leaf = forest.leaf_value[leaf_ids]
    if leaf.dim() == 3:                                     # [n, t, K]
        return margin + leaf.sum(dim=1)
    if forest.tree_weight is not None:
        leaf = leaf * forest.tree_weight[None, t0:t1]
    return margin + leaf @ forest.group_onehot[t0:t1]


def _binned_step(forest: StackedForest, bins: torch.Tensor,
                 missing_bin: int, packed: bool):
    rows = torch.arange(bins.shape[0], device=bins.device)[:, None]

    def go_right(gi):
        feat = forest.split_feature[gi].clamp(min=0)
        b = gather_bins(bins, rows.expand_as(feat), feat, packed)
        right = b > forest.split_bin[gi]
        if forest.cat_words is not None:
            right = torch.where(forest.is_cat_split[gi],
                                cat_goes_right(b, forest.cat_words, gi),
                                right)
        return torch.where(b == missing_bin, ~forest.default_left[gi], right)
    return go_right


def _raw_step(forest: StackedForest, X: torch.Tensor):
    n_cats = 0 if forest.cat_words is None else forest.cat_words.shape[1] * 32

    def go_right(gi):
        x = torch.gather(X, 1, forest.split_feature[gi].clamp(min=0))
        right = x > forest.split_value[gi]
        missing = torch.isnan(x)
        if forest.cat_words is not None:
            code = torch.where(missing, torch.full_like(x, -1.0),
                               x).to(torch.int64)
            in_range = (code >= 0) & (code < n_cats)
            cc = code.clamp(0, n_cats - 1)
            word = torch.gather(forest.cat_words[gi], 2,
                                (cc // 32)[..., None])[..., 0]
            left = ((word >> (cc % 32)) & 1) == 1
            cat = forest.is_cat_split[gi]
            right = torch.where(cat, ~left, right)
            missing = missing | (cat & ~in_range)
        return torch.where(missing, ~forest.default_left[gi], right)
    return go_right


def margin_binned(forest: StackedForest, bins: torch.Tensor,
                  missing_bin: int, base: torch.Tensor,
                  packed: bool = False) -> torch.Tensor:
    """Margins [n, G] of ``forest`` over bin ids ``bins`` [n, F] (a
    u4-packed page when ``packed``), plus ``base`` [G]."""
    n = bins.shape[0]
    step = _binned_step(forest, bins, missing_bin, packed)
    margin = base[None, :].expand(n, -1).clone()
    for t0, t1 in _chunks(forest, n):
        tofs, pos = _walk(forest, n, bins.device, t0, t1, step)
        margin = _add_leaves(margin, forest, tofs + pos, t0, t1)
    return margin


def margin_raw(forest: StackedForest, X: torch.Tensor,
               base: torch.Tensor) -> torch.Tensor:
    """Margins [n, G] of ``forest`` over the raw values X [n, F] (f32,
    NaN missing), plus ``base`` [G]: the walk of vector-leaf trees, which
    the packed walk does not take."""
    n = X.shape[0]
    step = _raw_step(forest, X)
    margin = base[None, :].expand(n, -1).clone()
    for t0, t1 in _chunks(forest, n):
        tofs, pos = _walk(forest, n, X.device, t0, t1, step)
        margin = _add_leaves(margin, forest, tofs + pos, t0, t1)
    return margin


def leaf_positions(forest: StackedForest, X: torch.Tensor) -> torch.Tensor:
    """The compact node id of the leaf each row of X [n, F] (f32, NaN
    missing) reaches in each tree of ``forest``: int32 [n, T]."""
    n = X.shape[0]
    step = _raw_step(forest, X)
    return torch.cat([_walk(forest, n, X.device, t0, t1, step)[1]
                      for t0, t1 in _chunks(forest, n)],
                     dim=1).to(torch.int32)
