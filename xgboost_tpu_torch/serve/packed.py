"""Packed forest layout: the walk's structure-of-arrays form.

Every node of every tree collapses into ONE 32-bit **node word** (left-
child offset + feature id + default-left + cat + leaf flag) plus one f32
**value plane** (split threshold at internal nodes, leaf value at
leaves), all trees concatenated forest-major into flat arrays addressed
through ``tree_offsets`` (the layout of "Booster: An Accelerator for
Gradient Boosting Decision Trees", arxiv 2011.02022). A node visit is
two loads: one word, one float.

Children are packed ADJACENT (``right = left + 1``); the packer
renumbers each tree into that order. The tree axis is padded to a power
of two with inert zero-weight trees that all point at one shared leaf.
The packer validates every field width and raises ``PackError`` rather
than write a corrupt word.

This is the same packer as the JAX package's ``serve/packed.py``: both
produce the same bytes for the same forest. On the device the words are
kept as ``torch.int32`` holding the same bits, because PyTorch's
``uint32`` lacks most operators.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

# ------------------------------------------------------------ word layout
#
#   bits  0..15  left-child offset, relative to the node's own flat index
#                (right child = left + 1); 0 at leaves
#   bits 16..28  split feature id; 0 at leaves
#   bit   29     default-left (missing values go left)
#   bit   30     categorical split (route by cat_words bitmask)
#   bit   31     leaf flag (value plane holds the leaf value)
#
# csrc/walk.cu hard-codes the same layout.

OFFSET_BITS = 16
FEAT_BITS = 13
DL_BIT = 29
CAT_BIT = 30
LEAF_BIT = 31

# trees per leaf-reduction chunk of the plain walk (the chunking of the
# JAX package's ForestPredictor, which the packed walk replays)
TREE_CHUNK = 64


class PackError(ValueError):
    """The forest does not fit the packed word's field widths."""


def _field_layout():
    """Shifts/masks derived from the width constants at call time."""
    if OFFSET_BITS + FEAT_BITS > DL_BIT:
        raise PackError(
            f"packed-word fields overflow: offset({OFFSET_BITS}) + "
            f"feat({FEAT_BITS}) bits collide with flag bit {DL_BIT}")
    return {
        "off_mask": np.uint32((1 << OFFSET_BITS) - 1),
        "feat_shift": np.uint32(OFFSET_BITS),
        "feat_mask": np.uint32((1 << FEAT_BITS) - 1),
        "dl_bit": np.uint32(1 << DL_BIT),
        "cat_bit": np.uint32(1 << CAT_BIT),
        "leaf_bit": np.uint32(1 << LEAF_BIT),
    }


def _adjacent_order(tree) -> np.ndarray:
    """BFS node order in which siblings are numbered consecutively
    (left, then right) — maps new id -> old compact id."""
    order: List[int] = []
    queue = [0]
    while queue:
        nid = queue.pop(0)
        order.append(nid)
        if not tree.is_leaf[nid]:
            queue.append(int(tree.left_child[nid]))
            queue.append(int(tree.right_child[nid]))
    return np.asarray(order, np.int64)


def tree_step(n_rows: int) -> int:
    """Trees per leaf-reduction chunk for a batch of ``n_rows`` — the
    JAX package's chunking policy, so the plain walk sums in the same
    order as the JAX walk."""
    budget = (1 << 24) // max(n_rows, 1)
    return min(TREE_CHUNK, 1 << max(budget, 1).bit_length() - 1)


class PackedForest:
    """Forest-major packed node arrays plus the walk-side metadata.

    Host arrays:

    - ``words``   [N] uint32 — packed node words (layout above)
    - ``values``  [N] f32    — split threshold / leaf value union
    - ``hess``    [N] f32    — node cover
    - ``cat_words`` [N, W] uint32 — left-set bitmasks (all-zero w/o cats)
    - ``tree_offsets`` [Tp] int32 — root flat index per tree; pad trees
      all point at one shared inert leaf
    - ``tree_weight`` [Tp] f32, ``group_onehot`` [Tp, G] f32
    - ``tree_group`` [Tp] int32 — the output group of each tree (argmax
      of ``group_onehot``; 0 for pad trees, whose weight is 0)
    """

    ARRAYS = ("words", "values", "hess", "cat_words", "tree_offsets",
              "n_nodes", "tree_weight", "group_onehot", "tree_info")

    def __init__(self, words, values, hess, cat_words, tree_offsets,
                 n_nodes, tree_weight, group_onehot, tree_info,
                 max_depth: int, n_trees: int, has_cat: bool) -> None:
        self.words = np.ascontiguousarray(words, np.uint32)
        self.values = np.ascontiguousarray(values, np.float32)
        self.hess = np.ascontiguousarray(hess, np.float32)
        self.cat_words = np.ascontiguousarray(cat_words, np.uint32)
        self.tree_offsets = np.ascontiguousarray(tree_offsets, np.int32)
        self.n_nodes = np.ascontiguousarray(n_nodes, np.int32)  # [T] real
        self.tree_weight = np.ascontiguousarray(tree_weight, np.float32)
        self.group_onehot = np.ascontiguousarray(group_onehot, np.float32)
        self.tree_info = np.ascontiguousarray(tree_info, np.int32)
        self.max_depth = int(max_depth)
        self.n_trees = int(n_trees)
        self.has_cat = bool(has_cat)
        self.tree_group = np.ascontiguousarray(
            self.group_onehot.argmax(axis=1), np.int32)
        internal = (self.words >> np.uint32(LEAF_BIT)) == 0
        feats = (self.words[internal] >> np.uint32(OFFSET_BITS)) \
            & np.uint32((1 << FEAT_BITS) - 1)
        # the walk reads X[row, feature]: the batch must be wider than this
        self.max_feature = int(feats.max()) if feats.size else -1
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._dev_lock = threading.Lock()

    @property
    def n_groups(self) -> int:
        return self.group_onehot.shape[1]

    # ------------------------------------------------------------- packing
    @classmethod
    def from_trees(cls, trees, tree_info, n_groups: int,
                   tree_weights: Optional[np.ndarray] = None
                   ) -> "PackedForest":
        if not trees:
            raise PackError("cannot pack an empty forest")
        lay = _field_layout()
        T = len(trees)
        has_cat = any(t.is_cat_split.any() for t in trees)
        W = max(t.cat_words.shape[1] for t in trees) if has_cat else 1
        n_nodes = np.asarray([t.num_nodes() for t in trees], np.int32)
        total = int(n_nodes.sum()) + 1          # +1 shared pad-tree leaf
        words = np.zeros(total, np.uint32)
        values = np.zeros(total, np.float32)
        hess = np.zeros(total, np.float32)
        cat = np.zeros((total, W), np.uint32)
        offsets = np.zeros(T, np.int64)

        off = 0
        for t_i, tree in enumerate(trees):
            order = _adjacent_order(tree)
            n = len(order)
            if n != tree.num_nodes():
                raise PackError(
                    f"tree {t_i}: {tree.num_nodes() - n} nodes unreachable "
                    "from the root; refusing to pack a disconnected tree")
            inv = np.empty(n, np.int64)         # old compact id -> new id
            inv[order] = np.arange(n)
            leaf = tree.is_leaf[order]
            feat = np.where(leaf, 0, tree.split_feature[order])
            # children were renumbered adjacently: right == left + 1
            left_new = np.where(leaf, 0,
                                inv[np.maximum(tree.left_child[order], 0)])
            delta = np.where(leaf, 0, left_new - np.arange(n))
            if (~leaf).any():
                if int(feat.max(initial=0)) > int(lay["feat_mask"]):
                    raise PackError(
                        f"tree {t_i}: feature id {int(feat.max())} "
                        f"overflows the {FEAT_BITS}-bit field "
                        f"(max {int(lay['feat_mask'])})")
                d_int = delta[~leaf]
                if d_int.min(initial=1) < 1 or \
                        int(d_int.max(initial=1)) > int(lay["off_mask"]):
                    raise PackError(
                        f"tree {t_i}: left-child offset "
                        f"{int(d_int.max(initial=1))} overflows the "
                        f"{OFFSET_BITS}-bit field "
                        f"(max {int(lay['off_mask'])})")
            w = delta.astype(np.uint32) \
                | (feat.astype(np.uint32) << lay["feat_shift"]) \
                | np.where(tree.default_left[order],
                           lay["dl_bit"], np.uint32(0)) \
                | np.where(tree.is_cat_split[order],
                           lay["cat_bit"], np.uint32(0)) \
                | np.where(leaf, lay["leaf_bit"], np.uint32(0))
            words[off:off + n] = w
            values[off:off + n] = np.where(leaf, tree.leaf_value[order],
                                           tree.split_value[order])
            hess[off:off + n] = tree.sum_hess[order]
            cat[off:off + n, :tree.cat_words.shape[1]] = \
                tree.cat_words[order]
            offsets[t_i] = off
            off += n
        # shared inert leaf for pow2 pad trees
        words[off] = lay["leaf_bit"]

        Tp = 1 << max(T - 1, 0).bit_length()
        tree_offsets = np.full(Tp, off, np.int64)
        tree_offsets[:T] = offsets
        w_arr = (np.ones(T, np.float32) if tree_weights is None
                 else np.asarray(tree_weights, np.float32))
        tree_weight = np.zeros(Tp, np.float32)
        tree_weight[:T] = w_arr
        onehot = np.zeros((Tp, n_groups), np.float32)
        onehot[np.arange(T), np.asarray(tree_info)] = 1.0
        max_depth = max(t.max_depth() for t in trees)
        return cls(words, values, hess, cat if has_cat
                   else np.zeros((total, 1), np.uint32),
                   tree_offsets, n_nodes, tree_weight, onehot,
                   np.asarray(tree_info, np.int32), max_depth, T, has_cat)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, object]) -> "PackedForest":
        """Adopt packed arrays made elsewhere (the JAX package's packer
        gives the same layout): the nine arrays of :attr:`ARRAYS` plus
        ``max_depth``, ``n_trees`` and ``has_cat``."""
        return cls(*(np.asarray(arrays[k]) for k in cls.ARRAYS),
                   max_depth=int(arrays["max_depth"]),
                   n_trees=int(arrays["n_trees"]),
                   has_cat=bool(arrays["has_cat"]))

    @classmethod
    def from_booster(cls, booster, iteration_range=None) -> "PackedForest":
        trees, tree_info, tree_weights = booster.gbm.forest_slice(
            iteration_range)
        return cls.from_trees(trees, tree_info, int(booster.n_groups),
                              tree_weights)

    # ------------------------------------------------------------ the walk
    def device_arrays(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The walk's buffers as tensors on ``device``, uploaded once per
        device. Words are int32 tensors holding the uint32 bits."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            with self._dev_lock:
                d = self._dev.get(key)
                if d is None:
                    def put(a):
                        return torch.from_numpy(a).to(device)
                    d = {"words": put(self.words.view(np.int32)),
                         "values": put(self.values),
                         "tree_offsets": put(self.tree_offsets),
                         "tree_weight": put(self.tree_weight),
                         "group_onehot": put(self.group_onehot),
                         "tree_group": put(self.tree_group)}
                    if self.has_cat:
                        d["cat_words"] = put(self.cat_words.view(np.int32))
                    self._dev[key] = d
        return d

    def margin(self, X, base, *, device: Optional[str] = None,
               leaf_index: bool = False):
        """Margin [n, G] (and, on request, the final flat node index
        [n, Tp]) of a batch through the packed walk. A tensor ``X`` runs
        on its own device; anything else is moved to ``device`` (the
        card unless the caller asks for ``"cpu"``)."""
        from ..context import resolve_device
        from ..ops.walk import walk_packed

        if isinstance(X, torch.Tensor):
            dev = X.device
        else:
            dev = resolve_device(device or "cuda")
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        base = torch.as_tensor(base, dtype=torch.float32, device=dev)
        if tuple(base.shape) != (self.n_groups,):
            raise ValueError(f"base must have shape ({self.n_groups},), "
                             f"got {tuple(base.shape)}")
        d = self.device_arrays(dev)
        return walk_packed(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], X.contiguous(), base, d.get("cat_words"),
            max_depth=self.max_depth, tree_chunk=tree_step(X.shape[0]),
            tree_group=d["tree_group"], max_feature=self.max_feature,
            leaf_index=leaf_index)

    # ----------------------------------------------------------- metadata
    @property
    def nbytes(self) -> int:
        return (self.words.nbytes + self.values.nbytes + self.hess.nbytes
                + (self.cat_words.nbytes if self.has_cat else 0)
                + self.tree_offsets.nbytes + self.tree_weight.nbytes
                + self.group_onehot.nbytes)

    def describe(self) -> Dict[str, object]:
        return {"n_trees": self.n_trees,
                "n_nodes": int(self.n_nodes.sum()),
                "max_depth": self.max_depth,
                "has_cat": self.has_cat,
                "nbytes": self.nbytes}
