"""Tree model container (host numpy; the JAX package's ``tree/tree.py``
without categorical training and dumps).

Node ids are BFS order (root 0, every parent id smaller than its
children); children are addressed through ``left_child`` /
``right_child``. ``to_json`` / ``from_json`` write and read the same
per-tree arrays as the JAX package, so a model saved by either package
loads into the other and saves back to the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class TreeModel:
    """One regression tree in compact BFS layout.

    Invariant: node 0 is the root and ``parent[i] < i`` for every non-root
    node.
    """

    left_child: np.ndarray      # [n] int32, -1 at leaves
    right_child: np.ndarray     # [n] int32, -1 at leaves
    parent: np.ndarray          # [n] int32, -1 at root
    split_feature: np.ndarray   # [n] int32, -1 at leaves
    split_bin: np.ndarray       # [n] int32 local bin threshold
    split_value: np.ndarray     # [n] f32 raw threshold (x <= v -> left)
    default_left: np.ndarray    # [n] bool
    is_leaf: np.ndarray         # [n] bool
    leaf_value: np.ndarray      # [n] f32 (learning rate already applied)
    sum_hess: np.ndarray        # [n] f32 cover
    gain: np.ndarray            # [n] f32 split loss_chg (0 at leaves)
    is_cat_split: np.ndarray = None  # [n] bool
    cat_words: np.ndarray = None     # [n, W] uint32 left-set bitmask
    base_weight: np.ndarray = None   # [n] f32 optimal node weight*eta

    def __post_init__(self):
        n = len(self.is_leaf)
        if self.is_cat_split is None:
            self.is_cat_split = np.zeros(n, bool)
        if self.cat_words is None:
            self.cat_words = np.zeros((n, 1), np.uint32)
        if self.base_weight is None:
            self.base_weight = np.where(self.is_leaf, self.leaf_value,
                                        0.0).astype(np.float32)

    def num_nodes(self) -> int:
        return len(self.is_leaf)

    def depths(self) -> np.ndarray:
        """Per-node depth (root 0); one forward pass via the BFS invariant."""
        d = np.zeros(self.num_nodes(), np.int32)
        for i in range(1, self.num_nodes()):
            d[i] = d[self.parent[i]] + 1
        return d

    def max_depth(self) -> int:
        return int(self.depths().max(initial=0))

    @classmethod
    def from_heap(cls, split_feature, split_bin, split_value, default_left,
                  is_leaf, active, leaf_value, sum_hess, gain,
                  base_weight=None) -> "TreeModel":
        """Compact a heap-layout tree (node i has children 2i+1 / 2i+2,
        ``active`` marks the nodes that exist) into BFS order, as the JAX
        package's ``TreeModel.from_heap``; ``heap_map`` maps heap ids to
        compact ids."""
        cap = len(is_leaf)
        order: List[int] = []
        heap_map = np.full(cap, -1, np.int32)
        queue = [0]
        while queue:
            h = queue.pop(0)
            if h >= cap or not active[h]:
                continue
            heap_map[h] = len(order)
            order.append(h)
            if not is_leaf[h]:
                queue.append(2 * h + 1)
                queue.append(2 * h + 2)
        if not order:            # completely empty tree -> single leaf root
            order = [0]
            heap_map[0] = 0
        o = np.asarray(order, np.int64)
        n = len(order)
        internal = ~np.asarray(is_leaf)[o]
        li = np.minimum(2 * o + 1, cap - 1)
        ri = np.minimum(2 * o + 2, cap - 1)
        left = np.where(internal, heap_map[li], -1).astype(np.int32)
        right = np.where(internal, heap_map[ri], -1).astype(np.int32)
        parent = np.full(n, -1, np.int32)
        parent[left[internal]] = np.nonzero(internal)[0]
        parent[right[internal]] = np.nonzero(internal)[0]
        t = cls(
            left_child=left, right_child=right, parent=parent,
            split_feature=np.where(internal, np.asarray(split_feature)[o],
                                   -1).astype(np.int32),
            split_bin=np.asarray(split_bin)[o].astype(np.int32),
            split_value=np.asarray(split_value)[o].astype(np.float32),
            default_left=np.asarray(default_left)[o].astype(bool),
            is_leaf=~internal,
            leaf_value=np.asarray(leaf_value)[o].astype(np.float32),
            sum_hess=np.asarray(sum_hess)[o].astype(np.float32),
            gain=np.asarray(gain)[o].astype(np.float32),
            base_weight=None if base_weight is None
            else np.asarray(base_weight)[o].astype(np.float32))
        t.heap_map = heap_map
        return t

    @staticmethod
    def single_leaf(value: float = 0.0) -> "TreeModel":
        return TreeModel(
            left_child=np.asarray([-1], np.int32),
            right_child=np.asarray([-1], np.int32),
            parent=np.asarray([-1], np.int32),
            split_feature=np.asarray([-1], np.int32),
            split_bin=np.zeros(1, np.int32),
            split_value=np.zeros(1, np.float32),
            default_left=np.zeros(1, bool),
            is_leaf=np.ones(1, bool),
            leaf_value=np.asarray([value], np.float32),
            sum_hess=np.zeros(1, np.float32),
            gain=np.zeros(1, np.float32))

    def renumbered_bfs(self) -> "TreeModel":
        """An equivalent tree renumbered to BFS order (restores the
        parent<child invariant for models produced elsewhere)."""
        order: List[int] = []
        remap: Dict[int, int] = {}
        queue = [0]
        while queue:
            c = queue.pop(0)
            remap[c] = len(order)
            order.append(c)
            if not self.is_leaf[c]:
                queue.append(int(self.left_child[c]))
                queue.append(int(self.right_child[c]))
        o = np.asarray(order, np.int64)
        n = len(order)
        internal = ~self.is_leaf[o]
        left = np.where(
            internal,
            np.asarray([remap.get(int(x), -1) for x in self.left_child[o]],
                       np.int32), -1).astype(np.int32)
        right = np.where(
            internal,
            np.asarray([remap.get(int(x), -1) for x in self.right_child[o]],
                       np.int32), -1).astype(np.int32)
        parent = np.full(n, -1, np.int32)
        parent[left[internal]] = np.nonzero(internal)[0]
        parent[right[internal]] = np.nonzero(internal)[0]
        return TreeModel(
            left_child=left, right_child=right, parent=parent,
            split_feature=np.where(internal, self.split_feature[o],
                                   -1).astype(np.int32),
            split_bin=self.split_bin[o].copy(),
            split_value=self.split_value[o].copy(),
            default_left=self.default_left[o].copy(),
            is_leaf=~internal,
            leaf_value=self.leaf_value[o].copy(),
            sum_hess=self.sum_hess[o].copy(),
            gain=self.gain[o].copy(),
            is_cat_split=self.is_cat_split[o].copy(),
            cat_words=self.cat_words[o].copy(),
            base_weight=self.base_weight[o].copy())

    # --- serialization (reference model-JSON node arrays) --------------------
    def to_json(self) -> dict:
        n = self.num_nodes()
        cats = {}
        for c in np.nonzero(self.is_cat_split)[0]:
            w = self.cat_words[c]
            cats[str(int(c))] = [int(b) for b in range(len(w) * 32)
                                 if (w[b // 32] >> (b % 32)) & 1]
        return {
            "split_type": [int(x) for x in self.is_cat_split],
            "categories": cats,
            "left_children": self.left_child.tolist(),
            "right_children": self.right_child.tolist(),
            "parents": self.parent.tolist(),
            "split_indices": [int(max(f, 0)) for f in self.split_feature],
            "split_conditions": [
                float(self.leaf_value[c]) if self.is_leaf[c]
                else float(self.split_value[c]) for c in range(n)],
            "default_left": [int(d) for d in self.default_left],
            "loss_changes": self.gain.tolist(),
            "sum_hessian": self.sum_hess.tolist(),
            "split_bins": self.split_bin.tolist(),
            "base_weights": self.base_weight.tolist(),
        }

    @staticmethod
    def from_json(obj: dict) -> "TreeModel":
        left = np.asarray(obj["left_children"], np.int32)
        right = np.asarray(obj["right_children"], np.int32)
        n = len(left)
        if n == 0:
            return TreeModel.single_leaf()
        is_leaf = left < 0
        conds = np.asarray(obj["split_conditions"], np.float64)
        split_type = np.asarray(obj.get("split_type", [0] * n), np.int32)
        categories = obj.get("categories", {})
        n_words = 1
        if categories:
            max_cat = max((max(v) for v in categories.values() if v),
                          default=0)
            n_words = max_cat // 32 + 1
        cat_words = np.zeros((n, n_words), np.uint32)
        for key, members in categories.items():
            c = int(key)
            for b in members:
                cat_words[c, b // 32] |= np.uint32(1 << (b % 32))
        parent = np.full(n, -1, np.int32)
        internal = np.nonzero(~is_leaf)[0]
        parent[left[internal]] = internal
        parent[right[internal]] = internal
        t = TreeModel(
            left_child=left, right_child=right, parent=parent,
            split_feature=np.where(
                is_leaf, -1,
                np.asarray(obj["split_indices"], np.int32)).astype(np.int32),
            split_bin=np.asarray(obj.get("split_bins", [0] * n), np.int32),
            split_value=np.where(is_leaf, 0.0, conds).astype(np.float32),
            default_left=np.asarray(obj["default_left"], bool),
            is_leaf=is_leaf,
            leaf_value=np.where(is_leaf, conds, 0.0).astype(np.float32),
            sum_hess=np.asarray(obj.get("sum_hessian", [0.0] * n),
                                np.float32),
            gain=np.asarray(obj.get("loss_changes", [0.0] * n), np.float32),
            is_cat_split=split_type.astype(bool),
            cat_words=cat_words,
            base_weight=np.asarray(obj.get("base_weights", [0.0] * n),
                                   np.float32))
        if n > 1 and not (parent[1:] < np.arange(1, n)).all():
            t = t.renumbered_bfs()
        return t
