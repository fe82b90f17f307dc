"""Gradient-boosted tree ensemble: the model container only.

The serving subset of the JAX package's ``boosting/gbtree.py``: the
forest, its per-tree output groups and per-round boundaries, and the
same JSON payload. Growing trees comes with the training slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..tree.tree import TreeModel


class GBTree:
    name = "gbtree"

    def __init__(self, n_groups: int, num_parallel_tree: int = 1,
                 multi_strategy: str = "one_output_per_tree") -> None:
        self.n_groups = n_groups
        self.num_parallel_tree = num_parallel_tree
        self.multi_strategy = multi_strategy
        self.trees: List[TreeModel] = []
        self.tree_info: List[int] = []
        self.iteration_indptr: List[int] = [0]

    def _tree_range(self, iteration_range=None):
        """iteration_range -> (tree_lo, tree_hi) indices."""
        if iteration_range is not None and iteration_range != (0, 0):
            b, e = iteration_range
            e = min(e if e else self.num_boosted_rounds(),
                    self.num_boosted_rounds())
            return self.iteration_indptr[b], self.iteration_indptr[e]
        return 0, len(self.trees)

    def forest_slice(self, iteration_range=None):
        """-> (trees, tree_info, tree_weights) of the selected rounds; every
        gbtree tree has weight 1, so tree_weights is None."""
        lo, hi = self._tree_range(iteration_range)
        return self.trees[lo:hi], np.asarray(self.tree_info[lo:hi]), None

    def num_boosted_rounds(self) -> int:
        return len(self.iteration_indptr) - 1

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "num_parallel_tree": self.num_parallel_tree,
            "multi_strategy": self.multi_strategy,
            "trees": [t.to_json() for t in self.trees],
            "tree_info": list(self.tree_info),
            "iteration_indptr": list(self.iteration_indptr),
        }

    def from_json(self, obj: dict) -> None:
        if any("n_targets" in t for t in obj["trees"]):
            raise NotImplementedError(
                "multi_output_tree (vector-leaf) models are not in the "
                "PyTorch port yet")
        self.num_parallel_tree = int(obj.get("num_parallel_tree", 1))
        self.multi_strategy = obj.get("multi_strategy",
                                      "one_output_per_tree")
        self.trees = [TreeModel.from_json(t) for t in obj["trees"]]
        self.tree_info = [int(x) for x in obj["tree_info"]]
        self.iteration_indptr = [int(x) for x in obj["iteration_indptr"]]
