"""Gradient-boosted tree ensemble: the forest container and one boosting
round for a single output group.

The port of the JAX package's ``boosting/gbtree.py``: the forest, its
per-tree output groups and per-round boundaries, the same JSON payload,
and ``do_boost`` for K = 1 with ``num_parallel_tree`` 1 and no sampling
(so no random numbers are drawn). Multiclass, random forests and dart
wait with ROADMAP A.5.1, A.5.2 and A.5.9.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..tree.grow import TreeGrower
from ..tree.param import TrainParam
from ..tree.tree import TreeModel


class GBTree:
    name = "gbtree"

    def __init__(self, n_groups: int, num_parallel_tree: int = 1,
                 multi_strategy: str = "one_output_per_tree") -> None:
        self.n_groups = n_groups
        self.num_parallel_tree = num_parallel_tree
        self.multi_strategy = multi_strategy
        # set by the Booster before training
        self.tree_param = TrainParam()
        self.hist_method = "auto"
        self.trees: List[TreeModel] = []
        self.tree_info: List[int] = []
        self.iteration_indptr: List[int] = [0]
        self._grower: Optional[TreeGrower] = None

    # -- training -------------------------------------------------------------
    def _grower_for(self, binned) -> TreeGrower:
        if self._grower is None or self._grower.cuts is not binned.cuts:
            self._grower = TreeGrower(self.tree_param, binned.max_nbins,
                                      binned.cuts,
                                      hist_method=self.hist_method,
                                      has_missing=binned.has_missing)
        return self._grower

    def do_boost(self, binned, gpair: torch.Tensor) -> torch.Tensor:
        """gpair [n, K, 2] on the device of ``binned`` -> margin delta
        [n, K]; appends the round's trees."""
        K = gpair.shape[1]
        if K != 1 or self.n_groups != 1:
            raise NotImplementedError(
                "multi-output boosting is not in the PyTorch port yet "
                "(ROADMAP A.5.1)")
        if self.num_parallel_tree != 1:
            raise NotImplementedError(
                "num_parallel_tree > 1 is not in the PyTorch port yet "
                "(ROADMAP A.5.2)")
        grower = self._grower_for(binned)
        grown = grower.grow(binned.bins, gpair[:, 0, :].contiguous())
        self.trees.append(grower.to_tree_model(grown))
        self.tree_info.append(0)
        self.iteration_indptr.append(len(self.trees))
        return grown.delta[:, None]

    def version(self) -> int:
        """Tree count: the margin caches slice trees by it."""
        return len(self.trees)

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
