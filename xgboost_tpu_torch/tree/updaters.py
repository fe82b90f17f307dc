"""The updaters of ``process_type="update"``: prune, refresh and sync
over finished trees (the JAX package's ``tree/updaters.py``; reference
``src/tree/updater_prune.cc``, ``updater_refresh.cc``,
``updater_sync.cc``).

They run on the host over a tree's compact numpy arrays, in float64 and
in the JAX package's order (``np.add.at`` over the rows, then children
before parents), so that a refreshed node's statistics are the JAX
package's bits for the same gradients. ``refresh_tree`` returns a new
tree; the tree it is given is left as it was.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np

from ..registry import TREE_UPDATERS
from .param import TrainParam
from .tree import TreeModel

# the updaters process_type="update" runs, in the order its list names them
UPDATERS = ("refresh", "prune", "sync")


@TREE_UPDATERS.register("prune")
def prune_tree(tree: TreeModel, param: TrainParam) -> TreeModel:
    """Turn every split whose children are leaves and whose gain is below
    ``gamma`` into a leaf of its base weight, bottom up (reference
    ``TreePruner::DoPrune``); renumbered BFS without the removed nodes
    when any went."""
    is_leaf = tree.is_leaf.copy()
    gain = tree.gain.copy()
    leaf_value = tree.leaf_value.copy()
    split_feature = tree.split_feature.copy()
    # children have larger ids than their parents, so one reverse sweep
    # collapses a chain upward
    for nid in range(tree.num_nodes() - 1, -1, -1):
        if is_leaf[nid]:
            continue
        li, ri = tree.left_child[nid], tree.right_child[nid]
        if is_leaf[li] and is_leaf[ri] and gain[nid] < param.gamma:
            is_leaf[nid] = True
            split_feature[nid] = -1
            gain[nid] = 0.0
            leaf_value[nid] = tree.base_weight[nid]
    pruned = dataclasses.replace(
        tree,
        left_child=np.where(is_leaf, -1, tree.left_child).astype(np.int32),
        right_child=np.where(is_leaf, -1, tree.right_child).astype(np.int32),
        parent=tree.parent.copy(), split_feature=split_feature,
        split_bin=tree.split_bin.copy(), split_value=tree.split_value.copy(),
        default_left=tree.default_left.copy(), is_leaf=is_leaf,
        leaf_value=leaf_value, sum_hess=tree.sum_hess.copy(), gain=gain,
        is_cat_split=tree.is_cat_split.copy(),
        cat_words=tree.cat_words.copy(),
        base_weight=tree.base_weight.copy())
    if is_leaf.sum() == tree.is_leaf.sum():
        return pruned
    return pruned.renumbered_bfs()


def route_rows(tree: TreeModel, X: np.ndarray) -> np.ndarray:
    """The leaf (compact id) each row of X [n, F] reaches, walking raw
    thresholds: ``x > split_value`` right, NaN the default way; at a
    categorical node a code outside the left set right, a code out of
    range the default way."""
    n = X.shape[0]
    pos = np.zeros(n, np.int64)
    W = tree.cat_words.shape[1]
    for _ in range(tree.max_depth()):
        splitting = ~tree.is_leaf[pos]
        if not splitting.any():
            break
        fid = np.maximum(tree.split_feature[pos], 0)
        x = X[np.arange(n), fid]
        miss = np.isnan(x)
        go_right = x > tree.split_value[pos]
        if tree.is_cat_split.any():
            code = np.where(miss, -1, x).astype(np.int64)
            in_rng = (code >= 0) & (code < W * 32)
            cc = np.clip(code, 0, W * 32 - 1)
            bit = (tree.cat_words[pos, cc // 32]
                   >> (cc % 32).astype(np.uint32)) & 1
            cat_right = np.where(in_rng, bit == 0, ~tree.default_left[pos])
            go_right = np.where(tree.is_cat_split[pos], cat_right, go_right)
        go_right = np.where(miss, ~tree.default_left[pos], go_right)
        child = np.where(go_right, tree.right_child[pos],
                         tree.left_child[pos])
        pos = np.where(splitting, child, pos)
    return pos


@TREE_UPDATERS.register("refresh")
def refresh_tree(tree: TreeModel, X: np.ndarray, gpair: np.ndarray,
                 param: TrainParam, refresh_leaf: bool = True) -> TreeModel:
    """A copy of ``tree`` with every node's hessian sum and base weight
    recomputed from the rows X [n, F] and their gradients gpair [n, 2]
    (reference ``TreeRefresher``), and its leaves set to those weights
    when ``refresh_leaf``. Rows are routed by raw thresholds, so a loaded
    model refreshes without its training cuts."""
    pos = route_rows(tree, X)
    n_nodes = tree.num_nodes()
    g = np.zeros(n_nodes, np.float64)
    h = np.zeros(n_nodes, np.float64)
    np.add.at(g, pos, gpair[:, 0])
    np.add.at(h, pos, gpair[:, 1])
    for nid in range(n_nodes - 1, 0, -1):      # children before parents
        g[tree.parent[nid]] += g[nid]
        h[tree.parent[nid]] += h[nid]
    weight = (-g / (h + param.reg_lambda) * param.eta).astype(np.float32)
    leaf_value = tree.leaf_value.copy()
    if refresh_leaf:
        leaf_value[tree.is_leaf] = weight[tree.is_leaf]
    return dataclasses.replace(tree, sum_hess=h.astype(np.float32),
                               base_weight=weight, leaf_value=leaf_value)


@TREE_UPDATERS.register("sync")
def sync_trees(trees: List[TreeModel], communicator=None
               ) -> List[TreeModel]:
    """Reference ``TreeSyncher``: the trees of rank 0 on every process
    (the JAX package's ``sync_trees``), broadcast as their JSON over
    ``communicator`` (by default the active one). One process holds the
    only copy, so the trees come back as they are."""
    from ..parallel.collective import get_communicator

    comm = communicator if communicator is not None else get_communicator()
    if not comm.is_distributed():
        return trees
    payload = (json.dumps([t.to_json() for t in trees])
               if comm.get_rank() == 0 else None)
    payload = comm.broadcast(payload, root=0)
    return [TreeModel.from_json(o) for o in json.loads(payload)]

