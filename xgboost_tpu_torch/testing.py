"""Synthetic forests and data for tests and the chip smoke run.

:func:`make_forest` grows random trees of a given shape from a numpy
``RandomState(seed)``; :func:`make_forest_model` wraps a one-group
forest as a native-schema JSON model that both this package and the
JAX package load. Inputs drawn from N(0, 1) reach every part of such a
forest, since its thresholds are drawn from N(0, 1) as well.
:func:`agaricus_rows` / :func:`write_libsvm` make files of the shape of
XGBoost's agaricus demo data.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np

from .tree.tree import TreeModel

# an internal node at this depth or deeper becomes a leaf with PRUNE_P
PRUNE_DEPTH = 4
PRUNE_P = 0.1


def _make_tree(rng: np.random.RandomState, max_depth: int, n_features: int,
               cat_features: Sequence[int], n_categories: int) -> TreeModel:
    """One BFS tree grown to ``max_depth``."""
    cat_set = set(int(c) for c in cat_features)
    n_words = max(1, (n_categories + 31) // 32)
    left: List[int] = []
    right: List[int] = []
    parent: List[int] = []
    feat: List[int] = []
    value: List[float] = []
    dleft: List[bool] = []
    is_leaf: List[bool] = []
    is_cat: List[bool] = []
    cat_rows: List[np.ndarray] = []
    depth: List[int] = []
    queue = [(-1, 0)]                       # (parent id, depth)
    while queue:
        par, d = queue.pop(0)
        nid = len(left)
        leaf = d >= max_depth or (d >= PRUNE_DEPTH
                                  and rng.rand() < PRUNE_P)
        words = np.zeros(n_words, np.uint32)
        parent.append(par)
        depth.append(d)
        if leaf:
            left.append(-1)
            right.append(-1)
            feat.append(-1)
            value.append(float(rng.normal(0.0, 0.05)))
            dleft.append(False)
            is_cat.append(False)
        else:
            f = int(rng.randint(n_features))
            cat = f in cat_set
            if cat:
                members = np.nonzero(rng.rand(n_categories) < 0.5)[0]
                for b in members:
                    words[b // 32] |= np.uint32(1 << (int(b) % 32))
                value.append(0.0)
            else:
                value.append(float(rng.normal(0.0, 1.0)))
            feat.append(f)
            dleft.append(bool(rng.rand() < 0.5))
            is_cat.append(cat)
            left.append(-2)                 # filled once the child exists
            right.append(-2)
            queue.append((nid, d + 1))
            queue.append((nid, d + 1))
        is_leaf.append(leaf)
        cat_rows.append(words)
        if par >= 0:
            if left[par] == -2:
                left[par] = nid
            else:
                right[par] = nid
    n = len(left)
    is_leaf_a = np.asarray(is_leaf, bool)
    value_a = np.asarray(value, np.float32)
    return TreeModel(
        left_child=np.asarray(left, np.int32),
        right_child=np.asarray(right, np.int32),
        parent=np.asarray(parent, np.int32),
        split_feature=np.asarray(feat, np.int32),
        split_bin=np.zeros(n, np.int32),
        split_value=np.where(is_leaf_a, 0.0, value_a).astype(np.float32),
        default_left=np.asarray(dleft, bool),
        is_leaf=is_leaf_a,
        leaf_value=np.where(is_leaf_a, value_a, 0.0).astype(np.float32),
        # cover halves with depth, so it is positive everywhere
        sum_hess=(1024.0 / 2.0 ** np.asarray(depth)).astype(np.float32),
        gain=np.zeros(n, np.float32),
        is_cat_split=np.asarray(is_cat, bool),
        cat_words=np.stack(cat_rows))


def make_forest(n_trees: int, max_depth: int, n_features: int,
                n_groups: int = 1, cat_features: Sequence[int] = (),
                seed: int = 0, n_categories: int = 16
                ) -> Tuple[List[TreeModel], np.ndarray]:
    """-> (trees, tree_info): ``n_trees`` random BFS trees grown to
    ``max_depth`` (an internal node at depth >= 4 becomes a leaf with
    probability 0.1), split features uniform over ``n_features``,
    thresholds from N(0, 1), default directions from a coin flip, leaf
    values from N(0, 0.05). Splits on ``cat_features`` are categorical,
    with a random left set over ``n_categories`` codes. Tree ``t``
    belongs to group ``t % n_groups``."""
    rng = np.random.RandomState(seed)
    trees = [_make_tree(rng, max_depth, n_features, cat_features,
                        n_categories) for _ in range(n_trees)]
    tree_info = np.arange(n_trees, dtype=np.int32) % n_groups
    return trees, tree_info


def make_forest_model(n_trees: int, max_depth: int, n_features: int,
                      objective: str = "binary:logistic",
                      seed: int = 0) -> bytes:
    """A one-group numeric forest from :func:`make_forest` as
    native-schema JSON model bytes: one tree per round, base margin 0.5."""
    trees, tree_info = make_forest(n_trees, max_depth, n_features,
                                   seed=seed)
    model = {
        "version": [0, 1, 0],
        "learner": {
            "attributes": {},
            "feature_names": [],
            "feature_types": [],
            "learner_model_param": {
                "base_score": [0.5],
                "num_class": 0,
                "num_target": 1,
                "num_feature": n_features,
            },
            "objective": {"name": objective},
            "gradient_booster": {
                "name": "gbtree",
                "num_parallel_tree": 1,
                "multi_strategy": "one_output_per_tree",
                "trees": [t.to_json() for t in trees],
                "tree_info": [int(g) for g in tree_info],
                "iteration_indptr": list(range(n_trees + 1)),
            },
        },
        "config": {"learner_params": {"objective": objective,
                                      "booster": "gbtree"}},
    }
    return json.dumps(model).encode()


# UCI Mushroom's 22 attributes and their numbers of values (cap-shape ...
# habitat); one-hot, they are the 126 features of agaricus.txt.{train,test}
MUSHROOM_CARDINALITIES = (6, 4, 10, 2, 9, 4, 3, 2, 12, 2, 7, 4, 4, 9, 9, 2,
                          4, 3, 8, 9, 6, 7)
ODOR, SPORE_PRINT_COLOR = 4, 19
AGARICUS_FLIP = 0.02


def agaricus_rows(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(labels [n] f32, indices [n, 22] int64): each row one value of
    each attribute, as the 1-based libsvm index of its one-hot feature
    (1-126, ascending along the row). A row is positive when its odor is
    one of the first 4 of 9 values, or the fifth with a spore-print color
    among the first 3 of 9 (48.1%), then 2% of the labels flip; made from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    card = np.asarray(MUSHROOM_CARDINALITIES)
    codes = (rng.random((n, len(card))) * card).astype(np.int64)
    pos = (codes[:, ODOR] < 4) | ((codes[:, ODOR] == 4)
                                  & (codes[:, SPORE_PRINT_COLOR] < 3))
    pos ^= rng.random(n) < AGARICUS_FLIP
    offsets = np.concatenate([[1], 1 + np.cumsum(card)[:-1]])
    return pos.astype(np.float32), codes + offsets


def write_libsvm(path: str, labels: np.ndarray, indices: np.ndarray) -> None:
    """Lines ``label idx:1 idx:1 ...``, as agaricus.txt has them."""
    tail = [" ".join(f"{j}:1" for j in row) for row in indices.tolist()]
    with open(path, "w") as fh:
        fh.writelines(f"{int(y)} {t}\n" for y, t in zip(labels, tail))
