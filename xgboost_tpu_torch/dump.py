"""Model dumps: text, JSON and graphviz dot per tree, one DataFrame row
per node, and the structural report of ``Booster.inspect`` (the JAX
package's ``dump.py`` and ``obs/insight.py model_inspect``; reference
``src/tree/tree_model.cc`` ``TreeGenerator``).

Node ids are the trees' compact BFS ids. A split prints as ``x <
value`` going left ("yes") with the value at ``:.9g``, so two dumps are
equal where the trees are equal bit for bit. A vector leaf prints as
``[a,b,c]`` (a list in JSON). Feature maps (``fmap``) are
accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .tree.tree import TreeModel

IMPORTANCE_TYPES = ("weight", "gain", "cover", "total_gain", "total_cover")


def _fname(feature_names: Optional[List[str]], f: int) -> str:
    if feature_names and 0 <= f < len(feature_names):
        return feature_names[f]
    return f"f{f}"


def _left_set(tree: TreeModel, c: int) -> List[int]:
    w = tree.cat_words[c]
    return [b for b in range(len(w) * 32) if (w[b // 32] >> (b % 32)) & 1]


def _fmt_leaf(v) -> str:
    """A scalar leaf as ``0.5``; a vector leaf as ``[a,b,c]``."""
    if np.ndim(v) == 0:
        return f"{v:.9g}"
    return "[" + ",".join(f"{x:.9g}" for x in np.asarray(v)) + "]"


def _node_condition(tree: TreeModel, c: int,
                    feature_names: Optional[List[str]]) -> str:
    name = _fname(feature_names, int(tree.split_feature[c]))
    if tree.is_cat_split[c]:
        return f"{name}:{{{','.join(str(b) for b in _left_set(tree, c))}}}"
    return f"{name}<{float(tree.split_value[c]):.9g}"


def dump_text(tree: TreeModel, feature_names: Optional[List[str]] = None,
              with_stats: bool = False) -> str:
    lines: List[str] = []
    stack = [(0, 0)]
    while stack:
        c, depth = stack.pop()
        indent = "\t" * depth
        if tree.is_leaf[c]:
            stats = f",cover={tree.sum_hess[c]:.9g}" if with_stats else ""
            lines.append(
                f"{indent}{c}:leaf={_fmt_leaf(tree.leaf_value[c])}{stats}")
            continue
        yes, no = int(tree.left_child[c]), int(tree.right_child[c])
        miss = yes if tree.default_left[c] else no
        stats = (f",gain={tree.gain[c]:.9g},cover={tree.sum_hess[c]:.9g}"
                 if with_stats else "")
        lines.append(f"{indent}{c}:[{_node_condition(tree, c, feature_names)}"
                     f"] yes={yes},no={no},missing={miss}{stats}")
        stack.append((no, depth + 1))
        stack.append((yes, depth + 1))
    return "\n".join(lines) + "\n"


def dump_json(tree: TreeModel, feature_names: Optional[List[str]] = None,
              with_stats: bool = False) -> dict:
    def node(c: int, depth: int) -> dict:
        if tree.is_leaf[c]:
            lv = tree.leaf_value[c]
            out = {"nodeid": c, "leaf": (float(lv) if np.ndim(lv) == 0
                                         else [float(x) for x in lv])}
            if with_stats:
                out["cover"] = float(tree.sum_hess[c])
            return out
        yes, no = int(tree.left_child[c]), int(tree.right_child[c])
        out = {
            "nodeid": c, "depth": depth,
            "split": _fname(feature_names, int(tree.split_feature[c])),
            "yes": yes, "no": no,
            "missing": yes if tree.default_left[c] else no,
            "children": [node(yes, depth + 1), node(no, depth + 1)],
            "split_condition": (_left_set(tree, c) if tree.is_cat_split[c]
                                else float(tree.split_value[c])),
        }
        if with_stats:
            out["gain"] = float(tree.gain[c])
            out["cover"] = float(tree.sum_hess[c])
        return out

    return node(0, 0) if tree.num_nodes() else {}


def dump_dot(tree: TreeModel, feature_names: Optional[List[str]] = None,
             with_stats: bool = False) -> str:
    lines = ["digraph {", "    graph [rankdir=TB]"]
    stack = [0]
    while stack:
        c = stack.pop()
        if tree.is_leaf[c]:
            lines.append(f'    {c} [label="leaf='
                         f'{_fmt_leaf(tree.leaf_value[c])}" shape=box]')
            continue
        lines.append(f'    {c} [label="'
                     f'{_node_condition(tree, c, feature_names)}"]')
        yes, no = int(tree.left_child[c]), int(tree.right_child[c])
        ylab = "yes, missing" if tree.default_left[c] else "yes"
        nlab = "no" if tree.default_left[c] else "no, missing"
        lines.append(f'    {c} -> {yes} [label="{ylab}" color="#0000FF"]')
        lines.append(f'    {c} -> {no} [label="{nlab}" color="#FF0000"]')
        stack.append(no)
        stack.append(yes)
    lines.append("}")
    return "\n".join(lines)


def trees_to_dataframe(trees: List[TreeModel],
                       feature_names: Optional[List[str]] = None):
    """One row a node, trees in order and nodes by id in each, read from
    :func:`dump_json` with its statistics."""
    import pandas as pd

    rows = []
    for t_i, tree in enumerate(trees):
        root = dump_json(tree, feature_names, with_stats=True)
        if not root:
            continue
        nodes: List[dict] = []
        stack = [root]
        while stack:
            n = stack.pop()
            nodes.append(n)
            stack.extend(n.get("children", ()))
        for n in sorted(nodes, key=lambda d: d["nodeid"]):
            c = int(n["nodeid"])
            if "leaf" in n:
                lv = n["leaf"]      # a vector leaf's Gain: its weights' sum
                rows.append({
                    "Tree": t_i, "Node": c, "ID": f"{t_i}-{c}",
                    "Feature": "Leaf", "Split": np.nan, "Yes": np.nan,
                    "No": np.nan, "Missing": np.nan,
                    "Gain": (float(np.sum(lv)) if isinstance(lv, list)
                             else float(lv)),
                    "Cover": float(n["cover"]),
                    "Category": np.nan,
                })
                continue
            cond = n["split_condition"]
            is_cat = isinstance(cond, list)
            rows.append({
                "Tree": t_i, "Node": c, "ID": f"{t_i}-{c}",
                "Feature": n["split"],
                "Split": np.nan if is_cat else float(cond),
                "Yes": f"{t_i}-{int(n['yes'])}",
                "No": f"{t_i}-{int(n['no'])}",
                "Missing": f"{t_i}-{int(n['missing'])}",
                "Gain": float(n["gain"]), "Cover": float(n["cover"]),
                "Category": cond if is_cat else np.nan,
            })
    return pd.DataFrame(rows)


def feature_scores(trees: List[TreeModel], importance_type: str,
                   feature_names: Optional[List[str]]) -> Dict[str, float]:
    """Importance of each feature a split uses (reference
    ``CalcFeatureScore``): ``weight`` (splits), ``total_gain`` /
    ``total_cover`` (sums over its splits), ``gain`` / ``cover`` (their
    means)."""
    scores: Dict[int, float] = {}
    counts: Dict[int, int] = {}
    for tree in trees:
        for h in np.nonzero(~tree.is_leaf)[0]:
            f = int(tree.split_feature[h])
            counts[f] = counts.get(f, 0) + 1
            if importance_type in ("gain", "total_gain"):
                scores[f] = scores.get(f, 0.0) + float(tree.gain[h])
            elif importance_type in ("cover", "total_cover"):
                scores[f] = scores.get(f, 0.0) + float(tree.sum_hess[h])
            else:
                scores[f] = scores.get(f, 0.0) + 1.0
    if importance_type in ("gain", "cover"):
        scores = {f: s / counts[f] for f, s in scores.items()}
    return {_fname(feature_names, f): v for f, v in scores.items()}


def model_inspect(booster) -> Dict[str, Any]:
    """Every importance type, the trees' depth and leaf-count histograms
    and totals, and ``best_iteration`` when early stopping set it."""
    report: Dict[str, Any] = {
        "num_trees": int(booster.num_boosted_rounds()),
        "num_features": int(booster.num_features()),
        "importance": {t: booster.get_score(importance_type=t)
                       for t in IMPORTANCE_TYPES},
    }
    bi = booster.attr("best_iteration")
    if bi is not None:
        report["best_iteration"] = int(bi)
    depth_hist: Dict[str, int] = {}
    leaf_hist: Dict[str, int] = {}
    nodes = leaves = 0
    for t in booster.gbm.trees:
        d, nl = str(t.max_depth()), int(t.is_leaf.sum())
        depth_hist[d] = depth_hist.get(d, 0) + 1
        leaf_hist[str(nl)] = leaf_hist.get(str(nl), 0) + 1
        nodes += t.num_nodes()
        leaves += nl
    report["tree_shape"] = {
        "trees": len(booster.gbm.trees), "nodes_total": nodes,
        "leaves_total": leaves,
        "depth_hist": dict(sorted(depth_hist.items(),
                                  key=lambda kv: int(kv[0]))),
        "leaf_hist": dict(sorted(leaf_hist.items(),
                                 key=lambda kv: int(kv[0]))),
    }
    return report
