"""Reference-format model reader.

Loads models in the reference XGBoost JSON/UBJSON schema by converting
them to the native model dict that ``Booster`` reads. Semantics bridged
(the same as the JAX package's ``interop.py``):

- Split comparison: the reference routes ``x < split_condition`` left;
  this framework routes ``x <= split_value`` left. Conversion nudges
  thresholds one f32 ulp (``nextafter``), which preserves the decision
  for every float input.
- Leaf values ride in ``split_conditions`` on leaf rows.
- Categorical splits: the reference stores the RIGHT-branch category
  set; native trees store the LEFT set, so sets are complemented over
  the observed category domain.
- ``base_score`` is user-space in the reference file; native boosters
  hold the margin, so the objective's transform is inverted on load.
- Dart: the trees sit under ``gradient_booster.gbtree`` and each tree's
  weight in ``weight_drop``.
- Ranking objectives: ``lambdarank_param`` (or ``lambda_rank_param``)
  and an unbiased model's ``ti+`` / ``tj-``.

The writer waits with ROADMAP A.2.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .objective import get_objective


def is_reference_model(obj: Dict[str, Any]) -> bool:
    """True when a model dict follows the reference schema (booster payload
    nested under ``gradient_booster.model`` / dart's ``gbtree``)."""
    gb = obj.get("learner", {}).get("gradient_booster", {})
    return isinstance(gb, dict) and ("model" in gb or "gbtree" in gb)


def _convert_tree(t: Dict[str, Any]) -> Dict[str, Any]:
    """Reference per-tree arrays -> native tree JSON dict."""
    left = np.asarray(t["left_children"], np.int32)
    n = len(left)
    is_leaf = left < 0
    conds = np.asarray([float(c) for c in t["split_conditions"]], np.float64)
    # reference: x < cond -> left; ours: x <= value -> left
    adj = np.where(is_leaf, conds,
                   np.nextafter(conds.astype(np.float32), np.float32("-inf")))
    # a nudged threshold from cond <= 0 that lands in the subnormal range
    # is clamped to the largest normal float below zero, as the JAX
    # package does (XLA flushes f32 subnormals to zero), so both packages
    # route every input alike
    tiny = np.float32(np.finfo(np.float32).tiny)
    subnormal_neg = (~is_leaf) & (conds <= 0) \
        & (adj.astype(np.float32) >= -tiny)
    adj = np.where(subnormal_neg, np.float64(-tiny), adj)
    split_type = [int(x) for x in t.get("split_type", [0] * n)]

    cats: Dict[str, List[int]] = {}
    cat_nodes = [int(x) for x in t.get("categories_nodes", [])]
    if cat_nodes:
        segments = [int(x) for x in t.get("categories_segments", [])]
        sizes = [int(x) for x in t.get("categories_sizes", [])]
        members = [int(x) for x in t.get("categories", [])]
        n_cats = max(members, default=0) + 1
        for node, seg, size in zip(cat_nodes, segments, sizes):
            right_set = set(members[seg:seg + size])
            cats[str(node)] = [c for c in range(n_cats)
                               if c not in right_set]
    return {
        "left_children": left.tolist(),
        "right_children": [int(x) for x in t["right_children"]],
        "split_indices": [int(x) for x in t["split_indices"]],
        "split_conditions": adj.tolist(),
        "default_left": [int(x) for x in t["default_left"]],
        "loss_changes": [float(x) for x in t.get("loss_changes", [0] * n)],
        "sum_hessian": [float(x) for x in t.get("sum_hessian", [0] * n)],
        "base_weights": [float(x) for x in t.get("base_weights", [0] * n)],
        "split_type": split_type,
        "categories": cats,
    }


# a ranking objective's position-bias vectors: the reference's keys and the
# native ones
_BIAS_KEYS = (("ti+", "ti_plus"), ("tj-", "tj_minus"),
              ("ti_plus", "ti_plus"), ("tj_minus", "tj_minus"))


def _flatten_objective(objective: Dict[str, Any]) -> Dict[str, Any]:
    """Reference nests objective params one level (e.g. ``reg_loss_param``;
    a ranking objective's ``lambdarank_param``, which the JAX writer also
    emits as ``lambda_rank_param``); an unbiased ranking objective keeps
    ti+ / tj- beside them."""
    out: Dict[str, Any] = {}
    for v in objective.values():
        if isinstance(v, dict):
            out.update(v)
    for src, dst in _BIAS_KEYS:
        if src in objective:
            out[dst] = [float(x) for x in objective[src]]
    return out


def _gbtree_payload(gb: Dict[str, Any]) -> Dict[str, Any]:
    model = gb["model"]
    for ref in model["trees"]:
        if int(ref.get("tree_param", {}).get("size_leaf_vector", 1) or 1) > 1:
            raise NotImplementedError(
                "vector-leaf (multi_output_tree) reference models are not "
                "in the PyTorch port yet")
    trees = [_convert_tree(ref) for ref in model["trees"]]
    mp = model.get("gbtree_model_param", {})
    n_trees = len(trees)
    indptr = [int(x) for x in model.get("iteration_indptr", [])]
    if not indptr:
        per_iter = max(1, int(mp.get("num_parallel_tree", 1) or 1))
        indptr = list(range(0, n_trees + 1, per_iter)) or [0, n_trees]
    return {
        "name": "gbtree",
        "num_parallel_tree": int(mp.get("num_parallel_tree", 1) or 1),
        "multi_strategy": "one_output_per_tree",
        "trees": trees,
        "tree_info": [int(x) for x in model.get("tree_info", [0] * n_trees)],
        "iteration_indptr": indptr,
    }


def reference_to_native_json(ref: Dict[str, Any]) -> Dict[str, Any]:
    """Reference model dict -> native model dict (Booster JSON schema)."""
    learner = ref["learner"]
    gb = learner["gradient_booster"]
    name = gb.get("name", "gbtree")
    if name not in ("gbtree", "dart"):
        raise NotImplementedError(
            f"reference booster {name!r} is not in the PyTorch port yet "
            "(gbtree and dart only; ROADMAP A.5.9)")

    objective = learner.get("objective", {})
    obj_name = objective.get("name", "reg:squarederror")
    obj_params = _flatten_objective(objective)
    lmp = learner.get("learner_model_param", {})
    num_class = int(lmp.get("num_class", 0) or 0)
    num_target = int(lmp.get("num_target", 1) or 1)
    if num_class:
        obj_params["num_class"] = num_class
    obj = get_objective(obj_name, dict(obj_params))
    base_user = float(lmp.get("base_score", 0.5) or 0.5)
    n_groups = max(num_class, num_target, 1)
    margin = np.asarray(
        obj.prob_to_margin(np.full((1,), base_user, np.float64))
    ).reshape(-1)
    base = np.broadcast_to(margin.astype(np.float32), (n_groups,)) \
        if margin.size == 1 else margin.astype(np.float32)
    if name == "dart":
        booster = _gbtree_payload(gb["gbtree"])
        booster["name"] = "dart"
        booster["weight_drop"] = [float(w) for w in gb["weight_drop"]]
    else:
        booster = _gbtree_payload(gb)

    return {
        "version": [int(v) for v in ref.get("version", [2, 0, 0])],
        "learner": {
            "attributes": dict(learner.get("attributes", {})),
            "feature_names": list(learner.get("feature_names", [])),
            "feature_types": list(learner.get("feature_types", [])),
            "learner_model_param": {
                "base_score": base.tolist(),
                "num_class": num_class,
                "num_target": n_groups,
                "num_feature": int(lmp.get("num_feature", 0) or 0),
            },
            "objective": {"name": obj_name, **obj_params},
            "gradient_booster": booster,
        },
        "config": {"learner_params": {"objective": obj_name,
                                      "booster": booster["name"]}},
    }
