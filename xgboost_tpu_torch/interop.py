"""Reference-format model reader and writer.

Loads models in the reference XGBoost JSON/UBJSON schema by converting
them to the native model dict that ``Booster`` reads, and writes a
``gbtree``, ``dart`` or ``gblinear`` Booster in that schema
(:func:`native_to_reference_json`, :func:`save_xgboost_model`) to the
JAX package's bytes. Semantics bridged (the same as the JAX package's
``interop.py``):

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
- Objective parameter blocks: ``reg_loss_param``,
  ``poisson_regression_param``, ``tweedie_regression_param``,
  ``quantile_loss_param`` (the alpha list as its string),
  ``aft_loss_param``, ``softmax_multiclass_param``, and ranking's
  ``lambdarank_param`` (or ``lambda_rank_param``) with an unbiased
  model's ``ti+`` / ``tj-``; the reader flattens each block into the
  objective's parameters.
- Vector-leaf trees (``size_leaf_vector`` K > 1): thresholds in
  ``split_conditions`` on every node and the node weights flat [n * K]
  in ``base_weights``; the schema's scalar ``base_score`` keeps target
  0's intercept, with a warning where the targets' differ.

- gblinear: the weights flat [(num_feature + 1) x num_group], the bias
  row last (reference ``src/gbm/gblinear_model.h``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch

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


def _convert_tree_multi(t: Dict[str, Any], n_targets: int
                        ) -> Dict[str, Any]:
    """A reference vector-leaf tree (``MultiTargetTree::SaveModel``:
    thresholds in ``split_conditions`` on every node, node weights flat
    [n_nodes * K] in ``base_weights``) -> the native
    ``MultiTargetTreeModel`` JSON."""
    out = _convert_tree(t)
    n = len(out["left_children"])
    bw = np.asarray([float(x) for x in t["base_weights"]],
                    np.float64).reshape(n, n_targets)
    out["n_targets"] = n_targets
    out["base_weights"] = bw.tolist()
    out["leaf_values"] = bw.tolist()  # a leaf's row is its node weight
    return out


def _gbtree_payload(gb: Dict[str, Any]) -> Dict[str, Any]:
    model = gb["model"]
    trees = []
    for ref in model["trees"]:
        slv = int(ref.get("tree_param", {}).get("size_leaf_vector", 1) or 1)
        trees.append(_convert_tree_multi(ref, slv) if slv > 1
                     else _convert_tree(ref))
    mp = model.get("gbtree_model_param", {})
    n_trees = len(trees)
    indptr = [int(x) for x in model.get("iteration_indptr", [])]
    if not indptr:
        per_iter = max(1, int(mp.get("num_parallel_tree", 1) or 1))
        indptr = list(range(0, n_trees + 1, per_iter)) or [0, n_trees]
    return {
        "name": "gbtree",
        "num_parallel_tree": int(mp.get("num_parallel_tree", 1) or 1),
        "multi_strategy": ("multi_output_tree"
                           if any("n_targets" in t for t in trees)
                           else "one_output_per_tree"),
        "trees": trees,
        "tree_info": [int(x) for x in model.get("tree_info", [0] * n_trees)],
        "iteration_indptr": indptr,
    }


def reference_to_native_json(ref: Dict[str, Any]) -> Dict[str, Any]:
    """Reference model dict -> native model dict (Booster JSON schema)."""
    learner = ref["learner"]
    gb = learner["gradient_booster"]
    name = gb.get("name", "gbtree")
    if name not in ("gbtree", "dart", "gblinear"):
        raise ValueError(f"unknown reference booster: {name}")

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
    elif name == "gblinear":
        W = np.asarray([float(w) for w in gb["model"]["weights"]],
                       np.float32).reshape(-1, n_groups)
        booster = {"name": "gblinear", "updater": "shotgun",
                   "weights": W[:-1].tolist(), "bias": W[-1].tolist(),
                   "rounds": 0}
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


# --------------------------------------------------------------------- writer

_REG_LOSS_OBJS = {"reg:squarederror", "reg:squaredlogerror", "reg:linear",
                  "reg:logistic", "binary:logistic", "binary:logitraw",
                  "reg:pseudohubererror"}


def _objective_to_reference(obj, learner_params: Dict[str, Any],
                            num_class: int) -> Dict[str, Any]:
    """The objective's name and its parameter block, every value a
    string, as the reference schema has it."""
    name = obj.name
    own = obj.to_json()

    def s(key: str, default: Any) -> str:
        return str(own.get(key, learner_params.get(key, default)))

    if name in _REG_LOSS_OBJS:
        return {"name": name, "reg_loss_param": {
            "scale_pos_weight": s("scale_pos_weight", 1)}}
    if name == "count:poisson":
        return {"name": name, "poisson_regression_param": {
            "max_delta_step": s("max_delta_step", 0.7)}}
    if name == "reg:tweedie":
        return {"name": name, "tweedie_regression_param": {
            "tweedie_variance_power": s("tweedie_variance_power", 1.5)}}
    if name == "reg:quantileerror":
        return {"name": name, "quantile_loss_param": {
            "quantile_alpha": s("quantile_alpha", 0.5)}}
    if name in ("multi:softprob", "multi:softmax"):
        return {"name": name, "softmax_multiclass_param": {
            "num_class": str(num_class)}}
    if name in ("rank:ndcg", "rank:pairwise", "rank:map"):
        lr = {"lambdarank_num_pair_per_sample":
              s("lambdarank_num_pair_per_sample", 1),
              "lambdarank_pair_method": s("lambdarank_pair_method", "mean")}
        # the published schema names the block "lambda_rank_param" and
        # requires "lambdarank_param": both are written
        return {"name": name, "lambda_rank_param": lr,
                "lambdarank_param": lr}
    if name == "survival:aft":
        return {"name": name, "aft_loss_param": {
            "aft_loss_distribution": s("aft_loss_distribution", "normal"),
            "aft_loss_distribution_scale":
                s("aft_loss_distribution_scale", 1.0)}}
    return {"name": name}


def _tree_to_reference(t, num_feature: int) -> Dict[str, Any]:
    """A native tree as reference arrays: thresholds nudged up one f32
    ulp (``x <= v`` becomes ``x < cond``), leaves in ``split_conditions``,
    each categorical node's RIGHT set."""
    n = t.num_nodes()
    conds = np.where(
        t.is_leaf, t.leaf_value.astype(np.float64),
        np.nextafter(t.split_value.astype(np.float32), np.float32("inf"))
        .astype(np.float64))
    cat_nodes = [int(c) for c in np.nonzero(t.is_cat_split)[0]]
    categories: List[int] = []
    segments: List[int] = []
    sizes: List[int] = []
    n_cats = t.cat_words.shape[1] * 32
    for c in cat_nodes:
        w = t.cat_words[c]
        left = {b for b in range(n_cats) if (w[b // 32] >> (b % 32)) & 1}
        right = sorted(set(range(n_cats)) - left)
        segments.append(len(categories))
        sizes.append(len(right))
        categories.extend(right)
    return {
        "tree_param": {"num_nodes": str(n), "num_feature": str(num_feature),
                       "size_leaf_vector": "1", "num_deleted": "0"},
        "id": 0,
        "left_children": t.left_child.tolist(),
        "right_children": t.right_child.tolist(),
        "parents": [int(p) if p >= 0 else 2147483647 for p in t.parent],
        "split_indices": [int(max(f, 0)) for f in t.split_feature],
        "split_conditions": conds.tolist(),
        "split_type": [int(x) for x in t.is_cat_split],
        "default_left": [int(d) for d in t.default_left],
        "loss_changes": t.gain.astype(np.float64).tolist(),
        "sum_hessian": t.sum_hess.astype(np.float64).tolist(),
        "base_weights": t.base_weight.astype(np.float64).tolist(),
        "categories": categories,
        "categories_nodes": cat_nodes,
        "categories_segments": segments,
        "categories_sizes": sizes,
    }


def _multi_tree_to_reference(t, num_feature: int) -> Dict[str, Any]:
    """A ``MultiTargetTreeModel`` as reference arrays
    (``MultiTargetTree::SaveModel``): thresholds for every node in
    ``split_conditions``, node weights flat [n * K] in ``base_weights``,
    and the stats arrays the published schema requires."""
    n = t.num_nodes()
    conds = np.where(
        t.is_leaf, 0.0,
        np.nextafter(t.split_value.astype(np.float32), np.float32("inf"))
        .astype(np.float64))
    bw = np.where(t.is_leaf[:, None], t.leaf_value,
                  t.base_weight).astype(np.float64)
    return {
        "tree_param": {"num_nodes": str(n), "num_feature": str(num_feature),
                       "size_leaf_vector": str(t.n_targets),
                       "num_deleted": "0"},
        "id": 0,
        "left_children": t.left_child.tolist(),
        "right_children": t.right_child.tolist(),
        "parents": [int(p) if p >= 0 else 2147483647 for p in t.parent],
        "split_indices": [int(max(f, 0)) for f in t.split_feature],
        "split_conditions": conds.tolist(),
        "split_type": [0] * n,
        "default_left": [int(d) for d in t.default_left],
        "base_weights": bw.reshape(-1).tolist(),
        "loss_changes": t.gain.astype(np.float64).tolist(),
        "sum_hessian": t.sum_hess.astype(np.float64).tolist(),
        "categories": [],
        "categories_nodes": [],
        "categories_segments": [],
        "categories_sizes": [],
    }


def _linear_to_reference(gbm, nf: int, n_groups: int) -> Dict[str, Any]:
    """The gblinear payload: weights flat [(F + 1) x K], bias row last."""
    W = gbm.W.cpu().numpy() if gbm.W is not None \
        else np.zeros((nf, n_groups), np.float32)
    b = gbm.bias.cpu().numpy() if gbm.bias is not None \
        else np.zeros((n_groups,), np.float32)
    flat = np.concatenate([W, b[None, :]], axis=0).reshape(-1)
    return {"name": "gblinear",
            "model": {"weights": flat.astype(np.float64).tolist()}}


def _trees_to_reference(gbm, nf: int) -> Dict[str, Any]:
    """The gbtree (or dart) payload."""
    from .boosting.dart import Dart
    from .tree.multi import MultiTargetTreeModel

    trees = []
    for i, t in enumerate(gbm.trees):
        tj = (_multi_tree_to_reference(t, nf)
              if isinstance(t, MultiTargetTreeModel)
              else _tree_to_reference(t, nf))
        tj["id"] = i
        trees.append(tj)
    model = {
        "gbtree_model_param": {
            "num_trees": str(len(trees)),
            "num_parallel_tree": str(gbm.num_parallel_tree)},
        "trees": trees,
        "tree_info": [int(x) for x in gbm.tree_info],
        "iteration_indptr": [int(x) for x in gbm.iteration_indptr],
    }
    if isinstance(gbm, Dart):
        return {"name": "dart", "gbtree": {"name": "gbtree", "model": model},
                "weight_drop": [float(w) for w in gbm.weight_drop]}
    return {"name": "gbtree", "model": model}


def native_to_reference_json(booster) -> Dict[str, Any]:
    """A ``gbtree``, ``dart`` or ``gblinear`` Booster as a
    reference-schema model dict; ``base_score`` in the user's space (the
    transform of the base margin), of target 0 when the targets' base
    margins differ."""
    from .boosting.gblinear import GBLinear

    booster._configure(None)
    gbm, obj = booster.gbm, booster.obj
    nf = booster.num_features()
    gb_json = (_linear_to_reference(gbm, nf, booster.n_groups)
               if isinstance(gbm, GBLinear) else _trees_to_reference(gbm, nf))
    margin = booster._base_np()
    user = obj.pred_transform(torch.from_numpy(
        np.asarray(margin, np.float32))[None, :]).numpy().reshape(-1)
    if booster.n_groups > 1 and not np.allclose(margin, margin[0]):
        import warnings

        warnings.warn(
            "exporting a model with per-target base scores to the "
            "reference schema keeps only target 0's value; set an explicit "
            "scalar base_score for exact round-trips", stacklevel=2)
    num_class = int(booster.learner_params.get("num_class", 0))
    return {
        "version": [2, 0, 0],
        "learner": {
            "attributes": dict(booster.attributes_),
            "feature_names": booster.feature_names or [],
            "feature_types": booster.feature_types or [],
            "learner_model_param": {
                "base_score": f"{float(user[0]):.17g}",
                "boost_from_average": "1",
                "num_class": str(num_class),
                "num_feature": str(nf),
                "num_target": str(booster.n_groups),
            },
            "objective": _objective_to_reference(
                obj, booster.learner_params, num_class),
            "gradient_booster": gb_json,
        },
    }


def load_xgboost_model(source, device: str = "cuda"):
    """A Booster on ``device`` from a reference-format model (a path,
    bytes or a native model)."""
    from .core import Booster

    return Booster({"device": device}, model_file=source)


def save_xgboost_model(booster, fname: str) -> None:
    """Write ``booster`` as a reference-schema model file: UBJSON when
    ``fname`` ends in ``.ubj``, else JSON."""
    from .utils.ubjson import dump_ubjson

    obj = native_to_reference_json(booster)
    if str(fname).endswith(".ubj"):
        with open(fname, "wb") as fh:
            dump_ubjson(obj, fh)
    else:
        with open(fname, "w") as fh:
            json.dump(obj, fh)
