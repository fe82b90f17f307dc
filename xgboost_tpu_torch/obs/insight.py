"""Learning-health telemetry, the in-carry eval and the model report
(the port of the JAX package's ``obs/insight.py``).

- **Round telemetry**: a round's scalars (the best gain of each level,
  leaf and split counts, realized depth, leaf-value statistics, the
  gradient's and hessian's norms, the NaN guard's count). Where the
  round is the JAX package's fused round program (``core.py
  Booster._batchable``), :func:`grown_telemetry` computes them as torch
  ops on the card from the depthwise grower's heap arrays and the round's
  gradient, and ``core.py`` fetches them with the eval partials in ONE
  host copy a round; every other tier (lossguide, paged, mesh, vector
  leaves, dart) derives them on the host from the trees the round
  committed (:func:`round_telemetry_host`), as the JAX package's
  non-fused tiers do. Either way the round itself is not touched: the
  model bytes are the same armed or not.
- **In-carry eval**: with ``XTPU_INSIGHT_EVAL=1`` each eval set's margin
  moves by a binned heap walk of the round's new tree over its bins
  against the training cuts (:func:`walk_leaf_delta`), and the metrics'
  partial sums (:func:`metric_partial`) ride the same fetch, so
  ``Booster.eval_set`` serves the round's scores without a predict.
- **Model report and diff**: :func:`model_inspect` (every importance
  type, tree-shape histograms) and :func:`model_diff` (prediction drift
  attributed to features), behind ``Booster.inspect()``, the pipeline's
  manifest and rejection reports and the front end's
  ``GET /v1/model/<name>/report``.

Everything lands in a :class:`TrainingLog`: the ``evals_result`` mapping
the callbacks consume, with a ``.records`` list of the rounds'
telemetry, streamed into the metrics registry (``xtpu_insight_*`` /
``xtpu_eval_*`` gauges) and the trace ring (``insight/round``
instants). Disarmed, each producer costs one module test.

Knobs (read at import; :func:`enable` / :func:`disable` switch at run
time):

- ``XTPU_INSIGHT``: ``1`` arms the round telemetry.
- ``XTPU_INSIGHT_EVAL``: ``1`` arms the in-carry eval too.
"""

from __future__ import annotations

import collections
import functools
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["enable", "disable", "enabled", "eval_enabled", "TrainingLog",
           "SUPPORTED_EVAL_METRICS", "metric_specs", "metric_partial",
           "finalize_partial", "grown_telemetry", "stack_grown",
           "fetch_round", "walk_leaf_delta", "round_telemetry_host",
           "model_inspect", "model_diff"]


# ------------------------------------------------------------- arming state

_ON = False
_EVAL = False


def enable(eval: Optional[bool] = None) -> None:
    """Arm insight telemetry; ``eval=True`` also arms the in-carry eval."""
    global _ON, _EVAL
    _ON = True
    if eval is not None:
        _EVAL = bool(eval)


def disable() -> None:
    global _ON, _EVAL
    _ON = False
    _EVAL = False


def enabled() -> bool:
    return _ON


def eval_enabled() -> bool:
    return _ON and _EVAL


# -------------------------------------------------------------- TrainingLog

class TrainingLog(collections.OrderedDict):
    """``evals_result``-shaped mapping {data: {metric: [scores]}} plus a
    ``.records`` list of per-round telemetry dicts. The callback
    container's ``history`` IS a TrainingLog, so ``EarlyStopping`` /
    ``evals_result`` consume it through the plain dict API while insight
    producers append structured rounds — one log, two views. Snapshots
    persist it via :meth:`to_obj` so patience windows and telemetry
    survive checkpoint resume."""

    def __init__(self, records: Optional[List[Dict[str, Any]]] = None
                 ) -> None:
        super().__init__()
        self.records: List[Dict[str, Any]] = list(records or [])

    # -- producers ---------------------------------------------------------
    def log_round(self, round_: int, scalars: Dict[str, Any]) -> None:
        """Append one round's telemetry; streams gauges + a trace instant
        only while insight is armed."""
        rec: Dict[str, Any] = {"round": int(round_)}
        for k, v in scalars.items():
            if np.ndim(v) == 0:
                rec[k] = float(v)
            else:
                rec[k] = [float(x) for x in np.asarray(v).reshape(-1)]
        self.records.append(rec)
        if _ON:
            from .metrics import get_registry
            from . import trace

            reg = get_registry()
            for k, v in rec.items():
                if k != "round" and np.ndim(v) == 0:
                    reg.set_gauge(f"xtpu_insight_{k}", float(v),
                                  help="per-round training telemetry "
                                       "(xtpuinsight)")
            reg.set_gauge("xtpu_insight_round", float(rec["round"]),
                          help="last telemetered boosting round")
            trace.instant("insight/round", cat="insight", args=rec)

    def log_eval(self, data_name: str, metric_name: str,
                 value: float) -> None:
        """Append one eval score (the ``evals_result`` write path)."""
        self.setdefault(data_name, collections.OrderedDict()).setdefault(
            metric_name, []).append(float(value))
        if _ON:
            from .metrics import get_registry

            get_registry().set_gauge(
                "xtpu_eval_score", float(value),
                labels=(("data", data_name), ("metric", metric_name)),
                help="latest eval-set metric score (xtpuinsight)")

    # -- persistence -------------------------------------------------------
    def to_obj(self) -> Dict[str, Any]:
        return {"history": {d: {m: list(v) for m, v in metrics.items()}
                            for d, metrics in self.items()},
                "records": [dict(r) for r in self.records]}

    @classmethod
    def from_obj(cls, obj: Optional[Dict[str, Any]]) -> "TrainingLog":
        log = cls(records=(obj or {}).get("records"))
        for d, metrics in ((obj or {}).get("history") or {}).items():
            for m, vals in metrics.items():
                log.setdefault(d, collections.OrderedDict())[m] = \
                    [float(v) for v in vals]
        return log


# ------------------------------------------------ fused-tier telemetry
#
# Torch ops on the heap arrays the depthwise grower left on the card: the
# scalars stay there until core.py fetches them with the eval partials.

@functools.lru_cache(maxsize=16)
def _heap_depths(max_nodes: int, device):
    """Node i of a heap lives at depth floor(log2(i + 1)) (made once a
    heap size and device)."""
    import torch

    return torch.from_numpy(np.floor(np.log2(np.arange(max_nodes) + 1))
                            .astype(np.int64)).to(device)


def grown_telemetry(grown, gpair, levels: int) -> Dict[str, Any]:
    """The round's learning-health scalars from its grown trees (one
    ``GrownTree`` heap, or a dict of the K class trees' arrays stacked on
    a leading axis) and its gradient pairs [n, K, 2]: 0-d tensors and the
    best gain of each of ``levels`` levels, all on the trees' device."""
    import torch

    if isinstance(grown, dict):
        arrs = grown
    else:
        arrs = {"is_leaf": grown.is_leaf, "active": grown.active,
                "gain": grown.gain, "leaf_value": grown.leaf_value}
    active = arrs["active"]
    leaf = arrs["is_leaf"] & active
    split = active & ~arrs["is_leaf"]
    gain = arrs["gain"].float()
    lv = arrs["leaf_value"].float()
    depths = _heap_depths(active.shape[-1], active.device)
    zero = torch.zeros_like(gain)

    leaf_count = leaf.sum()
    split_count = split.sum()
    depth = torch.where(leaf, depths, torch.zeros_like(depths)).max()
    split_gain = torch.where(split, gain, zero)
    gain_total = split_gain.sum()
    n_levels = max(int(levels), 1)
    # each level's best split gain (0 where a level has none); nodes below
    # the last level are leaves, whose 0 changes no maximum
    gain_per_level = gain.new_zeros(n_levels).scatter_reduce(
        0, torch.clamp(depths, max=n_levels - 1).expand_as(gain).reshape(-1),
        split_gain.reshape(-1), reduce="amax")
    leaf_sum = torch.where(leaf, lv, zero).sum()
    inf = torch.full_like(lv, float("inf"))
    g = gpair[..., 0].float()
    h = gpair[..., 1].float()
    return {
        "leaf_count": leaf_count,
        "split_count": split_count,
        "depth": depth,
        "gain_total": gain_total,
        "gain_max": split_gain.max(),
        "gain_mean": gain_total / torch.clamp(split_count, min=1),
        "gain_per_level": gain_per_level,
        "leaf_value_min": torch.where(leaf, lv, inf).min(),
        "leaf_value_max": torch.where(leaf, lv, -inf).max(),
        "leaf_value_mean": leaf_sum / torch.clamp(leaf_count, min=1),
        "grad_norm": torch.sqrt(torch.sum(g * g)),
        "hess_norm": torch.sqrt(torch.sum(h * h)),
    }


def stack_grown(grown: Sequence[Any]) -> Any:
    """One round's class trees (``GrownTree`` heaps) as the stacked dict
    :func:`grown_telemetry` takes; one tree stays as it is."""
    import torch

    if len(grown) == 1:
        return grown[0]
    return {k: torch.stack([getattr(g, k) for g in grown])
            for k in ("is_leaf", "active", "gain", "leaf_value")}


def fetch_round(telem: Dict[str, Any], partials: Sequence[Any] = ()
                ) -> Tuple[Dict[str, Any], List[float]]:
    """ONE device-to-host copy of a round's telemetry and eval partial
    sums -> (the scalars as Python numbers, the partials as floats)."""
    import torch

    keys = list(telem)
    parts = [telem[k].reshape(-1).double() for k in keys]
    parts += [torch.as_tensor(p).reshape(-1).double().to(parts[0].device)
              for p in partials]
    flat = torch.cat(parts).cpu().numpy()
    out: Dict[str, Any] = {}
    i = 0
    for k in keys:
        n = telem[k].numel()
        out[k] = (flat[i:i + n].tolist() if telem[k].dim() else
                  float(flat[i]))
        i += n
    return out, flat[i:].tolist()


# ------------------------------------------------------- in-carry eval walk

def walk_leaf_delta(grown, ebins, missing_bin: int, max_depth: int):
    """Each eval row's leaf value in ``grown`` (a ``GrownTree`` heap) over
    its bins ``ebins`` [n, F] against the training cuts, whose bin ids the
    tree's ``split_bin`` thresholds index. Routing is the grower's
    (``ops/partition.py``): a bin above the threshold goes right, a code
    outside a categorical split's left set goes right, the missing bin
    follows ``default_left``."""
    import torch

    from ..ops.partition import cat_goes_right, gather_bins

    n = ebins.shape[0]
    rows = torch.arange(n, device=ebins.device)
    pos = torch.zeros(n, dtype=torch.int64, device=ebins.device)
    cat = grown.is_cat_split is not None
    for _ in range(max(int(max_depth), 1)):
        leaf = grown.is_leaf[pos]
        b = gather_bins(ebins, rows, torch.clamp(grown.split_feature[pos],
                                                 min=0))
        go_right = b > grown.split_bin[pos]
        if cat:
            go_right = torch.where(grown.is_cat_split[pos],
                                   cat_goes_right(b, grown.cat_words, pos),
                                   go_right)
        go_right = torch.where(b == missing_bin, ~grown.default_left[pos],
                               go_right)
        pos = torch.where(leaf, pos, 2 * pos + 1 + go_right.long())
    return grown.leaf_value[pos]


# ------------------------------------------------------ in-carry metrics
#
# Torch twins of the weighted-mean formulas of metric/elementwise.py, in
# float64 as the host metrics reduce. Each gives (numerator, denominator);
# finalize_partial takes the ratio through metric.base.global_mean, so the
# communicator's semantics are the host metrics'.

SUPPORTED_EVAL_METRICS = ("rmse", "mae", "logloss", "error")


def metric_specs(metrics: Sequence[Any]
                 ) -> Optional[Tuple[Tuple[str, float], ...]]:
    """Static (name, param) spec tuple for a Metric list, or None when
    any metric has no in-carry twin (callers then keep the host path)."""
    specs: List[Tuple[str, float]] = []
    for m in metrics:
        name = getattr(m, "name", None)
        if name not in SUPPORTED_EVAL_METRICS:
            return None
        if name == "error":
            try:
                t = float(m.param) if m.param is not None else 0.5
            except (TypeError, ValueError):
                return None
            specs.append((name, t))
        else:
            if m.param is not None:
                return None
            specs.append((name, 0.0))
    return tuple(specs)


def metric_partial(name: str, p, y, w, t: float):
    """(sum(loss * w), sum(w)) of one supported metric, as 0-d float64
    tensors on the predictions' device."""
    import torch

    p, y, w = p.double(), y.double(), w.double()
    if name == "rmse":
        loss = torch.square(p - y)
    elif name == "mae":
        loss = torch.abs(p - y)
    elif name == "logloss":
        eps = 1e-16
        pc = torch.clamp(p, eps, 1.0 - eps)
        loss = -(y * torch.log(pc) + (1.0 - y) * torch.log(1.0 - pc))
    elif name == "error":
        loss = ((p > t) != (y > 0.5)).double()
    else:  # pragma: no cover - guarded by metric_specs
        raise ValueError(f"no in-carry twin for metric {name!r}")
    return torch.sum(loss * w), torch.sum(w)


def finalize_partial(name: str, num: float, den: float, info) -> float:
    """Host finalizer: communicator-aware ratio + the metric's finalize."""
    from ..metric.base import global_mean

    mean = global_mean(float(num), float(den), info)
    return float(math.sqrt(mean)) if name == "rmse" else float(mean)


# --------------------------------------- host telemetry (non-fused tiers)

def round_telemetry_host(trees: Sequence[Any]) -> Optional[Dict[str, Any]]:
    """The host tiers' twin of :func:`grown_telemetry` (lossguide, paged,
    mesh, vector leaves, dart): the round's scalars from the trees it
    committed (``tree/tree.py TreeModel``, whose node arrays are on the
    host already), with no device work. ``grad_norm`` / ``hess_norm`` are
    the fused tier's alone. A vector leaf counts as the sum of its
    targets' values, as in the JAX package."""
    leaves = depth = splits = 0
    gain_vals: List[float] = []
    leaf_vals: List[float] = []
    gain_per_level: Dict[int, float] = {}
    saw = False
    for t in trees:
        if not (hasattr(t, "is_leaf") and hasattr(t, "depths")):
            continue
        is_leaf = np.asarray(t.is_leaf, bool)
        depths = np.asarray(t.depths())
        gv = np.asarray(t.gain, np.float64)
        lv = np.asarray(t.leaf_value, np.float64)
        leaves += int(is_leaf.sum())
        splits += int((~is_leaf).sum())
        if is_leaf.any():
            depth = max(depth, int(depths[is_leaf].max()))
            leaf_vals.extend(np.atleast_1d(
                lv[is_leaf].reshape(len(depths[is_leaf]), -1)
                .sum(axis=-1)).tolist())
        if (~is_leaf).any():
            gain_vals.extend(gv[~is_leaf].tolist())
            for d in np.unique(depths[~is_leaf]):
                sel = ~is_leaf & (depths == d)
                gain_per_level[int(d)] = max(
                    gain_per_level.get(int(d), 0.0), float(gv[sel].max()))
        saw = True
    if not saw:
        return None
    n_levels = (max(gain_per_level) + 1) if gain_per_level else 1
    out: Dict[str, Any] = {
        "leaf_count": leaves,
        "split_count": splits,
        "depth": depth,
        "gain_total": float(np.sum(gain_vals)) if gain_vals else 0.0,
        "gain_max": float(np.max(gain_vals)) if gain_vals else 0.0,
        "gain_mean": (float(np.mean(gain_vals)) if gain_vals else 0.0),
        "gain_per_level": [gain_per_level.get(d, 0.0)
                           for d in range(n_levels)],
    }
    if leaf_vals:
        out["leaf_value_min"] = float(np.min(leaf_vals))
        out["leaf_value_max"] = float(np.max(leaf_vals))
        out["leaf_value_mean"] = float(np.mean(leaf_vals))
    return out


# --------------------------------------------------- model inspector / diff

def model_inspect(booster) -> Dict[str, Any]:
    """Structural + importance report of a Booster: every reference
    importance type (``get_score`` semantics), tree-shape histograms and
    per-model totals. JSON-serializable — the pipeline manifest records
    one per epoch and serve renders it on ``/v1/model/<name>/report``."""
    from ..dump import IMPORTANCE_TYPES

    booster._configure(None)
    report: Dict[str, Any] = {
        "num_trees": int(booster.num_boosted_rounds()),
        "num_features": int(booster.num_features()),
        "importance": {t: booster.get_score(importance_type=t)
                       for t in IMPORTANCE_TYPES},
    }
    bi = booster.attr("best_iteration")
    if bi is not None:
        report["best_iteration"] = int(bi)
    trees = getattr(booster.gbm, "trees", None)
    if trees is None:
        return report
    depth_hist: Dict[str, int] = {}
    leaf_hist: Dict[str, int] = {}
    nodes = leaves = 0
    for t in trees:
        d = int(t.max_depth())
        nl = int(t.num_leaves())
        depth_hist[str(d)] = depth_hist.get(str(d), 0) + 1
        leaf_hist[str(nl)] = leaf_hist.get(str(nl), 0) + 1
        nodes += int(t.num_nodes())
        leaves += nl
    report["tree_shape"] = {
        "trees": len(trees),
        "nodes_total": nodes,
        "leaves_total": leaves,
        "depth_hist": dict(sorted(depth_hist.items(),
                                  key=lambda kv: int(kv[0]))),
        "leaf_hist": dict(sorted(leaf_hist.items(),
                                 key=lambda kv: int(kv[0]))),
    }
    return report


def _normalized_importance(booster, kind: str) -> Dict[str, float]:
    imp = booster.get_score(importance_type=kind)
    total = sum(imp.values())
    if total <= 0:
        return {k: 0.0 for k in imp}
    return {k: v / total for k, v in imp.items()}


def model_diff(a, b, dm=None, top: int = 5) -> Dict[str, Any]:
    """Attribute the drift between two models to features (and tree-shape
    deltas). With a probe ``dm``, prediction drift is measured directly
    and attributed per feature via the Saabas contribution delta
    (``approx_contribs`` — the same walk serving uses); without one, the
    attribution falls back to normalized total_gain importance deltas.
    ``b`` is the candidate, ``a`` the baseline."""
    a._configure(None)
    b._configure(None)
    imp_a = _normalized_importance(a, "total_gain")
    imp_b = _normalized_importance(b, "total_gain")
    feats = sorted(set(imp_a) | set(imp_b))
    imp_delta = {f: imp_b.get(f, 0.0) - imp_a.get(f, 0.0) for f in feats}

    report: Dict[str, Any] = {
        "num_trees": [int(a.num_boosted_rounds()),
                      int(b.num_boosted_rounds())],
        "importance_delta": imp_delta,
    }
    contrib_drift: Dict[str, float] = {}
    if dm is not None:
        pa = np.asarray(a.predict(dm), np.float64)
        pb = np.asarray(b.predict(dm), np.float64)
        report["prediction_drift"] = float(np.mean(np.abs(pb - pa)))
        try:
            ca = np.asarray(a.predict(dm, pred_contribs=True,
                                      approx_contribs=True), np.float64)
            cb = np.asarray(b.predict(dm, pred_contribs=True,
                                      approx_contribs=True), np.float64)
            if ca.shape == cb.shape and ca.ndim >= 2:
                per_feat = np.mean(np.abs(cb - ca), axis=0).reshape(-1)
                names = a.feature_names or [f"f{i}" for i in
                                            range(per_feat.shape[0] - 1)]
                for i in range(min(len(names), per_feat.shape[0] - 1)):
                    contrib_drift[names[i]] = float(per_feat[i])
                report["contrib_drift"] = contrib_drift
        except Exception:   # contribs unsupported for this booster kind
            pass

    score_of = contrib_drift if contrib_drift else \
        {f: abs(d) for f, d in imp_delta.items()}
    ranked = sorted(score_of.items(), key=lambda kv: (-kv[1], kv[0]))
    report["top_features"] = [
        {"feature": f, "score": float(s),
         "importance_delta": float(imp_delta.get(f, 0.0))}
        for f, s in ranked[:max(int(top), 1)] if s > 0.0]
    return report


# --------------------------------------------------------- env-knob arming

if os.environ.get("XTPU_INSIGHT", "0") not in ("0", ""):
    enable()
if os.environ.get("XTPU_INSIGHT_EVAL", "0") not in ("0", ""):
    enable(eval=True)
