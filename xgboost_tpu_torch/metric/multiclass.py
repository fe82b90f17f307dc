"""Multiclass metrics on the host in float64 (the JAX package's
``metric/multiclass.py``; reference ``src/metric/multiclass_metric.cu``):
``merror``, the weighted share of rows whose argmax class (or predicted
class id) is not the label, and ``mlogloss``, the weighted mean of
``-log(max(p_label, 1e-16))``."""

from __future__ import annotations

import numpy as np

from .base import Metric, register


def _ratio(num: float, den: float) -> float:
    return float(num) / float(den) if den != 0 else float("nan")


@register("merror")
class MultiError(Metric):
    name = "merror"

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels).reshape(-1).astype(np.int64)
        p = np.asarray(preds)
        cls = p.argmax(axis=1) if p.ndim == 2 else p.astype(np.int64)
        w = self.weights_of(info, len(y))
        return _ratio(np.sum((cls != y) * w), np.sum(w))


@register("mlogloss")
class MultiLogLoss(Metric):
    name = "mlogloss"

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels).reshape(-1).astype(np.int64)
        p = np.asarray(preds, dtype=np.float64)
        picked = np.clip(p[np.arange(len(y)), y], 1e-16, 1.0)
        w = self.weights_of(info, len(y))
        return _ratio(np.sum(-np.log(picked) * w), np.sum(w))
