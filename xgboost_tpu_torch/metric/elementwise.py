"""Elementwise metrics on the host in float64 (reference
``src/metric/elementwise_metric.cu``; the JAX package's
``metric/elementwise.py`` ``rmse`` and ``logloss``)."""

from __future__ import annotations

import numpy as np

from .base import Metric, register


class _WeightedMean(Metric):
    def per_row(self, preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def finalize(self, mean: float) -> float:
        return mean

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels, dtype=np.float64).reshape(-1)
        p = np.asarray(preds, dtype=np.float64).reshape(y.shape)
        w = self.weights_of(info, len(y))
        loss = self.per_row(p, y)
        den = float(np.sum(w))
        mean = float(np.sum(loss * w)) / den if den != 0 else float("nan")
        return float(self.finalize(mean))


@register("rmse")
class RMSE(_WeightedMean):
    name = "rmse"

    def per_row(self, p, y):
        return np.square(p - y)

    def finalize(self, mean):
        return np.sqrt(mean)


@register("logloss")
class LogLoss(_WeightedMean):
    name = "logloss"

    def per_row(self, p, y):
        eps = 1e-16
        p = np.clip(p, eps, 1.0 - eps)
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))
