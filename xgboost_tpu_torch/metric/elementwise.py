"""Elementwise metrics on the host in float64 (reference
``src/metric/elementwise_metric.cu``; the JAX package's
``metric/elementwise.py``): weighted means of a per-row loss, and
``error@t``, the weighted share of rows with ``pred > t`` (t = 0.5 by
default) other than ``label > 0.5``. With a label matrix [n, K] the
rows are weighted and the targets averaged: a row's weight stands for
each of its K entries (:func:`_weights`)."""

from __future__ import annotations

import numpy as np

from .base import Metric, global_mean, register


def _labels_preds(preds, info):
    """(labels [n] or [n, K], predictions of the same shape), float64."""
    y = np.asarray(info.labels, dtype=np.float64)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    return y, np.asarray(preds, dtype=np.float64).reshape(y.shape)


def _weights(metric, info, y: np.ndarray) -> np.ndarray:
    """One weight an entry of ``y``: a row's weight over its targets."""
    w = metric.weights_of(info, len(y))
    return np.broadcast_to(w[:, None], y.shape) if y.ndim == 2 else w


class _WeightedMean(Metric):
    def per_row(self, preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def finalize(self, mean: float) -> float:
        return mean

    def __call__(self, preds, info) -> float:
        y, p = _labels_preds(preds, info)
        w = _weights(self, info, y)
        return float(self.finalize(
            global_mean(np.sum(self.per_row(p, y) * w), np.sum(w), info)))


@register("rmse")
class RMSE(_WeightedMean):
    name = "rmse"

    def per_row(self, p, y):
        return np.square(p - y)

    def finalize(self, mean):
        return np.sqrt(mean)


@register("rmsle")
class RMSLE(_WeightedMean):
    name = "rmsle"

    def per_row(self, p, y):
        return np.square(np.log1p(p) - np.log1p(y))

    def finalize(self, mean):
        return np.sqrt(mean)


@register("mae")
class MAE(_WeightedMean):
    name = "mae"

    def per_row(self, p, y):
        return np.abs(p - y)


@register("mape")
class MAPE(_WeightedMean):
    name = "mape"

    def per_row(self, p, y):
        return np.abs((y - p) / np.maximum(np.abs(y), 1e-16))


@register("mphe")
class MPHE(_WeightedMean):
    name = "mphe"

    def per_row(self, p, y):
        return np.sqrt(1.0 + np.square(p - y)) - 1.0


@register("logloss")
class LogLoss(_WeightedMean):
    name = "logloss"

    def per_row(self, p, y):
        eps = 1e-16
        p = np.clip(p, eps, 1.0 - eps)
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


@register("error")
class BinaryError(Metric):
    name = "error"

    def __call__(self, preds, info) -> float:
        t = float(self.param) if self.param is not None else 0.5
        y, p = _labels_preds(preds, info)
        w = _weights(self, info, y)
        wrong = (p > t).astype(np.float64) != (y > 0.5)
        return float(global_mean(np.sum(wrong * w), np.sum(w), info))


@register("poisson-nloglik")
class PoissonNLL(_WeightedMean):
    name = "poisson-nloglik"

    def per_row(self, p, y):
        from scipy.special import gammaln

        p = np.maximum(p, 1e-16)
        return p - y * np.log(p) + gammaln(y + 1.0)


def _gamma_c(y: np.ndarray, psi: float) -> np.ndarray:
    from scipy.special import gammaln

    return (psi - 1.0) / psi * np.log(np.maximum(y, 1e-16)) \
        - np.log(psi) / psi - gammaln(1.0 / psi)


@register("gamma-nloglik")
class GammaNLL(_WeightedMean):
    name = "gamma-nloglik"

    def per_row(self, p, y):
        psi = 1.0
        theta = -1.0 / np.maximum(p, 1e-16)
        return -((y * theta + np.log(-theta)) / psi + _gamma_c(y, psi))


@register("gamma-deviance")
class GammaDeviance(_WeightedMean):
    name = "gamma-deviance"

    def per_row(self, p, y):
        eps = 1e-16
        r = y / np.maximum(p, eps)
        return 2.0 * (np.maximum(r, eps) - np.log(np.maximum(r, eps)) - 1.0)


@register("tweedie-nloglik")
class TweedieNLL(Metric):
    name = "tweedie-nloglik"

    def __call__(self, preds, info) -> float:
        rho = float(self.param) if self.param is not None else 1.5
        y, p = _labels_preds(preds, info)
        p = np.maximum(p, 1e-16)
        w = _weights(self, info, y)
        loss = (-y * np.power(p, 1.0 - rho) / (1.0 - rho)
                + np.power(p, 2.0 - rho) / (2.0 - rho))
        return float(global_mean(np.sum(loss * w), np.sum(w), info))
