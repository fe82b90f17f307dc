"""Survival metrics and the pinball loss on the host in float64 (the JAX
package's ``metric/survival_metric.py``; reference
``src/metric/survival_metric.cu``, ``elementwise_metric.cu``):
``aft-nloglik``, ``cox-nloglik``, ``interval-regression-accuracy``
(larger is better) and ``quantile``.

The JAX package's semantics are kept (ROADMAP C pins both against
upstream): ``aft-nloglik`` scores a normal distribution with sigma 1
whatever ``aft_loss_distribution`` and its scale are, and ``quantile``
averages the columns of a multi-alpha prediction and scores that mean
at one alpha (``quantile@alpha``, 0.5 by default).
"""

from __future__ import annotations

import numpy as np

from .base import Metric, global_mean, register

_EPS = 1e-12


def _bounds(info):
    return (np.asarray(info.label_lower_bound, np.float64),
            np.asarray(info.label_upper_bound, np.float64))


@register("aft-nloglik")
class AFTNegLogLik(Metric):
    name = "aft-nloglik"

    def __call__(self, preds, info) -> float:
        from scipy.stats import norm

        # predictions arrive as exp(margin): the margin back
        mu = np.log(np.maximum(np.asarray(preds, np.float64).reshape(-1),
                               _EPS))
        lo, hi = _bounds(info)
        sigma = 1.0
        z_lo = (np.log(np.maximum(lo, _EPS)) - mu) / sigma
        z_hi = np.where(np.isfinite(hi),
                        (np.log(np.maximum(hi, _EPS)) - mu) / sigma, np.inf)
        uncensored = np.isfinite(hi) & (np.abs(hi - lo) < 1e-30)
        L = np.where(
            uncensored,
            norm.pdf(z_lo) / (sigma * np.maximum(lo, _EPS)),
            np.where(np.isfinite(hi), norm.cdf(z_hi), 1.0)
            - np.where(lo > 0, norm.cdf(z_lo), 0.0))
        w = self.weights_of(info, len(mu))
        nll = -np.log(np.maximum(L, _EPS))
        return float(global_mean(np.sum(nll * w), np.sum(w), info))


@register("cox-nloglik")
class CoxNegLogLik(Metric):
    name = "cox-nloglik"

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels, np.float64).reshape(-1)
        m = np.log(np.maximum(np.asarray(preds, np.float64).reshape(-1),
                              _EPS))
        order = np.argsort(np.abs(y), kind="stable")
        ys, ms = y[order], m[order]
        exp_m = np.exp(ms - ms.max())
        S = np.cumsum(exp_m[::-1])[::-1]
        event = ys > 0
        ll = np.sum(np.where(event,
                             (ms - ms.max()) - np.log(np.maximum(S, _EPS)),
                             0.0))
        return float(-ll / max(int(event.sum()), 1))


@register("interval-regression-accuracy")
class IntervalRegressionAccuracy(Metric):
    name = "interval-regression-accuracy"

    def __call__(self, preds, info) -> float:
        t = np.asarray(preds, np.float64).reshape(-1)   # exp(margin): a time
        lo, hi = _bounds(info)
        ok = (t >= lo) & ((~np.isfinite(hi)) | (t <= hi))
        w = self.weights_of(info, len(t))
        return float(global_mean(np.sum(ok * w), np.sum(w), info))


@register("quantile")
class QuantileLoss(Metric):
    """The weighted mean pinball loss at ``alpha`` (``quantile@alpha``)."""

    name = "quantile"

    def __call__(self, preds, info) -> float:
        alpha = float(self.param) if self.param is not None else 0.5
        y = np.asarray(info.labels, np.float64).reshape(-1)
        p = np.asarray(preds, np.float64)
        if p.ndim == 2:
            p = p.mean(axis=1) if p.shape[1] > 1 else p[:, 0]
        err = y - p
        loss = np.where(err >= 0, alpha * err, (alpha - 1.0) * err)
        w = self.weights_of(info, len(y))
        return float(global_mean(np.sum(loss * w), np.sum(w), info))
