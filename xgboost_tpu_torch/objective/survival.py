"""Survival objectives: ``survival:aft`` (censored accelerated failure
time) and ``survival:cox`` (proportional hazards), the JAX package's
``objective/survival.py`` (reference ``src/objective/aft_obj.cu``,
``src/common/probability_distribution.h``, the Cox section of
``regression_obj.cu``).

AFT's gradient is elementwise f32 torch over the matrix's label bounds
``[label_lower_bound, label_upper_bound]`` (uncensored when they are
equal, right-censored when the upper one is +inf, left-censored when
the lower one is 0, interval-censored otherwise), clipped to [-15, 15]
and its hessian to [1e-16, 15]; ``erf`` is ``torch.erf``, another
approximation than XLA's, so gradients agree to an ulp or so. Cox's
risk-set sums are float64 on the matrix's device over the rows sorted
by |time| (a negative label is a right-censored time), the sort made
once a matrix (the Booster keeps it with its cache entry).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .base import ObjInfo, Objective, guard_gradient, register

_SQRT2PI = math.sqrt(2.0 * math.pi)
_EPS = 1e-12
_HESS_MIN = 1e-16


class _Normal:
    @staticmethod
    def pdf(z):
        return torch.exp(-0.5 * z * z) / _SQRT2PI

    @staticmethod
    def cdf(z):
        return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))

    @staticmethod
    def pdf_prime(z):
        return -z * _Normal.pdf(z)


class _Logistic:
    @staticmethod
    def pdf(z):
        e = torch.exp(-torch.abs(z))
        return e / torch.square(1.0 + e)

    @staticmethod
    def cdf(z):
        return 1.0 / (1.0 + torch.exp(-z))

    @staticmethod
    def pdf_prime(z):
        p = _Logistic.cdf(z)
        return _Logistic.pdf(z) * (1.0 - 2.0 * p)


class _Extreme:
    """Gumbel (minimum), as the reference's ``extreme``."""

    @staticmethod
    def _w(z):
        return torch.exp(torch.clamp(z, -50.0, 50.0))

    @staticmethod
    def pdf(z):
        w = _Extreme._w(z)
        return w * torch.exp(-w)

    @staticmethod
    def cdf(z):
        return 1.0 - torch.exp(-_Extreme._w(z))

    @staticmethod
    def pdf_prime(z):
        return _Extreme.pdf(z) * (1.0 - _Extreme._w(z))


DISTRIBUTIONS = {"normal": _Normal, "logistic": _Logistic,
                 "extreme": _Extreme}


def _uncensored_hess(z, dist, sigma: float):
    if dist is _Normal:
        return torch.full_like(z, 1.0 / (sigma * sigma))
    if dist is _Logistic:
        p = _Logistic.cdf(z)
        return 2.0 * p * (1.0 - p) / (sigma * sigma)
    return _Extreme._w(z) / (sigma * sigma)


def aft_grad_hess(margin: torch.Tensor, y_lower: torch.Tensor,
                  y_upper: torch.Tensor, dist, sigma: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient and hessian [n] of the AFT negative log likelihood with
    respect to the margin [n] (the JAX package's ``aft_grad_hess``):
    z = (log t - margin) / sigma."""
    zero = torch.zeros_like(margin)
    log_lo = torch.log(torch.clamp(y_lower, min=_EPS))
    log_hi = torch.log(torch.clamp(y_upper, min=_EPS))
    z_lo = (log_lo - margin) / sigma
    z_hi = (log_hi - margin) / sigma
    uncensored = torch.isfinite(y_upper) & (torch.abs(y_upper - y_lower)
                                            < 1e-30)
    right = ~torch.isfinite(y_upper)
    has_lo = y_lower > 0

    f = dist.pdf(z_lo)
    dlogf = dist.pdf_prime(z_lo) / torch.clamp(f, min=_EPS)
    g_unc = dlogf / sigma
    h_unc = _uncensored_hess(z_lo, dist, sigma)

    # L = S(z_lo) - S(z_hi), S = 1 - CDF; right: S(z_hi) = 0, left: S(z_lo)
    # = 1
    s_lo = torch.where(has_lo, 1.0 - dist.cdf(z_lo), torch.ones_like(zero))
    s_hi = torch.where(right, zero, 1.0 - dist.cdf(z_hi))
    f_lo = torch.where(has_lo, dist.pdf(z_lo), zero)
    f_hi = torch.where(right, zero, dist.pdf(z_hi))
    fp_lo = torch.where(has_lo, dist.pdf_prime(z_lo), zero)
    fp_hi = torch.where(right, zero, dist.pdf_prime(z_hi))
    L = torch.clamp(s_lo - s_hi, min=_EPS)
    dL = (f_lo - f_hi) / sigma
    d2L = -(fp_lo - fp_hi) / (sigma * sigma)
    g_cens = -dL / L
    h_cens = -(d2L * L - dL * dL) / (L * L)

    g = torch.where(uncensored, g_unc, g_cens)
    h = torch.where(uncensored, h_unc, h_cens)
    return torch.clamp(g, -15.0, 15.0), torch.clamp(h, _HESS_MIN, 15.0)


@register("survival:aft")
class AFT(Objective):
    name = "survival:aft"
    default_metric = "aft-nloglik"
    info = ObjInfo("survival")
    takes = ("bounds",)

    def _bounds(self, bounds):
        if bounds is None:
            raise ValueError("survival:aft requires label_lower_bound / "
                             "label_upper_bound in the DMatrix")
        return bounds

    def get_gradient(self, preds, labels, weights=None, iteration=0,
                     bounds: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None):
        """preds [n, 1]; ``bounds`` ([n], [n]) f32 on preds' device ->
        [n, 1, 2] (the labels are not read)."""
        lo, hi = self._bounds(bounds)
        sigma = float(self.params.get("aft_loss_distribution_scale", 1.0))
        dist = DISTRIBUTIONS[self.params.get("aft_loss_distribution",
                                             "normal")]
        g, h = aft_grad_hess(preds[:, 0], lo, hi, dist, sigma)
        if weights is not None:
            g, h = g * weights, h * weights
        return guard_gradient(torch.stack([g, h], dim=-1)[:, None, :],
                              self.name, iteration)

    def pred_transform(self, margin):
        return torch.exp(margin)

    def prob_to_margin(self, prob):
        return np.log(np.maximum(prob, 1e-16))

    def init_estimation(self, labels, weights=None, bounds=None, **inputs):
        """The mean log of each interval's middle (its lower bound when it
        is right-censored), float64 on the host as the JAX package."""
        lo, hi = (b.cpu().numpy().astype(np.float64)
                  for b in self._bounds(bounds))
        mid = np.where(np.isfinite(hi), (lo + hi) / 2.0, lo)
        return np.asarray([np.log(np.maximum(mid, 1e-16)).mean()],
                          dtype=np.float32)


def sort_by_time(labels: torch.Tensor) -> torch.Tensor:
    """The rows sorted by |time| (stable): Cox's risk-set order."""
    return torch.sort(torch.abs(labels.reshape(-1)), stable=True).indices


@register("survival:cox")
class Cox(Objective):
    """Cox partial likelihood; a label > 0 is an event time, < 0 a
    right-censored time |label|."""

    name = "survival:cox"
    default_metric = "cox-nloglik"
    info = ObjInfo("survival")
    takes = ("time_order",)

    def get_gradient(self, preds, labels, weights=None, iteration=0,
                     time_order: Optional[torch.Tensor] = None):
        """preds [n, 1]; ``time_order`` [n] from :func:`sort_by_time` (made
        here when not given) -> [n, 1, 2]: the JAX package's float64
        risk-set sums, cast to f32."""
        f64 = torch.float64
        y = labels.reshape(-1).to(f64)
        n = y.shape[0]
        order = sort_by_time(labels) if time_order is None else time_order
        ms = preds.reshape(-1)[:n].to(f64)[order]
        ys = y[order]
        ws = (torch.ones_like(ys) if weights is None
              else weights.to(f64)[order])
        exp_m = torch.exp(ms - ms.max())
        # S_i = sum_{j >= i} w_j exp(m_j): the risk set of the i-th time
        S = torch.flip(torch.cumsum(torch.flip(ws * exp_m, [0]), 0), [0])
        event = ys > 0
        zero = torch.zeros_like(ys)
        inv_S = torch.where(event, ws / torch.clamp(S, min=_EPS), zero)
        inv_S2 = torch.where(event, ws / torch.clamp(S * S, min=_EPS), zero)
        r = torch.cumsum(inv_S, 0)
        r2 = torch.cumsum(inv_S2, 0)
        g_s = exp_m * r - event.to(f64)
        h_s = torch.clamp(exp_m * r - exp_m * exp_m * r2, min=1e-16)
        g = torch.empty_like(g_s)
        h = torch.empty_like(h_s)
        g[order] = g_s
        h[order] = h_s
        gpair = torch.stack([g, h], dim=-1).to(torch.float32)[:, None, :]
        return guard_gradient(gpair, self.name, iteration)

    def pred_transform(self, margin):
        return torch.exp(margin)

    def prob_to_margin(self, prob):
        return np.log(np.maximum(prob, 1e-16))

    def init_estimation(self, labels, weights=None, **inputs):
        return np.zeros(1, dtype=np.float32)
