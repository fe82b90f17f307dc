"""Regression / binary objectives: gradients and prediction transforms.

Gradients are the JAX package's ``objective/regression.py`` formulas
(reference ``src/objective/regression_obj.cu``). Sigmoid is
``1 / (1 + exp(-x))`` as there; the two packages' ``exp`` are different
approximations, so gradients agree to about one f32 ulp, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ObjInfo, Objective, register

# A process's first torch.exp on the CPU, when PyTorch splits it over its
# OpenMP threads, can return whole thread chunks off by up to 1.5e-4
# (relative) while the vector math library sets itself up; later calls are
# within an ulp (torch 2.13 with MKL: 5 of 64 fresh processes under load,
# none of 64 after this call). One call on one element, which runs on one
# thread, does that set-up before any gradient is computed.
torch.exp(torch.zeros(1))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _pack(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.stack([g, h], dim=-1)


def _f32(v) -> float:
    """A parameter as the f32 constant the JAX package's jnp arithmetic
    rounds it to."""
    return float(np.float32(float(v)))


@register("reg:squarederror", "reg:linear")
class SquaredError(Objective):
    name = "reg:squarederror"
    default_metric = "rmse"

    def gradient(self, preds, labels, iteration=0):
        return _pack(preds - labels, torch.ones_like(preds))


class _LogisticBase(Objective):
    """Shared logistic math (reference ``LogisticRegression``)."""

    def gradient(self, preds, labels, iteration=0):
        p = _sigmoid(preds)
        g = p - labels
        h = torch.clamp(p * (1.0 - p), min=1e-16)
        spw = float(np.float32(self.params.get("scale_pos_weight", 1.0)))
        if spw != 1.0:
            w = torch.where(labels == 1.0, torch.full_like(labels, spw),
                            torch.ones_like(labels))
            g, h = g * w, h * w
        return _pack(g, h)

    def pred_transform(self, margin):
        return _sigmoid(margin)

    def prob_to_margin(self, prob):
        prob = np.clip(prob, 1e-7, 1 - 1e-7)
        return np.log(prob / (1.0 - prob))


@register("binary:logistic")
class BinaryLogistic(_LogisticBase):
    name = "binary:logistic"
    default_metric = "logloss"


@register("reg:logistic")
class RegLogistic(_LogisticBase):
    name = "reg:logistic"
    default_metric = "rmse"


@register("binary:logitraw")
class LogitRaw(_LogisticBase):
    name = "binary:logitraw"
    default_metric = "logloss"

    def pred_transform(self, margin):
        return margin  # raw margin output


def _exp_prob_to_margin(prob):
    """The inverse of ``exp`` for a base score (the log objectives)."""
    return np.log(np.maximum(prob, 1e-16))


@register("reg:squaredlogerror")
class SquaredLogError(Objective):
    name = "reg:squaredlogerror"
    default_metric = "rmsle"

    def gradient(self, preds, labels, iteration=0):
        p1 = preds + 1.0
        r = torch.log(p1) - torch.log(labels + 1.0)
        g = r / p1
        h = torch.clamp((1.0 - r) / torch.square(p1), min=1e-6)
        return _pack(g, h)


@register("reg:pseudohubererror")
class PseudoHuber(Objective):
    name = "reg:pseudohubererror"
    default_metric = "mphe"

    def gradient(self, preds, labels, iteration=0):
        slope = _f32(self.params.get("huber_slope", 1.0))
        r = preds - labels
        scale = 1.0 + torch.square(r / slope)
        sqrt_s = torch.sqrt(scale)
        return _pack(r / sqrt_s, 1.0 / (scale * sqrt_s))


@register("count:poisson")
class Poisson(Objective):
    name = "count:poisson"
    default_metric = "poisson-nloglik"

    def gradient(self, preds, labels, iteration=0):
        # 0.7 when no max_delta_step is given (the reference's default
        # for this objective; the tree parameter's default is 0)
        max_delta = _f32(self.params.get("max_delta_step", 0.7))
        return _pack(torch.exp(preds) - labels, torch.exp(preds + max_delta))

    def pred_transform(self, margin):
        return torch.exp(margin)

    def prob_to_margin(self, prob):
        return _exp_prob_to_margin(prob)


@register("reg:gamma")
class GammaDeviance(Objective):
    name = "reg:gamma"
    default_metric = "gamma-nloglik"

    def gradient(self, preds, labels, iteration=0):
        e = torch.exp(-preds)
        return _pack(1.0 - labels * e, labels * e)

    def pred_transform(self, margin):
        return torch.exp(margin)

    def prob_to_margin(self, prob):
        return _exp_prob_to_margin(prob)


@register("reg:tweedie")
class Tweedie(Objective):
    name = "reg:tweedie"

    @property
    def rho(self) -> float:
        return float(self.params.get("tweedie_variance_power", 1.5))

    @property
    def default_metric(self):  # type: ignore[override]
        return f"tweedie-nloglik@{self.rho}"

    def gradient(self, preds, labels, iteration=0):
        rho = self.rho
        e1 = torch.exp(_f32(1.0 - rho) * preds)
        e2 = torch.exp(_f32(2.0 - rho) * preds)
        g = -labels * e1 + e2
        h = -labels * _f32(1.0 - rho) * e1 + _f32(2.0 - rho) * e2
        return _pack(g, h)

    def pred_transform(self, margin):
        return torch.exp(margin)

    def prob_to_margin(self, prob):
        return _exp_prob_to_margin(prob)


@register("binary:hinge")
class Hinge(Objective):
    name = "binary:hinge"
    default_metric = "error"
    info = ObjInfo("binary")

    def gradient(self, preds, labels, iteration=0):
        y = labels * 2.0 - 1.0                     # {0, 1} -> {-1, +1}
        active = preds * y < 1.0
        g = torch.where(active, -y, torch.zeros_like(y))
        h = torch.where(active, torch.ones_like(y),
                        torch.full_like(y, 1e-16))
        return _pack(g, h)

    def pred_transform(self, margin):
        return (margin > 0.0).to(torch.float32)

    def init_estimation(self, labels, weights=None, **inputs):
        return np.zeros(1, dtype=np.float32)
