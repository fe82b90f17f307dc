"""Regression / binary objectives: gradients and prediction transforms.

Gradients are the JAX package's ``objective/regression.py`` formulas
(reference ``src/objective/regression_obj.cu``). Sigmoid is
``1 / (1 + exp(-x))`` as there; the two packages' ``exp`` are different
approximations, so gradients agree to about one f32 ulp, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Objective, register

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
