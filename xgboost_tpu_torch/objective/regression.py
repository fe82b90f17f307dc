"""Regression / binary objectives: prediction transforms.

Sigmoid is ``1 / (1 + exp(-x))`` as in the JAX package, so the value
path rounds the same way on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Objective, register


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


@register("reg:squarederror", "reg:linear")
class SquaredError(Objective):
    name = "reg:squarederror"


class _LogisticBase(Objective):
    def pred_transform(self, margin):
        return _sigmoid(margin)

    def prob_to_margin(self, prob):
        prob = np.clip(prob, 1e-7, 1 - 1e-7)
        return np.log(prob / (1.0 - prob))


@register("binary:logistic")
class BinaryLogistic(_LogisticBase):
    name = "binary:logistic"


@register("reg:logistic")
class RegLogistic(_LogisticBase):
    name = "reg:logistic"


@register("binary:logitraw")
class LogitRaw(_LogisticBase):
    name = "binary:logitraw"

    def pred_transform(self, margin):
        return margin  # raw margin output
