"""Tree training hyper-parameters and the split-gain math.

The port of the JAX package's ``tree/param.py``: the reference's
``TrainParam`` field set (``src/tree/param.h``) and its ``CalcGain`` /
``CalcWeight`` / ``ThresholdL1`` formulas as torch ops. Scalars are
rounded to f32 before they meet a tensor, so every op runs in f32 as
it does in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Parameter, param_field


@dataclass
class TrainParam(Parameter):
    # learning
    eta: float = param_field(0.3, aliases=("learning_rate",), lower=0.0)
    gamma: float = param_field(0.0, aliases=("min_split_loss",), lower=0.0)
    max_depth: int = param_field(6, lower=0)
    max_leaves: int = param_field(0, lower=0)
    max_bin: int = param_field(256, lower=2)
    grow_policy: str = param_field("depthwise")  # depthwise | lossguide
    min_child_weight: float = param_field(1.0, lower=0.0)
    reg_lambda: float = param_field(1.0, aliases=("lambda",), lower=0.0)
    reg_alpha: float = param_field(0.0, aliases=("alpha",), lower=0.0)
    max_delta_step: float = param_field(0.0, lower=0.0)
    # sampling
    subsample: float = param_field(1.0, lower=0.0, upper=1.0)
    sampling_method: str = param_field("uniform")
    colsample_bytree: float = param_field(1.0, lower=0.0, upper=1.0)
    colsample_bylevel: float = param_field(1.0, lower=0.0, upper=1.0)
    colsample_bynode: float = param_field(1.0, lower=0.0, upper=1.0)
    # constraints
    monotone_constraints: str = param_field("()")
    interaction_constraints: str = param_field("")
    # categorical
    max_cat_to_onehot: int = param_field(4, lower=1)
    max_cat_threshold: int = param_field(64, lower=1)
    # misc
    sparse_threshold: float = param_field(0.2)
    refresh_leaf: bool = param_field(True)
    process_type: str = param_field("default")


def _f32(x: float) -> float:
    """A Python float holding the f32 value of ``x``."""
    return float(np.float32(x))


# --- split-gain math (reference src/tree/param.h:243-330) --------------------

def threshold_l1(g: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return g
    return torch.sign(g) * torch.clamp(g.abs() - _f32(alpha), min=0.0)


def calc_weight(g: torch.Tensor, h: torch.Tensor, p: TrainParam) -> torch.Tensor:
    """Optimal leaf weight -ThresholdL1(G)/(H+lambda), clipped by
    max_delta_step; zero where H <= 0."""
    w = -threshold_l1(g, p.reg_alpha) / (h + _f32(p.reg_lambda))
    w = torch.where(h <= 0.0, torch.zeros_like(w), w)
    if p.max_delta_step != 0.0:
        m = _f32(p.max_delta_step)
        w = torch.clamp(w, -m, m)
    return w


def calc_gain_given_weight(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                           p: TrainParam) -> torch.Tensor:
    """-(2*G*w + (H+lambda)*w^2), the gain when max_delta_step clips w."""
    return -(2.0 * g * w + (h + _f32(p.reg_lambda)) * torch.square(w))


def calc_gain(g: torch.Tensor, h: torch.Tensor, p: TrainParam) -> torch.Tensor:
    """Structure score Sqr(ThresholdL1(G))/(H+lambda); zero for empty nodes."""
    if p.max_delta_step == 0.0:
        gain = (torch.square(threshold_l1(g, p.reg_alpha))
                / (h + _f32(p.reg_lambda)))
    else:
        gain = calc_gain_given_weight(g, h, calc_weight(g, h, p), p)
    return torch.where(h <= 0.0, torch.zeros_like(gain), gain)
