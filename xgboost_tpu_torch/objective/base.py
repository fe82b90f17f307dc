"""Objective base class: gradients, the non-finite gradient guard, the
base-score stump, the prediction transform and JSON.

Shapes follow the JAX package: margins are [n, k] (k = 1 in this
slice), gradients [n, k, 2] packing (grad, hess).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class NumericalDivergence(RuntimeError):
    """Non-finite gradients: raised before the round's tree is committed,
    so the model on the booster stays clean (the JAX package's default
    ``raise`` policy; its ``zero`` and ``off`` policies are not ported)."""

    def __init__(self, message: str, *, iteration: Optional[int] = None,
                 objective: Optional[str] = None,
                 bad_rows: Optional[int] = None) -> None:
        super().__init__(message)
        self.iteration = iteration
        self.objective = objective
        self.bad_rows = bad_rows


def guard_gradient(gpair: torch.Tensor, objective: str,
                   iteration: int) -> torch.Tensor:
    """Raise :class:`NumericalDivergence` when any (grad, hess) pair of
    the [n, k, 2] gradient is non-finite; else return it unchanged."""
    pair_ok = torch.isfinite(gpair).all(dim=-1)                  # [n, k]
    bad_rows = int((~pair_ok.all(dim=1)).sum())
    if bad_rows == 0:
        return gpair
    raise NumericalDivergence(
        f"objective {objective!r} produced non-finite gradients for "
        f"{bad_rows} row(s) at round {iteration} — check labels/weights "
        "for NaN/Inf.", iteration=iteration, objective=objective,
        bad_rows=bad_rows)


class Objective:
    name: str = ""
    default_metric: str = "rmse"

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self.params: Dict[str, Any] = {}
        if params:
            self.configure(params)

    def configure(self, params: Dict[str, Any]) -> None:
        self.params.update(params)

    def gradient(self, preds: torch.Tensor, labels: torch.Tensor,
                 iteration: int = 0) -> torch.Tensor:
        """preds/labels [n, k] -> [n, k, 2]."""
        raise NotImplementedError(
            f"objective {self.name!r} has no gradient in the PyTorch port "
            "yet (ROADMAP A.5.11)")

    def get_gradient(self, preds: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     iteration: int = 0) -> torch.Tensor:
        """preds [n, k]; labels [n] or [n, k]; weights [n] or None, all on
        one device -> guarded [n, k, 2]."""
        if labels.dim() == 1:
            labels = labels[:, None]
        gpair = self.gradient(preds, labels, iteration)
        if weights is not None:
            gpair = gpair * weights[:, None, None]
        return guard_gradient(gpair, self.name, iteration)

    def init_estimation(self, labels: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> np.ndarray:
        """One Newton step from margin 0 (reference ``fit_stump``,
        ``src/tree/fit_stump.cc``) -> [k] f32 base margin."""
        zero = torch.zeros((labels.shape[0], 1), dtype=torch.float32,
                           device=labels.device)
        gpair = self.get_gradient(zero, labels, weights)
        g = gpair[..., 0].sum(dim=0)
        h = gpair[..., 1].sum(dim=0)
        est = torch.where(h <= 0, torch.zeros_like(g),
                          -g / torch.clamp(h, min=1e-10))
        return est.to(torch.float32).cpu().numpy()

    def pred_transform(self, margin: torch.Tensor) -> torch.Tensor:
        return margin

    def prob_to_margin(self, prob: np.ndarray) -> np.ndarray:
        return prob

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name,
                **{k: str(v) for k, v in self.params.items()}}


OBJECTIVES: Dict[str, type] = {}


def register(*names: str):
    def deco(cls):
        for n in names:
            OBJECTIVES[n] = cls
        return cls
    return deco


def get_objective(name: str,
                  params: Optional[Dict[str, Any]] = None) -> Objective:
    cls = OBJECTIVES.get(name)
    if cls is None:
        raise NotImplementedError(
            f"objective {name!r} is not in the PyTorch port yet "
            f"(supported: {sorted(OBJECTIVES)}; the rest wait with "
            "ROADMAP A.5.11)")
    return cls(params)
