"""Objective base class: gradients, the non-finite gradient guard, the
base-score stump, the prediction transform and JSON.

Shapes follow the JAX package: margins are [n, k] (k = ``n_targets()``:
1, the label matrix's columns for multi-target labels [n, k], or
``num_class`` for the multiclass objectives), gradients [n, k, 2]
packing (grad, hess). The elementwise objectives take a label matrix
column by column, and a row's weight applies to each of its targets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..logging_utils import logger
from ..ops.xla_order import stump_sums
from ..registry import OBJECTIVES


class NumericalDivergence(RuntimeError):
    """Non-finite gradients: raised before the round's tree is committed,
    so the model on the booster stays clean (``XTPU_NAN_POLICY=raise``,
    the default). ``XTPU_NAN_POLICY=zero`` zeroes the offending (grad,
    hess) pairs with a warning instead, so their rows stop contributing,
    as zero-weight rows do; ``off`` skips the check."""

    def __init__(self, message: str, *, iteration: Optional[int] = None,
                 objective: Optional[str] = None,
                 bad_rows: Optional[int] = None) -> None:
        super().__init__(message)
        self.iteration = iteration
        self.objective = objective
        self.bad_rows = bad_rows


def _nan_policy() -> str:
    """``XTPU_NAN_POLICY``, read at each call (once a round), so a change
    between two ``train`` calls takes effect."""
    p = os.environ.get("XTPU_NAN_POLICY", "raise").strip().lower()
    if p not in ("raise", "zero", "off"):
        raise ValueError(
            f"XTPU_NAN_POLICY must be raise|zero|off, got {p!r}")
    return p


def guard_gradient(gpair: torch.Tensor, objective: str,
                   iteration: int) -> torch.Tensor:
    """Finite-check one [n, k, 2] gradient under ``XTPU_NAN_POLICY``: a
    (grad, hess) pair offends when either half is non-finite. ``raise``
    raises :class:`NumericalDivergence` naming the rows with an
    offending pair; ``zero`` zeroes those pairs with a warning (one host
    sync, as ``raise``); ``off`` returns the gradient unchecked, with no
    sync."""
    policy = _nan_policy()
    if policy == "off":
        return gpair
    pair_ok = torch.isfinite(gpair).all(dim=-1, keepdim=True)   # [n, k, 1]
    bad_rows = int((~pair_ok.all(dim=1)).sum())
    if bad_rows == 0:
        return gpair
    if policy == "zero":
        logger.warning(
            "objective %r produced non-finite gradients for %d rows at "
            "round %d; XTPU_NAN_POLICY=zero drops their contribution",
            objective, bad_rows, iteration)
        return torch.where(pair_ok, gpair, torch.zeros_like(gpair))
    raise NumericalDivergence(
        f"objective {objective!r} produced non-finite gradients for "
        f"{bad_rows} row(s) at round {iteration} — check labels/weights "
        "for NaN/Inf (or a diverging custom objective). Set "
        "XTPU_NAN_POLICY=zero to drop the offending rows and continue.",
        iteration=iteration, objective=objective, bad_rows=bad_rows)


@dataclass(frozen=True)
class ObjInfo:
    """Task descriptor (the JAX package's ``ObjInfo``; reference
    ``include/xgboost/task.h``): ``zero_hess`` marks the adaptive-leaf
    objectives, whose leaves are refreshed after each tree is grown
    (``objective/adaptive.py``)."""

    task: str = "regression"   # regression | binary | classification |
    #                            ranking | survival
    zero_hess: bool = False


class Objective:
    name: str = ""
    default_metric: str = "rmse"
    info = ObjInfo()
    # the matrix's inputs that ``get_gradient`` and ``init_estimation``
    # take as keywords besides labels and weights, each cached with the
    # Booster's entry of the matrix: ``group_ptr`` (the query offsets,
    # ranking), ``bounds`` (the [n] f32 label bounds, AFT) and
    # ``time_order`` (the rows sorted by |label|, Cox)
    takes: Tuple[str, ...] = ()

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self.params: Dict[str, Any] = {}
        if params:
            self.configure(params)

    def configure(self, params: Dict[str, Any]) -> None:
        self.params.update(params)

    def n_targets(self, info=None) -> int:
        """Output groups of the model: one margin column each; the
        columns of ``info``'s label matrix (a ``MetaInfo``), else 1."""
        labels = None if info is None else info.labels
        if labels is not None and np.ndim(labels) == 2:
            return int(labels.shape[1])
        return 1

    def gradient(self, preds: torch.Tensor, labels: torch.Tensor,
                 iteration: int = 0) -> torch.Tensor:
        """preds/labels [n, k] -> [n, k, 2]."""
        raise NotImplementedError(
            f"objective {self.name!r} has no elementwise gradient")

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
                        weights: Optional[torch.Tensor] = None,
                        row_split: bool = True,
                        **inputs: Any) -> np.ndarray:
        """One Newton step from margin 0 (reference ``fit_stump``,
        ``src/tree/fit_stump.cc``) -> [k] f32 base margin, one a target
        of a label matrix [n, k]. A label matrix's gradient sums add in
        the JAX package's order and one column in the port's own
        (``ops/xla_order.py stump_sums``). Under a multi-rank
        communicator the sums cross the ranks (``collective.global_sum``,
        the reference's ``GlobalSum``) and the step is taken in float64,
        as the JAX package takes it, so every rank derives the same base
        score from its rows; ``row_split=False`` (column split: every rank
        holds every row) keeps the sums local, the one-device step (the
        JAX package's ``global_sum(row_split=)``)."""
        from ..parallel.collective import get_communicator, global_sum

        k = labels.shape[1] if labels.dim() == 2 else 1
        zero = torch.zeros((labels.shape[0], k), dtype=torch.float32,
                           device=labels.device)
        g, h = stump_sums(self.get_gradient(zero, labels, weights,
                                            **inputs)).unbind(-1)
        if row_split and get_communicator().is_distributed():
            gh = global_sum(np.stack([g.cpu().numpy(), h.cpu().numpy()]))
            gs, hs = gh[0], gh[1]
            return np.where(hs <= 0, 0.0, -gs / np.maximum(hs, 1e-10)
                            ).astype(np.float32)
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


def register(name: str, *aliases: str):
    """Register an objective class under ``name`` and ``aliases``
    (``registry.OBJECTIVES``)."""
    return OBJECTIVES.register(name, *aliases)


def get_objective(name: str,
                  params: Optional[Dict[str, Any]] = None) -> Objective:
    if name not in OBJECTIVES:
        raise ValueError(f"unknown objective {name!r} (supported: "
                         f"{OBJECTIVES.keys()})")
    return OBJECTIVES.create(name, params)
