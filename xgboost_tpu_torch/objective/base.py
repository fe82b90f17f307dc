"""Objective base class: the prediction side only (transform, margin of
a base score, JSON). Gradients come with the training slice."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class Objective:
    name: str = ""

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self.params: Dict[str, Any] = {}
        if params:
            self.configure(params)

    def configure(self, params: Dict[str, Any]) -> None:
        self.params.update(params)

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
            f"(supported: {sorted(OBJECTIVES)})")
    return cls(params)
