"""Metric base: a named factory with ``name@param`` parsing (the port of
the JAX package's ``metric/base.py``, single process)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Metric:
    name: str = ""

    def __init__(self, param: Optional[str] = None) -> None:
        self.param = param

    @property
    def full_name(self) -> str:
        return (f"{self.name}@{self.param}" if self.param is not None
                else self.name)

    def __call__(self, preds: np.ndarray, info) -> float:
        """preds: transformed predictions [n]; info: the DMatrix's
        MetaInfo (labels, weights)."""
        raise NotImplementedError

    @staticmethod
    def weights_of(info, n: int) -> np.ndarray:
        if info.weights is not None:
            return np.asarray(info.weights, dtype=np.float64)
        return np.ones(n, dtype=np.float64)


METRICS: Dict[str, type] = {}


def register(*names: str):
    def deco(cls):
        for n in names:
            METRICS[n] = cls
        return cls
    return deco


def get_metric(name: str) -> Metric:
    base, _, param = name.partition("@")
    cls = METRICS.get(base)
    if cls is None:
        raise NotImplementedError(
            f"metric {name!r} is not in the PyTorch port yet (supported: "
            f"{sorted(METRICS)}; the rest wait with ROADMAP A.5.11)")
    return cls(param or None)
