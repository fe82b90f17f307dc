"""Metric base: a named factory with ``name@param`` parsing (the port of
the JAX package's ``metric/base.py``, single process)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def global_mean(numerator: float, denominator: float, info) -> float:
    """A weighted-mean metric's ratio (the JAX package's ``global_mean``
    in one process: its collective sums wait with ROADMAP A.8); NaN when
    the denominator is 0."""
    return (float(np.float64(numerator) / np.float64(denominator))
            if denominator != 0 else float("nan"))


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
        """One weight a row (a query's weight on each of its rows)."""
        w = info.row_weights() if hasattr(info, "row_weights") \
            else info.weights
        if w is not None:
            return np.asarray(w, dtype=np.float64)
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
        raise ValueError(f"unknown metric {name!r} (supported: "
                         f"{sorted(METRICS)})")
    return cls(param or None)
