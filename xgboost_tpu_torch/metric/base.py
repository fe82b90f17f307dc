"""Metric base: a named factory with ``name@param`` parsing (the port of
the JAX package's ``metric/base.py``). Weighted-mean metrics aggregate
their partial sums over the active communicator (:func:`global_mean`)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..registry import METRICS


def global_mean(numerator: float, denominator: float, info) -> float:
    """A weighted-mean metric's ratio (the JAX package's ``global_mean``;
    reference ``collective::GlobalRatio``, ``aggregator.h:115``): under a
    multi-rank communicator both sides are summed over the ranks first
    (not under column split, whose rows every rank holds); NaN when the
    denominator is 0."""
    from ..parallel.collective import get_communicator, global_ratio

    if get_communicator().is_distributed():
        row_split = getattr(info, "data_split_mode", "row") == "row"
        return global_ratio(float(numerator), float(denominator),
                            row_split=row_split)
    return (float(np.float64(numerator) / np.float64(denominator))
            if denominator != 0 else float("nan"))


class Metric:
    name: str = ""
    # larger is better (the drift gates' and the canary's orientation)
    maximize: bool = False

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


def register(name: str, *aliases: str):
    """Register a metric class under ``name`` and ``aliases``
    (``registry.METRICS``)."""
    return METRICS.register(name, *aliases)


def get_metric(name: str) -> Metric:
    base, _, param = name.partition("@")
    if base not in METRICS:
        raise ValueError(f"unknown metric {name!r} (supported: "
                         f"{METRICS.keys()})")
    return METRICS.create(base, param or None)
