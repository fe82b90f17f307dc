"""A dense in-memory data matrix (reference ``SimpleDMatrix``): numpy
input, ``missing`` mapped to NaN, labels, sample weights, feature names,
a per-row base margin, and its quantized form for training, built once
per ``(max_bin, device)`` and cached."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from .binned import BinnedMatrix
from .quantile import sketch_matrix


@dataclass
class MetaInfo:
    labels: Optional[np.ndarray] = None        # [n] f32
    weights: Optional[np.ndarray] = None       # [n] f32
    base_margin: Optional[np.ndarray] = None   # [n] or [n, n_groups]
    feature_names: Optional[List[str]] = None
    feature_types: Optional[List[str]] = None


def _rows(name: str, value: Any, n: int) -> np.ndarray:
    arr = np.asarray(value, dtype=np.float32)
    if arr.shape[0] != n:
        raise ValueError(f"{name} has {arr.shape[0]} entries, expected {n}")
    return arr


class DMatrix:
    """Dense float32 feature matrix with NaN for missing entries."""

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_names: Optional[List[str]] = None) -> None:
        X = np.asarray(data, dtype=np.float32)
        if X.ndim == 1:
            X = X[:, None]
        if X.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {X.shape}")
        if missing is not None and not np.isnan(missing):
            X = X.copy()
            X[X == missing] = np.nan
        self.X = X
        self.info = MetaInfo()
        self.feature_names = feature_names
        n = self.num_row()
        if label is not None:
            lab = _rows("label", label, n)
            if lab.ndim == 2 and lab.shape[1] == 1:
                lab = lab[:, 0]
            if lab.ndim != 1:
                raise NotImplementedError(
                    "multi-target labels are not in the PyTorch port yet "
                    "(ROADMAP A.5.7)")
            self.info.labels = lab
        if weight is not None:
            self.info.weights = _rows("weight", weight, n)
        if base_margin is not None:
            self.info.base_margin = _rows("base_margin", base_margin, n)
        self._binned: dict = {}

    def num_row(self) -> int:
        return self.X.shape[0]

    def num_col(self) -> int:
        return self.X.shape[1]

    @property
    def feature_names(self) -> Optional[List[str]]:
        return self.info.feature_names

    @feature_names.setter
    def feature_names(self, names: Optional[List[str]]) -> None:
        if names is not None:
            names = [str(n) for n in names]
            if len(names) != self.num_col():
                raise ValueError(
                    f"feature_names has {len(names)} entries, "
                    f"expected {self.num_col()}")
            if len(set(names)) != len(names):
                raise ValueError("feature_names must be unique")
        self.info.feature_names = names

    def values(self) -> np.ndarray:
        """The raw [n, F] float32 features, NaN where missing."""
        return self.X

    def binned(self, max_bin: int, device: torch.device) -> BinnedMatrix:
        """The quantized matrix on ``device``, sketched here, built once
        and cached."""
        key = (max_bin, str(device))
        bm = self._binned.get(key)
        if bm is None:
            cuts = sketch_matrix(self.X, max_bin, self.info.weights,
                                 self.info.feature_types)
            bm = BinnedMatrix.from_dense(self.X, cuts, device)
            self._binned[key] = bm
        return bm
