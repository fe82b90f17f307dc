"""A minimal dense in-memory data matrix (reference ``SimpleDMatrix``):
numpy input, ``missing`` mapped to NaN, feature names, and a per-row base
margin. Labels and quantisation come with the training slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np


@dataclass
class MetaInfo:
    base_margin: Optional[np.ndarray] = None   # [n] or [n, n_groups]
    feature_names: Optional[List[str]] = None


class DMatrix:
    """Dense float32 feature matrix with NaN for missing entries."""

    def __init__(self, data: Any, *, base_margin: Any = None,
                 missing: float = np.nan,
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
        if base_margin is not None:
            bm = np.asarray(base_margin, dtype=np.float32)
            if bm.shape[0] != self.num_row():
                raise ValueError(f"base_margin has {bm.shape[0]} entries, "
                                 f"expected {self.num_row()}")
            self.info.base_margin = bm

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
