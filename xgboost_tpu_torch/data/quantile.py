"""Weighted quantile sketch -> histogram cuts (host numpy).

The port of the JAX package's ``data/quantile.py`` numpy path (reference
``src/common/quantile.h``, ``src/common/hist_util.cc:32-69``): per-feature
weighted summaries (sorted unique values and their total weight) cut at
evenly spaced weighted ranks into at most ``max_bin`` real bins. The JAX
package may route the same computation through its native C++ sketch,
which it documents as giving the same cuts; the port keeps only the
numpy path.

Cuts are ragged (``values``/``ptrs`` over REAL bins only, as in
``common::HistogramCuts``); ``data/binned.py`` pads every feature to a
uniform slot count with a trailing missing slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


def _sorted_unique_sums(v: np.ndarray, w: Optional[np.ndarray]):
    """Sorted values -> (unique values, per-unique weight sums); counts when
    ``w`` is None."""
    new = np.empty(len(v), bool)
    new[0] = True
    np.not_equal(v[1:], v[:-1], out=new[1:])
    start = np.flatnonzero(new)
    if w is None:
        wsum = np.diff(np.append(start, len(v))).astype(np.float64)
    else:
        wsum = np.add.reduceat(w, start)
    return v[start], wsum


@dataclass
class FeatureSummary:
    """Weighted summary of one feature: sorted unique values and the total
    weight on each (exact for in-memory data)."""

    values: np.ndarray   # [k] f64 sorted unique
    weights: np.ndarray  # [k] f64 total weight per value

    @staticmethod
    def from_data(col: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> "FeatureSummary":
        mask = ~np.isnan(col)
        v = col[mask].astype(np.float64)
        if v.size == 0:
            return FeatureSummary(np.empty(0), np.empty(0))
        if weights is None:
            uniq, wsum = _sorted_unique_sums(np.sort(v), None)
        else:
            order = np.argsort(v)
            uniq, wsum = _sorted_unique_sums(
                v[order], weights[mask].astype(np.float64)[order])
        return FeatureSummary(uniq, wsum)


@dataclass
class HistogramCuts:
    """Quantile cut points (reference ``common::HistogramCuts``).

    ``values[ptrs[f] + i]`` is the inclusive upper bound of REAL bin ``i``
    of feature ``f`` (value v falls in bin i iff values[i-1] < v <=
    values[i]); ``min_vals[f]`` is below the smallest observed value.
    """

    values: np.ndarray    # [total_real_bins] f32
    ptrs: np.ndarray      # [n_features + 1] int32
    min_vals: np.ndarray  # [n_features] f32
    max_bin: int = 256
    feature_types: Optional[list] = None

    @property
    def n_features(self) -> int:
        return len(self.ptrs) - 1

    def n_real_bins(self) -> np.ndarray:
        return np.diff(self.ptrs).astype(np.int32)

    def search_bin(self, values: np.ndarray) -> np.ndarray:
        """SearchBin over a dense [n, n_features] float matrix on the host
        -> LOCAL real-bin indices; missing (NaN) -> -1. ``data/binned.py``
        does the same on the device."""
        n, nf = values.shape
        out = np.empty((n, nf), dtype=np.int32)
        for f in range(nf):
            lo, hi = int(self.ptrs[f]), int(self.ptrs[f + 1])
            cuts = self.values[lo:hi]
            col = values[:, f]
            b = np.searchsorted(cuts, col, side="left")
            b = np.minimum(b, hi - lo - 1)  # clamp overflow into last bin
            b[np.isnan(col)] = -1
            out[:, f] = b
        return out

    def split_values(self, split_feature: np.ndarray,
                     split_bin: np.ndarray) -> np.ndarray:
        """Raw thresholds for per-node (feature, local bin) pairs; entries
        with split_feature < 0 (leaves) map to 0."""
        sf = np.asarray(split_feature)
        sb = np.asarray(split_bin)
        out = np.zeros(sf.shape, np.float32)
        mask = sf >= 0
        gb = self.ptrs[np.maximum(sf, 0)] + sb
        out[mask] = self.values[np.clip(gb[mask], 0, len(self.values) - 1)]
        return out

    def is_cat(self) -> np.ndarray:
        if not self.feature_types:
            return np.zeros(self.n_features, dtype=bool)
        return np.asarray([t == "c" for t in self.feature_types])

    def to_json(self) -> dict:
        return {
            "values": np.asarray(self.values, dtype=np.float64).tolist(),
            "ptrs": self.ptrs.tolist(),
            "min_vals": np.asarray(self.min_vals, dtype=np.float64).tolist(),
            "max_bin": self.max_bin,
            "feature_types": self.feature_types,
        }


def cuts_from_summaries(summaries: Sequence[FeatureSummary], max_bin: int,
                        feature_types: Optional[List[str]] = None
                        ) -> HistogramCuts:
    """Cuts at evenly spaced weighted ranks (``HistogramCuts::Build``
    semantics: the last cut lies strictly above the max value, so every
    observed value lands in a real bin). Categorical features are not in
    the port yet (ROADMAP A.5.5)."""
    if feature_types is not None and "c" in feature_types:
        raise NotImplementedError(
            "categorical features are not in the PyTorch port yet "
            "(ROADMAP A.5.5)")
    values: List[np.ndarray] = []
    ptrs = [0]
    min_vals = []
    for s in summaries:
        if s.values.size == 0:
            cuts = np.asarray([np.inf], dtype=np.float32)
            min_vals.append(0.0)
        else:
            vmin, vmax = float(s.values[0]), float(s.values[-1])
            if s.values.size <= max_bin:
                pts = s.values.astype(np.float64)
            else:
                cum = np.cumsum(s.weights)
                total = cum[-1]
                ranks = (np.arange(1, max_bin + 1) / max_bin) * total
                idx = np.searchsorted(cum, ranks, side="left")
                idx = np.unique(np.clip(idx, 0, s.values.size - 1))
                pts = s.values[idx].astype(np.float64)
            last = vmax + (abs(vmax) * 1e-5 + 1e-5)
            cuts = np.unique(np.concatenate([pts[:-1], [last]])).astype(
                np.float32)
            min_vals.append(vmin - (abs(vmin) * 1e-5 + 1e-5))
        values.append(cuts)
        ptrs.append(ptrs[-1] + len(cuts))
    out = (np.concatenate(values) if values
           else np.empty(0, dtype=np.float32)).astype(np.float32)
    return HistogramCuts(values=out, ptrs=np.asarray(ptrs, dtype=np.int32),
                         min_vals=np.asarray(min_vals, dtype=np.float32),
                         max_bin=max_bin, feature_types=feature_types)


# Rows used for quantile sketching of large unweighted matrices: above this
# the sketch runs on a deterministic strided row sample (the JAX package's
# default; at 2M sampled rows the order-statistic error is ~0.2 of one
# 256-bin width). Values above the sampled maximum clamp into the last bin.
SKETCH_SAMPLE_ROWS = 2_000_000


def sketch_matrix(X: np.ndarray, max_bin: int,
                  weights: Optional[np.ndarray] = None,
                  feature_types: Optional[List[str]] = None,
                  sample_rows: Optional[int] = None) -> HistogramCuts:
    """``SketchOnDMatrix`` for an in-memory dense matrix, NaN = missing."""
    limit = SKETCH_SAMPLE_ROWS if sample_rows is None else sample_rows
    if weights is None and limit and X.shape[0] > limit:
        stride = -(-X.shape[0] // limit)
        X = np.ascontiguousarray(X[::stride])
    summaries = [FeatureSummary.from_data(X[:, f], weights)
                 for f in range(X.shape[1])]
    return cuts_from_summaries(summaries, max_bin, feature_types)
