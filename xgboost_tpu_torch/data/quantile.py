"""Weighted quantile sketch -> histogram cuts, on the host and on the
device.

The port of the JAX package's ``data/quantile.py`` (reference
``src/common/quantile.h``, ``src/common/hist_util.cc:32-69``): per-feature
weighted summaries (sorted unique values and their total weight) cut at
evenly spaced weighted ranks into at most ``max_bin`` real bins. An
iterator-built matrix sketches batch by batch and merges the summaries,
each merge pruned to ``8 * max_bin`` entries (``FeatureSummary.merge`` /
``prune``, reference ``WQSummary::Prune``).

With weights the host summary follows the JAX package's native C++
sketch (``native/sketch.cc``), which that package takes whenever its
library loads: -0.0 counts as +0.0 (the unweighted summary keeps the
numpy path's order, so the hist models' bytes stay as they were), ties
keep row order (a stable sort),
each value's weight is summed in that order from 0.0 and the cumulative
weight runs value by value, all in f64. Where those sums are exact
(integer weights, or f32 weights of similar size over up to about 2^20
rows) every order gives the same bits, and the cuts equal both of the
JAX package's sketches.

:class:`WeightedSketch` is the same cut rule as torch ops on the
matrix's device, for ``tree_method="approx"``, which re-sketches with
the hessian as the weights every round: the sort happens once, when the
sketch is built; each call gathers the weights in sorted order and cuts
without sorting.

Cuts are ragged (``values``/``ptrs`` over REAL bins only, as in
``common::HistogramCuts``); ``data/binned.py`` pads every feature to a
uniform slot count with a trailing missing slot. A categorical feature
(``feature_types[f] == "c"``) gets one bin per category code, its cuts
``arange(n_cat)`` with ``n_cat`` one above the largest code sketched,
so that ``search_bin`` maps code c to bin c (codes above the last one
clamp into it, as for a numeric feature).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


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


# runs at most this long are summed one position at a time over all runs
# at once; a longer run takes its own sequential ``np.cumsum``
_SHORT_RUN = 32


def _run_sums_in_order(v: np.ndarray, w: np.ndarray):
    """Sorted values and their f64 weights (ties in row order) -> (unique
    values, per-unique weight sums), each sum taken in row order from 0.0
    as ``native/sketch.cc`` takes it (``np.add.reduceat`` would sum a long
    run pairwise)."""
    new = np.empty(len(v), bool)
    new[0] = True
    np.not_equal(v[1:], v[:-1], out=new[1:])
    start = np.flatnonzero(new)
    length = np.diff(np.append(start, len(v)))
    wsum = 0.0 + w[start]
    for j in range(1, min(int(length.max()), _SHORT_RUN)):
        sel = length > j
        wsum[sel] += w[start[sel] + j]
    for r in np.flatnonzero(length > _SHORT_RUN):
        wsum[r] = np.cumsum(w[start[r]:start[r] + length[r]])[-1]
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
            v = v + 0.0                 # -0.0 and +0.0 are one value
            order = np.argsort(v, kind="stable")
            uniq, wsum = _run_sums_in_order(
                v[order], weights[mask].astype(np.float64)[order])
        return FeatureSummary(uniq, wsum)

    def merge(self, other: "FeatureSummary") -> "FeatureSummary":
        """The union of two summaries: equal values' weights added."""
        if self.values.size == 0:
            return other
        if other.values.size == 0:
            return self
        v = np.concatenate([self.values, other.values])
        w = np.concatenate([self.weights, other.weights])
        order = np.argsort(v)
        return FeatureSummary(*_sorted_unique_sums(v[order], w[order]))

    def prune(self, max_size: int) -> "FeatureSummary":
        """About ``max_size`` entries at evenly spaced weighted ranks, the
        extremes kept; a dropped entry's weight goes to the kept entry at
        or after it."""
        k = self.values.size
        if k <= max_size:
            return self
        cum = np.cumsum(self.weights)
        ranks = np.linspace(0.0, cum[-1], max_size)
        idx = np.searchsorted(cum, ranks, side="left")
        idx = np.unique(np.clip(idx, 0, k - 1))
        if idx[0] != 0:
            idx = np.concatenate([[0], idx])
        if idx[-1] != k - 1:
            idx = np.concatenate([idx, [k - 1]])
        seg = np.clip(np.searchsorted(idx, np.arange(k), side="left"), 0,
                      idx.size - 1)
        w = np.bincount(seg, weights=self.weights, minlength=idx.size)
        return FeatureSummary(self.values[idx], w)


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
    observed value lands in a real bin); a categorical feature's are
    ``arange(n_cat)`` (module docstring)."""
    values: List[np.ndarray] = []
    ptrs = [0]
    min_vals = []
    for f, s in enumerate(summaries):
        if feature_types is not None and f < len(feature_types) \
                and feature_types[f] == "c":
            n_cat = int(s.values.max()) + 1 if s.values.size else 1
            values.append(np.arange(n_cat, dtype=np.float32))
            min_vals.append(-0.5)
            ptrs.append(ptrs[-1] + n_cat)
            continue
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
            cuts = np.unique(np.concatenate(
                [pts[:-1], [_last_cut(vmax)]])).astype(np.float32)
            min_vals.append(_min_val(vmin))
        values.append(cuts)
        ptrs.append(ptrs[-1] + len(cuts))
    out = (np.concatenate(values) if values
           else np.empty(0, dtype=np.float32)).astype(np.float32)
    return HistogramCuts(values=out, ptrs=np.asarray(ptrs, dtype=np.int32),
                         min_vals=np.asarray(min_vals, dtype=np.float32),
                         max_bin=max_bin, feature_types=feature_types)


# Rows used for quantile sketching of large unweighted matrices: above this
# the sketch runs on a deterministic strided row sample (the JAX package's
# setting and default, ``XTPU_SKETCH_SAMPLE_ROWS``, read once as it is; at
# 2M sampled rows the order-statistic error is ~0.2 of one 256-bin width).
# Values above the sampled maximum clamp into the last bin. 0 disables it.
# An iterator-built matrix samples each batch to a quarter of it.
SKETCH_SAMPLE_ROWS = int(os.environ.get("XTPU_SKETCH_SAMPLE_ROWS",
                                        2_000_000))


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


def _last_cut(vmax: float) -> float:
    """The last cut, strictly above the largest value (f64)."""
    return vmax + (abs(vmax) * 1e-5 + 1e-5)


def _min_val(vmin: float) -> float:
    return vmin - (abs(vmin) * 1e-5 + 1e-5)


class WeightedSketch:
    """The weighted cut rule of :func:`sketch_matrix` as torch ops on the
    device of a raw matrix X [n, F] f32 (NaN missing), for a new weight
    vector every call (``tree_method="approx"``'s hessian).

    Built once: one stable sort of every column (-0.0 as +0.0, NaN at
    the end), recording each column's order, the end of each run of equal
    values and its value in f64. :meth:`cuts`: the weights gathered in
    sorted order as f64, their running sum read at each run's end (the
    cumulative weight of each distinct value), the ranks ``(i / max_bin)
    * total`` for i = 1..max_bin found with ``searchsorted`` on the left,
    clamped and their repeats dropped, the last point replaced by the
    ``last`` cut; no sort. A feature with at most ``max_bin`` distinct
    values keeps them all, a categorical one ``arange(n_cat)``, an empty
    one ``[inf]``. The running sum is taken over the positions rather
    than value by value; where the sums are exact (module docstring) that
    gives the host sketch's bits."""

    def __init__(self, X: torch.Tensor, max_bin: int,
                 feature_types: Optional[List[str]] = None) -> None:
        n, F = X.shape
        dev = X.device
        self.max_bin = max_bin
        self.feature_types = feature_types
        self.n_features = F
        vals, order = torch.sort(X.t() + 0.0, dim=1, stable=True)  # [F, n]
        self.order = order
        n_valid = (~torch.isnan(vals)).sum(dim=1)                   # [F]
        pos = torch.arange(n, device=dev)
        self.valid = pos[None, :] < n_valid[:, None]
        end = self.valid.clone()
        if n > 1:
            end[:, :-1] &= (vals[:, 1:] != vals[:, :-1]) | ~self.valid[:, 1:]
        k = end.sum(dim=1)                                          # [F]
        R = max(int(k.max()) if n else 0, 1)
        f_idx, p_idx = end.nonzero(as_tuple=True)
        slot = torch.cumsum(end.to(torch.int64), dim=1)[f_idx, p_idx] - 1
        self.ends = torch.zeros((F, R), dtype=torch.int64, device=dev)
        self.ends[f_idx, slot] = p_idx
        self.uniq = torch.full((F, R), float("inf"), dtype=torch.float64,
                               device=dev)
        self.uniq[f_idx, slot] = vals[f_idx, p_idx].double()
        self.k = k
        self.pad = torch.arange(R, device=dev)[None, :] >= k[:, None]
        k_h = k.cpu().numpy()
        first = self.uniq[:, 0].cpu().numpy()
        last = self.uniq.gather(
            1, (k - 1).clamp(min=0)[:, None])[:, 0].cpu().numpy()
        self.last = torch.tensor(
            [_last_cut(float(last[f])) if k_h[f] else float("inf")
             for f in range(F)], dtype=torch.float32, device=dev)
        self.min_vals = np.asarray(
            [_min_val(float(first[f])) if k_h[f] else 0.0
             for f in range(F)], np.float32)
        # categorical features: cuts arange(n_cat) whatever the weights
        is_cat = np.asarray([feature_types is not None
                             and f < len(feature_types)
                             and feature_types[f] == "c" for f in range(F)])
        cat = np.flatnonzero(is_cat)
        n_cat = np.asarray([int(last[f]) + 1 if k_h[f] else 1 for f in cat],
                           np.int64)
        self.min_vals[cat] = -0.5
        self.width = int(max([max_bin] + n_cat.tolist()))
        cat_table = np.full((len(cat), self.width), np.inf, np.float32)
        for i, c in enumerate(n_cat):
            cat_table[i, :c] = np.arange(c, dtype=np.float32)
        self.cat = torch.from_numpy(cat).to(dev)
        self.cat_table = torch.from_numpy(cat_table).to(dev)
        self.cat_count = torch.from_numpy(n_cat).to(dev)

    def cuts(self, weights: torch.Tensor):
        """Weights [n] (any float dtype, on the sketch's device) ->
        (``HistogramCuts`` on the host, the cut table [F, W] f32 padded
        with +inf and the real-bin counts [F] int64, both on the
        device)."""
        F, dev, mb = self.n_features, self.order.device, self.max_bin
        w = weights.to(torch.float64)[self.order]                   # [F, n]
        w = torch.where(self.valid, w, torch.zeros_like(w))
        cum = torch.cumsum(w, dim=1).gather(1, self.ends)           # [F, R]
        cum = torch.where(self.pad, torch.full_like(cum, float("inf")), cum)
        total = cum.gather(1, (self.k - 1).clamp(min=0)[:, None])
        ranks = (torch.arange(1, mb + 1, dtype=torch.float64, device=dev)
                 / mb)[None, :] * total                             # [F, mb]
        idx = torch.searchsorted(cum, ranks, side="left")
        top = (self.k - 1).clamp(min=0)[:, None]
        every = torch.arange(mb, device=dev)[None, :]
        idx = torch.where((self.k <= mb)[:, None], every, idx)
        idx = torch.minimum(idx, top)
        keep = torch.ones_like(idx, dtype=torch.bool)
        keep[:, 1:] = idx[:, 1:] != idx[:, :-1]
        count = keep.sum(dim=1)
        slot = torch.where(keep, torch.cumsum(keep.to(torch.int64), 1) - 1,
                           torch.full_like(idx, self.width))
        table = torch.full((F, self.width + 1), float("inf"),
                           dtype=torch.float32, device=dev)
        table.scatter_(1, slot, self.uniq.gather(1, idx).float())
        table = table[:, :self.width].contiguous()
        table.scatter_(1, (count - 1)[:, None], self.last[:, None])
        if len(self.cat):
            table[self.cat] = self.cat_table
            count[self.cat] = self.cat_count
        table_h, count_h = table.cpu().numpy(), count.cpu().numpy()
        ptrs = np.zeros(F + 1, np.int32)
        ptrs[1:] = np.cumsum(count_h)
        values = (np.concatenate([table_h[f, :count_h[f]] for f in range(F)])
                  if F else np.empty(0, np.float32))
        cuts = HistogramCuts(values=values.astype(np.float32), ptrs=ptrs,
                             min_vals=self.min_vals.copy(), max_bin=mb,
                             feature_types=self.feature_types)
        return cuts, table, count
