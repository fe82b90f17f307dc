"""Quantized bin matrix resident on the device (resident form only).

The port of the JAX package's ``data/binned.py BinnedMatrix``: a dense
``[n_rows, n_features]`` tensor of LOCAL bin ids with a uniform slot
count ``max_nbins = max_f n_real_bins(f) + has_missing``; when the data
holds a NaN, slot ``max_nbins - 1`` of every feature is its missing bin.
Bins are uint8 while the largest id fits a byte and uint16 above, the
layout policy of ``_matrix_layout`` / ``_dtype_for`` (so 256 real bins
plus a missing slot is uint16). Binning runs on the device:
``torch.searchsorted(side="left")`` against each feature's cuts, clamped
into the last real bin, NaN -> the missing bin. Paged external memory
waits with ROADMAP A.7.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .quantile import HistogramCuts


def _dtype_for(max_local_bins: int) -> torch.dtype:
    if max_local_bins <= np.iinfo(np.uint8).max:
        return torch.uint8
    if max_local_bins <= np.iinfo(np.uint16).max:
        return torch.uint16
    return torch.int32


def padded_cuts(cuts: HistogramCuts) -> np.ndarray:
    """[F, max real bins] f32 cut table, each row padded with +inf."""
    n_real = cuts.n_real_bins()
    F = cuts.n_features
    table = np.full((F, max(int(n_real.max(initial=0)), 1)), np.inf,
                    np.float32)
    for f in range(F):
        lo, hi = int(cuts.ptrs[f]), int(cuts.ptrs[f + 1])
        table[f, :hi - lo] = cuts.values[lo:hi]
    return table


def search_bin(X: torch.Tensor, cuts: HistogramCuts,
               missing_bin: int) -> torch.Tensor:
    """[n, F] f32 on any device -> [n, F] int64 local bin ids; NaN ->
    ``missing_bin``. Equal to ``HistogramCuts.search_bin`` (numpy) with the
    missing value mapped, on the device of ``X``."""
    table = torch.from_numpy(padded_cuts(cuts)).to(X.device)
    Xt = X.t().contiguous()                                  # [F, n]
    b = torch.searchsorted(table, Xt, side="left")           # [F, n]
    last = torch.from_numpy(cuts.n_real_bins().astype(np.int64) - 1).to(
        X.device)
    b = torch.minimum(b, last[:, None])
    b = torch.where(torch.isnan(Xt), torch.full_like(b, missing_bin), b)
    return b.t()


@dataclass
class BinnedMatrix:
    """Quantized feature matrix resident on the device.

    ``bins``: [n_rows, n_features] local bin ids (uint8/uint16/int32);
    when ``has_missing``, value ``max_nbins - 1`` means missing. Without
    missing values ``missing_bin`` is the out-of-range sentinel
    ``max_nbins`` that no row matches.
    """

    bins: torch.Tensor
    cuts: HistogramCuts
    max_nbins: int
    has_missing: bool = True

    @property
    def missing_bin(self) -> int:
        return self.max_nbins - 1 if self.has_missing else self.max_nbins

    @staticmethod
    def from_dense(X: np.ndarray, cuts: HistogramCuts,
                   device: torch.device) -> "BinnedMatrix":
        """Bin a dense f32 numpy matrix on ``device``."""
        Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(
            device)
        has_missing = bool(torch.isnan(Xd).any())
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(has_missing)
        missing = max(max_nbins - 1, 0)
        b = search_bin(Xd, cuts, missing)
        bins = b.to(_dtype_for(max(max_nbins - 1, 0))).contiguous()
        return BinnedMatrix(bins=bins, cuts=cuts, max_nbins=max_nbins,
                            has_missing=has_missing)
