"""Histogram building: ``build_hist``'s dispatch and the plain versions of
kernels K2, K3 and K4.

Output layout, as in the JAX package's ``ops/histogram.py``: dense
``[n_nodes, n_features, max_nbins, 2]`` (g, h) sums over the padded bin
layout of ``data/binned.py``. A row with ``rel_pos == n_nodes`` is
inactive.

Every ``hist_method`` maps to one of two functions, built by three
kernels:

- **int8x2** (K2 and K4): the gradients are quantised to 15-bit fixed
  point with one scale per component, ``scale = 32512 / max|g|`` and
  ``q = round(g * scale)`` (half to even), exactly as ``build_hist_prehot``
  does. Each q is split into ``hi = (q + 128) >> 8`` and
  ``lo = q - 256 * hi``; the four planes (g_hi, h_hi, g_lo, h_lo) are
  summed as exact int32 integers and dequantised once as
  ``(f32(sum hi) * 256 + f32(sum lo)) * inv``, with ``inv`` rounded as
  the JAX package's compiled program rounds it: ``max|g| * f32(1/32512)``.
  Integer sums do not depend on row order, so this equals ``prehot`` bit
  for bit. (The TPU's unsorted kernel adds 2048-row blocks in f32, so it
  equals this only while the per-bin sums stay below 2^24; its sorted
  kernel sums in int32 throughout and equals it at every size.)
  K2 (``pallas``, ``pallas:int8x2``, ``prehot``) scatters rows in their
  own order; K4 counting-sorts them by node first, as the TPU's
  ``scan_hist_pallas`` does, so that one node's counters fit one
  shared-memory tile at any level width.
- **f32** (K3; ``pallas:f32``, ``segment``, ``onehot``): each component is
  scaled by a power of two ``2^k`` chosen so that
  ``n * max|x| * 2^k <= 2^62``, rounded to int64, summed exactly in int64
  and converted to f32 once. The result is deterministic and within about
  one f32 rounding of the exact sum, which no f32 summation order
  guarantees.

``auto`` takes the kernel that the TPU's ``auto`` runs at the same level,
on every device: the sorted build (K4) where the JAX package promotes
``auto`` to its scan schedule (``tree/grow.py auto_selects_coarse``: at
least 65,536 rows and 128 to 256 real bins) and the level has at most 128
nodes; K2 at the other levels of at most 128 nodes; K3 above 128 nodes,
where the TPU builds in f32 too. The port keeps the exact split search
at every level; the TPU's scan schedule also narrows the search to a
coarse-then-refined window (ROADMAP A.6), which the port does not do.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel in
``csrc/hist.cu`` runs (``ops/cuda/hist.py``) or the call raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# int32 accumulation of the int8x2 planes is exact while n * 128 < 2^31
# (the JAX package's guard, ops/histogram.py:356): |hi|, |lo| <= 128
INT8X2_MAX_ROWS = (2 ** 31 - 1) // 128

_INV_32512 = float(np.float32(1.0 / 32512.0))

_K2_METHODS = ("pallas", "pallas:int8x2", "prehot")
_K3_METHODS = ("pallas:f32", "segment", "onehot")

# the JAX package's promotion of ``auto`` to its sorted (scan) schedule,
# ``tree/grow.py AUTO_COARSE_MIN_ROWS`` / ``AUTO_COARSE_MIN_BINS``
AUTO_SCAN_MIN_ROWS = 1 << 16
AUTO_SCAN_MIN_BINS = 128


def int8x2_fits(n_rows: int) -> bool:
    """The int8x2 overflow guard: True when n_rows * 128 < 2^31."""
    return n_rows * 128 < 2 ** 31


def auto_selects_scan(n_rows: int, max_nbins: int,
                      has_missing: bool) -> bool:
    """True where the JAX package's ``auto`` runs the sorted build
    (``tree/grow.py auto_selects_coarse`` for numeric row-split data,
    without its backend test: the port follows the TPU's choice)."""
    return (max_nbins <= 256 + int(has_missing)
            and max_nbins - int(has_missing) >= AUTO_SCAN_MIN_BINS
            and n_rows >= AUTO_SCAN_MIN_ROWS)


def resolve_hist_kernel(method: str, n_rows: int, n_nodes: int,
                        max_nbins: int, has_missing: bool = True) -> str:
    """``hist_method`` -> ``"scan"`` (K4), ``"int8x2"`` (K2) or ``"f32"``
    (K3).

    ``auto`` follows the TPU's choice on every device (module docstring);
    the int32 overflow guard sends it to K3. ``prehot`` above the guard
    falls back to the f32 build as the JAX package's does; ``pallas`` /
    ``pallas:int8x2`` there refuse rather than wrap."""
    base = method[:-len("+nosub")] if method.endswith("+nosub") else method
    if base == "auto":
        if n_nodes > 128 or not int8x2_fits(n_rows):
            return "f32"
        if auto_selects_scan(n_rows, max_nbins, has_missing):
            return "scan"
        return "int8x2"
    if base == "prehot":
        return "int8x2" if int8x2_fits(n_rows) else "f32"
    if base in _K2_METHODS:
        if not int8x2_fits(n_rows):
            raise ValueError(
                f"hist_method={method!r}: {n_rows} rows overflow the int32 "
                f"int8x2 counters (limit {INT8X2_MAX_ROWS} rows); use "
                "'auto', 'prehot' or an f32 method")
        return "int8x2"
    if base in _K3_METHODS:
        return "f32"
    if base in ("pallas:bf16x2", "pallas:bf16"):
        raise NotImplementedError(
            f"hist_method={method!r} is not in the PyTorch port yet "
            "(K3's bf16 variants, ROADMAP B.2)")
    if base in ("scan", "coarse", "fused", "mega") or method.endswith("+sub"):
        raise NotImplementedError(
            f"hist_method={method!r} is not in the PyTorch port yet "
            "(the two-level schedules and sibling subtraction, "
            "ROADMAP A.6)")
    raise ValueError(f"unknown hist method {method!r}")


# ---- K2: int8x2 ------------------------------------------------------------

def quantise_int8x2(gpair: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gpair [n, 2] f32 -> (q [n, 2] int32, inv [2] f32): the fixed-point
    quantisation of ``build_hist_prehot`` (``ops/histogram.py:264-269``)
    and its dequantisation factor."""
    if gpair.shape[0] == 0:
        max_abs = torch.zeros(2, dtype=torch.float32, device=gpair.device)
    else:
        max_abs = gpair.abs().amax(dim=0)
    max_abs = torch.clamp(max_abs, min=1e-30)
    # a true f32 division (a Python number over a tensor would go through
    # the reciprocal and round differently)
    scale = torch.full_like(max_abs, 32512.0) / max_abs
    q = torch.round(gpair * scale[None, :]).to(torch.int32)
    # XLA's algebraic simplifier rewrites the JAX package's 1 / (32512 /
    # m) as m * f32(1 / 32512); this is that rounding, not f32(1 / scale)
    inv = max_abs * _INV_32512
    return q.contiguous(), inv.contiguous()


def _segments(bins: torch.Tensor, rel: torch.Tensor, n_nodes: int,
              max_nbins: int):
    """(flat (node, feature, bin) cell of every active (row, feature),
    active-row mask)."""
    n, F = bins.shape
    active = (rel >= 0) & (rel < n_nodes)
    seg = (rel.long()[:, None] * (F * max_nbins)
           + torch.arange(F, device=bins.device)[None, :] * max_nbins
           + bins.long())
    return seg[active].reshape(-1), active


def build_hist_int8x2_reference(bins: torch.Tensor, q: torch.Tensor,
                                rel: torch.Tensor, inv: torch.Tensor,
                                n_nodes: int, max_nbins: int) -> torch.Tensor:
    """Plain version of K2: exact int32 sums of the hi/lo planes by
    ``index_add_``, then the dequantisation of ``:282-285``."""
    n, F = bins.shape
    seg, active = _segments(bins, rel, n_nodes, max_nbins)
    hi = (q + 128) >> 8
    lo = q - hi * 256
    planes = torch.stack([hi[:, 0], hi[:, 1], lo[:, 0], lo[:, 1]], dim=1)
    vals = planes[active][:, None, :].expand(-1, F, 4).reshape(-1, 4)
    acc = torch.zeros((n_nodes * F * max_nbins, 4), dtype=torch.int32,
                      device=bins.device)
    acc.index_add_(0, seg, vals)
    out = acc[:, :2].to(torch.float32) * 256.0 + acc[:, 2:].to(torch.float32)
    out = out * inv[None, :]
    return out.reshape(n_nodes, F, max_nbins, 2)


# ---- K4: int8x2 over rows sorted by node ------------------------------------

def counting_sort_by_node(rel: torch.Tensor, n_nodes: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The active rows grouped by node, node 0's first, each node's rows
    in their own order (the JAX package's ``ops/partition.py
    counting_sort_by_node`` without its inactive tail): ``(perm [m]
    int64, offsets [n_nodes + 1] int64)`` with node k's rows at
    ``perm[offsets[k]:offsets[k + 1]]`` and ``m = offsets[n_nodes]``."""
    key = torch.where((rel >= 0) & (rel < n_nodes), rel.long(),
                      torch.full_like(rel, n_nodes, dtype=torch.int64))
    counts = torch.bincount(key, minlength=n_nodes + 1)[:n_nodes]
    offsets = torch.zeros(n_nodes + 1, dtype=torch.int64, device=rel.device)
    offsets[1:] = torch.cumsum(counts, 0)
    perm = torch.argsort(key, stable=True)[:int(offsets[-1])]
    return perm, offsets


def build_hist_scan_reference(bins: torch.Tensor, q: torch.Tensor,
                              rel: torch.Tensor, inv: torch.Tensor,
                              n_nodes: int, max_nbins: int) -> torch.Tensor:
    """Plain version of K4: the rows counting-sorted by node, then K2's
    plain version over the sorted rows. Integer sums: equal to
    ``build_hist_int8x2_reference`` on the unsorted rows bit for bit."""
    perm, offsets = counting_sort_by_node(rel, n_nodes)
    node = torch.repeat_interleave(
        torch.arange(n_nodes, device=rel.device), offsets.diff())
    # int32 ids: PyTorch's CUDA gather has no uint16
    return build_hist_int8x2_reference(bins.to(torch.int32)[perm], q[perm],
                                       node.to(torch.int32), inv, n_nodes,
                                       max_nbins)


# ---- K3: f32 through exact int64 fixed point -------------------------------

def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for integer k in [-126, 127], built from its bits."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def fixed_point_scale(gpair: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """gpair [n, 2] f32 -> (2^k, 2^-k), [2] f32 each, per component:
    the largest power of two with ``n * max|x| * 2^k <= 2^62``, so that no
    int64 sum of the scaled, rounded values can overflow. k is clamped to
    [-100, 100], where both factors are normal f32 numbers: values below
    the quantum 2^-100 (~8e-31) round to zero."""
    n = gpair.shape[0]
    if n == 0:
        max_abs = torch.zeros(2, dtype=torch.float32, device=gpair.device)
    else:
        max_abs = gpair.abs().amax(dim=0)
    # max|x| < 2^e with e the f32 exponent field minus 126 (subnormals and
    # zero read as e = -126, still an upper bound)
    e = ((max_abs.view(torch.int32) >> 23) & 0xFF) - 126
    log2_n = max(n - 1, 0).bit_length()                  # n <= 2^log2_n
    k = torch.clamp(62 - log2_n - e, -100, 100)
    return _pow2(k).contiguous(), _pow2(-k).contiguous()


def build_hist_f32_reference(bins: torch.Tensor, gpair: torch.Tensor,
                             rel: torch.Tensor, qscale: torch.Tensor,
                             inv: torch.Tensor, n_nodes: int,
                             max_nbins: int) -> torch.Tensor:
    """Plain version of K3: ``round(x * 2^k)`` to int64, exact int64 sums
    by ``index_add_``, one conversion to f32, times ``2^-k``."""
    n, F = bins.shape
    seg, active = _segments(bins, rel, n_nodes, max_nbins)
    q = torch.round(gpair * qscale[None, :]).to(torch.int64)
    vals = q[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    acc = torch.zeros((n_nodes * F * max_nbins, 2), dtype=torch.int64,
                      device=bins.device)
    acc.index_add_(0, seg, vals)
    out = acc.to(torch.float32) * inv[None, :]
    return out.reshape(n_nodes, F, max_nbins, 2)


# ---- dispatch ----------------------------------------------------------------

def build_hist(bins: torch.Tensor, gpair: torch.Tensor, rel_pos: torch.Tensor,
               n_nodes: int, max_nbins: int, method: str = "auto",
               has_missing: bool = True) -> torch.Tensor:
    """bins [n, F] uint8/uint16/int32; gpair [n, 2] f32; rel_pos [n]
    int32 in [0, n_nodes] -> [n_nodes, F, max_nbins, 2] f32.
    ``has_missing``: the last bin slot is the missing slot (it feeds
    ``auto``'s choice only)."""
    kernel = resolve_hist_kernel(method, bins.shape[0], n_nodes, max_nbins,
                                 has_missing)
    rel = rel_pos.to(torch.int32).contiguous()
    on_cpu = bins.device.type == "cpu"
    if kernel in ("int8x2", "scan"):
        q, inv = quantise_int8x2(gpair)
        if on_cpu:
            plain = (build_hist_scan_reference if kernel == "scan"
                     else build_hist_int8x2_reference)
            return plain(bins, q, rel, inv, n_nodes, max_nbins)
        from .cuda.hist import hist_int8x2_cuda, hist_scan_cuda

        cuda = hist_scan_cuda if kernel == "scan" else hist_int8x2_cuda
        return cuda(bins, q, rel, inv, n_nodes, max_nbins)
    qscale, inv = fixed_point_scale(gpair)
    if on_cpu:
        return build_hist_f32_reference(bins, gpair, rel, qscale, inv,
                                        n_nodes, max_nbins)
    from .cuda.hist import hist_f32_cuda

    return hist_f32_cuda(bins, gpair.contiguous(), rel, qscale, inv, n_nodes,
                         max_nbins)
