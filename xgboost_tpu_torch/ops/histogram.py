"""Histogram building: ``build_hist``'s dispatch, the two-level
schedules' level sweeps, and the plain versions of kernels K2, K3, K4
and K5.

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
  K2 (``pallas``, ``pallas:int8x2``, ``prehot``) and K4 (the TPU's
  sorted ``scan_hist_pallas``) run the same kernel on the card, rows in
  their order where a level fits one tile, sorted by node where it does
  not; K4 also folds the coarse histogram from its integer sums.
- **f32** (K3; ``pallas:f32``, ``segment``, ``onehot``): each component is
  scaled by a power of two ``2^k`` chosen so that
  ``n * max|x| * 2^k <= 2^62``, rounded to int64, summed exactly in int64
  and converted to f32 once. The result is deterministic and within about
  one f32 rounding of the exact sum, which no f32 summation order
  guarantees.
- **bf16** and **bf16x2** (K3's other precisions; ``pallas:bf16``,
  ``pallas:bf16x2``): each row's (g, h) is first rounded to bfloat16
  (round to nearest even, as the TPU kernel's ``astype(bfloat16)``):
  ``hi = bf16(x)``, and for bf16x2 also ``lo = bf16(x - hi)``. Each
  rounded value is then summed as K3 sums a value (``round(v * 2^k)`` in
  int64, ``2^k`` from the unrounded gradients); a row's ``hi`` and
  ``lo`` go into the same int64 sum, which is converted to f32 once. The
  TPU kernel instead adds the rounded values in f32 on its matrix unit,
  1,024 rows a block under bf16x2, so it agrees with this to the f32
  rounding of its block sums.

``auto`` takes the kernel that the TPU's ``auto`` runs at the same level,
on every device: the sorted build (K4) where the JAX package promotes
``auto`` to its scan schedule (``tree/grow.py auto_selects_coarse``: at
least 65,536 rows, 128 to 256 real bins and numeric features only) and
the level has at most 128 nodes; K2 at the other levels of at most 128
nodes; K3 above 128 nodes, where the TPU builds in f32 too. A matrix
with a categorical feature never takes the sorted build: its ``auto``
runs K2 and K3, and ``coarse``, ``fused`` and ``scan`` refuse it, as the
JAX package's do. ``auto`` keeps the exact split search
over every bin. The TPU's schedule also narrows the search to a
coarse-then-refined window; in the port that search is opt-in, as the
``hist_method`` values ``coarse``, ``fused`` and ``scan``
(``tree/grow.py``), which build their histograms here:

- ``coarse``: every level's 20-slot coarse histogram and 36-slot refine
  histogram through ``auto`` (K2, or K3 above 128 nodes);
- ``fused``: the same, but at each level boundary of at most 128 nodes
  one pass (kernel K5, :func:`fused_advance_coarse`) advances the rows
  below the previous level's splits and builds the new level's coarse
  histogram;
- ``scan``: one sorted build (K4) of each level's fine histogram, with
  the coarse histogram folded from its int32 sums (:func:`coarse_fold`,
  in K4's epilogue on the card) and the refine histogram sliced from the
  fine one; above 128 nodes K3 builds the fine and the coarse histogram.

All three sum the same integers (or, through K3, the same int64 fixed
point), so they grow the same trees bit for bit.

``packed_u4=F`` (the external-memory tier's compressed pages, at most 16
bin slots): ``bins`` is a u4-packed page [n, ceil(F/2)] uint8 (feature f
in byte f // 2, the low nibble for even f; :func:`unpack_u4` decodes
it). On the card K2 and K3 read the packed page themselves (their
``packed_u4`` bodies); the plain versions unpack it first
(:func:`build_hist_int8x2_u4_reference`,
:func:`build_hist_f32_u4_reference`). K4 has no such body in the JAX
package and ``auto`` never sends at most 16 bins to it, so ``scan`` on a
packed page raises.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel in
``csrc/hist.cu`` runs (``ops/cuda/hist.py``) or the call raises.

Under a data mesh (``tree/grow.py RowShards``) each shard builds its
rows' histogram and the growers sum the shards' f32 partials. Every
shard must quantise alike, so the scales come from outside: ``max_abs``
[2] f32 is ``max|g|`` and ``max|h|`` reduced over every shard (the JAX
package's ``pmax`` of the scale in each wrapper,
``ops/pallas/histogram.py:333-334``, ``:463-464``, ``:613-614``,
``ops/histogram.py:266-267``), and ``total_rows`` the rows of every
shard, which K3's fixed-point exponent bounds. Without them (one
device) each build takes its own rows' scale, as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .cuda.hist import K3_KERNELS
from .partition import LevelSplits, advance_level, level_rel
from .split import COARSE_B, COARSE_SPAN, coarse_bin_ids

# int32 accumulation of the int8x2 planes is exact while n * 128 < 2^31
# (the JAX package's guard, ops/histogram.py:356): |hi|, |lo| <= 128
INT8X2_MAX_ROWS = (2 ** 31 - 1) // 128

_INV_32512 = float(np.float32(1.0 / 32512.0))

_K2_METHODS = ("pallas", "pallas:int8x2", "prehot")
_K3_METHODS = ("segment", "onehot")

# the JAX package's promotion of ``auto`` to its sorted (scan) schedule,
# ``tree/grow.py AUTO_COARSE_MIN_ROWS`` / ``AUTO_COARSE_MIN_BINS``
AUTO_SCAN_MIN_ROWS = 1 << 16
AUTO_SCAN_MIN_BINS = 128


def int8x2_fits(n_rows: int) -> bool:
    """The int8x2 overflow guard: True when n_rows * 128 < 2^31."""
    return n_rows * 128 < 2 ** 31


def auto_selects_scan(n_rows: int, max_nbins: int, has_missing: bool,
                      numeric: bool = True, col_split: bool = False) -> bool:
    """True where the JAX package's ``auto`` runs the sorted build
    (``tree/grow.py auto_selects_coarse``, without its backend test: the
    port follows the TPU's choice). ``numeric``: no feature is
    categorical; ``col_split``: features sharded (a column mesh or
    vertical parties), where it never does."""
    return (numeric and not col_split and max_nbins <= 256 + int(has_missing)
            and max_nbins - int(has_missing) >= AUTO_SCAN_MIN_BINS
            and n_rows >= AUTO_SCAN_MIN_ROWS)


def refuse_categorical_two_level(method: str) -> None:
    """The two-level schedules take numeric features only: raise for
    ``coarse`` / ``fused`` / ``scan`` (the JAX package's ``tree/grow.py``
    raise for categorical features)."""
    raise NotImplementedError(
        f"hist_method={method!r} supports numeric features and max_bin <= "
        "256; a matrix with categorical features trains with 'auto'")


def resolve_hist_kernel(method: str, n_rows: int, n_nodes: int,
                        max_nbins: int, has_missing: bool = True,
                        numeric: bool = True, col_split: bool = False) -> str:
    """``hist_method`` -> ``"scan"`` (K4), ``"int8x2"`` (K2), ``"f32"``
    (K3), or ``"bf16x2"`` / ``"bf16"`` (K3 on rows rounded to bfloat16,
    at every level, as the JAX package's ``pallas:bf16x2`` /
    ``pallas:bf16``).

    ``auto`` follows the TPU's choice on every device (module docstring);
    the int32 overflow guard sends it to K3. ``coarse`` and ``fused``
    build every histogram of a level through ``auto``. ``scan`` builds a
    level's fine histogram with K4 at up to 128 nodes within the guard,
    with K3 elsewhere. ``prehot`` above the guard falls back to the f32
    build as the JAX package's does; ``pallas`` / ``pallas:int8x2`` there
    refuse rather than wrap. ``numeric=False`` (a categorical feature):
    ``auto`` never takes K4, and ``coarse``, ``fused`` and ``scan``
    raise. ``col_split`` (feature-sharded bins): ``auto`` never takes K4
    either."""
    base = method[:-len("+nosub")] if method.endswith("+nosub") else method
    if not numeric and base in ("coarse", "fused", "scan"):
        refuse_categorical_two_level(method)
    if base == "scan":
        return "scan" if n_nodes <= 128 and int8x2_fits(n_rows) else "f32"
    if base in ("auto", "coarse", "fused"):
        if n_nodes > 128 or not int8x2_fits(n_rows):
            return "f32"
        if auto_selects_scan(n_rows, max_nbins, has_missing, numeric,
                             col_split):
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
    if base.startswith("pallas:") and base[len("pallas:"):] in K3_KERNELS:
        return base[len("pallas:"):]       # pallas:f32 / :bf16 / :bf16x2
    if base == "mega" or method.endswith("+sub"):
        raise NotImplementedError(
            f"hist_method={method!r} is not in the PyTorch port yet "
            "(the mega schedule and sibling subtraction, ROADMAP A.6)")
    raise ValueError(f"unknown hist method {method!r}")


# ---- u4-packed pages --------------------------------------------------------

def unpack_u4(packed: torch.Tensor, n_features: int) -> torch.Tensor:
    """A u4-packed page [p, ceil(F/2)] uint8 -> its [p, F] uint8 bin ids:
    byte w holds feature 2w in its low nibble and feature 2w+1 in its
    high nibble (the JAX package's ``unpack_u4``)."""
    lo = packed & 0x0F
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)
    return out[:, :n_features].contiguous()


# ---- K2: int8x2 ------------------------------------------------------------

def abs_max(gpair: torch.Tensor) -> torch.Tensor:
    """max|x| of each component of gpair [n, 2] (0 without rows) -> [2]
    f32: the quantisers' scale before any reduction over shards."""
    if gpair.shape[0] == 0:
        return torch.zeros(gpair.shape[1:], dtype=torch.float32,
                           device=gpair.device)
    return gpair.abs().amax(dim=0)


def quantise_int8x2(gpair: torch.Tensor,
                    max_abs: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gpair [n, 2] f32 -> (q [n, 2] int32, inv [2] f32): the fixed-point
    quantisation of ``build_hist_prehot`` (``ops/histogram.py:264-269``)
    and its dequantisation factor. ``max_abs`` [2]: the scale reduced
    over a mesh's shards (module docstring), else this gpair's own."""
    if max_abs is None:
        max_abs = abs_max(gpair)
    max_abs = torch.clamp(max_abs.to(gpair.device), min=1e-30)
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


def int8x2_planes(q: torch.Tensor) -> torch.Tensor:
    """q [n, 2] int32 -> the four byte planes [n, 4] int32 (g_hi, h_hi,
    g_lo, h_lo): ``hi = (q + 128) >> 8`` (round to nearest),
    ``lo = q - 256 * hi`` in [-128, 127]."""
    hi = (q + 128) >> 8
    lo = q - hi * 256
    return torch.stack([hi[:, 0], hi[:, 1], lo[:, 0], lo[:, 1]], dim=1)


def int8x2_acc_reference(bins: torch.Tensor, q: torch.Tensor,
                         rel: torch.Tensor, n_nodes: int,
                         max_nbins: int) -> torch.Tensor:
    """Exact int32 sums of the four planes by (node, feature, bin):
    [n_nodes, F, max_nbins, 4] int32, by ``index_add_``."""
    n, F = bins.shape
    seg, active = _segments(bins, rel, n_nodes, max_nbins)
    vals = int8x2_planes(q)[active][:, None, :].expand(-1, F, 4).reshape(
        -1, 4)
    acc = torch.zeros((n_nodes * F * max_nbins, 4), dtype=torch.int32,
                      device=bins.device)
    acc.index_add_(0, seg, vals)
    return acc.reshape(n_nodes, F, max_nbins, 4)


def dequant_int8x2(acc: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """[..., 4] int32 plane sums -> [..., 2] f32:
    ``(f32(sum hi) * 256 + f32(sum lo)) * inv`` (``:282-285``), one
    rounding for the add and one for the product, as the kernels do."""
    out = (acc[..., :2].to(torch.float32) * 256.0
           + acc[..., 2:].to(torch.float32))
    return out * inv


def build_hist_int8x2_reference(bins: torch.Tensor, q: torch.Tensor,
                                rel: torch.Tensor, inv: torch.Tensor,
                                n_nodes: int, max_nbins: int) -> torch.Tensor:
    """Plain version of K2: exact int32 sums of the hi/lo planes, then
    the dequantisation."""
    return dequant_int8x2(
        int8x2_acc_reference(bins, q, rel, n_nodes, max_nbins), inv)


def build_hist_int8x2_u4_reference(packed: torch.Tensor, n_features: int,
                                   q: torch.Tensor, rel: torch.Tensor,
                                   inv: torch.Tensor, n_nodes: int,
                                   max_nbins: int) -> torch.Tensor:
    """Plain version of K2's ``packed_u4`` body: :func:`unpack_u4`, then
    K2's plain version."""
    return build_hist_int8x2_reference(unpack_u4(packed, n_features), q, rel,
                                       inv, n_nodes, max_nbins)


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


def scan_acc_reference(bins: torch.Tensor, q: torch.Tensor,
                       rel: torch.Tensor, n_nodes: int,
                       max_nbins: int) -> torch.Tensor:
    """K4's int32 accumulators [n_nodes, F, max_nbins, 4]: the rows
    counting-sorted by node, then K2's plain sums over the sorted rows.
    Integer sums: equal to ``int8x2_acc_reference`` on the unsorted rows."""
    perm, offsets = counting_sort_by_node(rel, n_nodes)
    node = torch.repeat_interleave(
        torch.arange(n_nodes, device=rel.device), offsets.diff())
    # int32 ids: PyTorch's CUDA gather has no uint16
    return int8x2_acc_reference(bins.to(torch.int32)[perm], q[perm],
                                node.to(torch.int32), n_nodes, max_nbins)


def build_hist_scan_reference(bins: torch.Tensor, q: torch.Tensor,
                              rel: torch.Tensor, inv: torch.Tensor,
                              n_nodes: int, max_nbins: int) -> torch.Tensor:
    """Plain version of K4: ``scan_acc_reference`` dequantised; equal to
    ``build_hist_int8x2_reference`` bit for bit."""
    return dequant_int8x2(scan_acc_reference(bins, q, rel, n_nodes,
                                             max_nbins), inv)


def coarse_fold(acc: torch.Tensor, missing_bin: int) -> torch.Tensor:
    """Plain version of K4's ``with_coarse`` fold
    (``ops/pallas/histogram.py:493-513``), which the kernel takes in its
    epilogue: fine plane sums [N, F, B, 4] int32 -> coarse ones
    [N, F, COARSE_B, 4] int32. The missing slot is zeroed, a prefix sum
    over bins taken, and ``COARSE_SPAN``-wide slice differences give the
    16 real slots; 3 zero pad slots follow and the missing mass goes to
    slot ``COARSE_B - 1`` (zero without a missing slot, ``missing_bin >=
    B``). These are the integers of a direct build over
    ``coarse_bin_ids``, so dequantised with the same ``inv`` they equal it
    bit for bit."""
    N, F, B, _ = acc.shape
    miss = torch.zeros((N, F, 1, 4), dtype=torch.int64, device=acc.device)
    accz = acc.to(torch.int64, copy=True)
    if missing_bin < B:
        miss = accz[:, :, missing_bin:missing_bin + 1].clone()
        accz[:, :, missing_bin] = 0
    cz = torch.cat([torch.zeros_like(miss), torch.cumsum(accz, dim=2)], dim=2)
    edges = (torch.arange(17, device=acc.device) * COARSE_SPAN).clamp(max=B)
    real = cz[:, :, edges[1:]] - cz[:, :, edges[:-1]]       # [N, F, 16, 4]
    pad = torch.zeros((N, F, COARSE_B - 17, 4), dtype=torch.int64,
                      device=acc.device)
    return torch.cat([real, pad, miss], dim=2).to(torch.int32)


# ---- K3: f32 through exact int64 fixed point -------------------------------

def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for integer k in [-126, 127], built from its bits."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def fixed_point_scale(gpair: torch.Tensor,
                      max_abs: Optional[torch.Tensor] = None,
                      total_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gpair [n, 2] f32 -> (2^k, 2^-k), [2] f32 each, per component:
    the largest power of two with ``n * max|x| * 2^k <= 2^62``, so that no
    int64 sum of the scaled, rounded values can overflow. k is clamped to
    [-100, 100], where both factors are normal f32 numbers: values below
    the quantum 2^-100 (~8e-31) round to zero. Under a mesh ``max_abs``
    and ``total_rows`` are every shard's (module docstring), so that
    every shard takes the same k."""
    n = gpair.shape[0] if total_rows is None else total_rows
    if max_abs is None:
        max_abs = abs_max(gpair)
    max_abs = max_abs.to(gpair.device)
    # max|x| < 2^e with e the f32 exponent field minus 126 (subnormals and
    # zero read as e = -126, still an upper bound)
    e = ((max_abs.view(torch.int32) >> 23) & 0xFF) - 126
    log2_n = max(n - 1, 0).bit_length()                  # n <= 2^log2_n
    k = torch.clamp(62 - log2_n - e, -100, 100)
    return _pow2(k).contiguous(), _pow2(-k).contiguous()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bfloat16 (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_parts(gpair: torch.Tensor, precision: str):
    """The rounded values a row adds under ``precision``: [gpair] (f32),
    [hi] (bf16) or [hi, lo] (bf16x2), ``hi = bf16(x)``,
    ``lo = bf16(x - hi)``, each [n, 2] f32. A rounded value is at most
    2^e where max|x| < 2^e, so :func:`fixed_point_scale`'s 2^k, taken
    from the unrounded gradients, keeps their int64 sums in range."""
    if precision == "f32":
        return [gpair]
    hi = round_bf16(gpair)
    if precision == "bf16":
        return [hi]
    if precision == "bf16x2":
        return [hi, round_bf16(gpair - hi)]
    raise ValueError(f"unknown K3 precision {precision!r}")


def build_hist_f32_reference(bins: torch.Tensor, gpair: torch.Tensor,
                             rel: torch.Tensor, qscale: torch.Tensor,
                             inv: torch.Tensor, n_nodes: int,
                             max_nbins: int,
                             precision: str = "f32") -> torch.Tensor:
    """Plain version of K3: ``round(x * 2^k)`` to int64, exact int64 sums
    by ``index_add_``, one conversion to f32, times ``2^-k``. ``bf16`` /
    ``bf16x2``: the same over each row's rounded values
    (:func:`bf16_parts`), a row's ``hi`` and ``lo`` into one sum."""
    n, F = bins.shape
    seg, active = _segments(bins, rel, n_nodes, max_nbins)
    q = sum(torch.round(v * qscale[None, :]).to(torch.int64)
            for v in bf16_parts(gpair, precision))
    vals = q[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    acc = torch.zeros((n_nodes * F * max_nbins, 2), dtype=torch.int64,
                      device=bins.device)
    acc.index_add_(0, seg, vals)
    out = acc.to(torch.float32) * inv[None, :]
    return out.reshape(n_nodes, F, max_nbins, 2)


def build_hist_f32_u4_reference(packed: torch.Tensor, n_features: int,
                                gpair: torch.Tensor, rel: torch.Tensor,
                                qscale: torch.Tensor, inv: torch.Tensor,
                                n_nodes: int, max_nbins: int,
                                precision: str = "f32") -> torch.Tensor:
    """Plain version of K3's ``packed_u4`` body (each precision):
    :func:`unpack_u4`, then K3's plain version."""
    return build_hist_f32_reference(unpack_u4(packed, n_features), gpair, rel,
                                    qscale, inv, n_nodes, max_nbins,
                                    precision=precision)


# ---- dispatch ----------------------------------------------------------------

def build_hist(bins: torch.Tensor, gpair: torch.Tensor, rel_pos: torch.Tensor,
               n_nodes: int, max_nbins: int, method: str = "auto",
               has_missing: bool = True, packed_u4: int = 0,
               numeric: bool = True, max_abs: Optional[torch.Tensor] = None,
               total_rows: Optional[int] = None,
               col_split: bool = False) -> torch.Tensor:
    """bins [n, F] uint8/uint16/int32; gpair [n, 2] f32; rel_pos [n]
    int32 in [0, n_nodes] -> [n_nodes, F, max_nbins, 2] f32.
    ``has_missing``: the last bin slot is the missing slot; ``numeric``:
    no feature is categorical (both feed ``auto``'s choice only).
    ``packed_u4=F``: ``bins`` is a u4-packed page [n, ceil(F/2)] uint8
    of F features. ``max_abs`` / ``total_rows``: a mesh's scale (module
    docstring); ``col_split``: feature-sharded bins (``auto`` keeps off
    K4)."""
    kernel = resolve_hist_kernel(method, bins.shape[0], n_nodes, max_nbins,
                                 has_missing, numeric, col_split)
    if packed_u4 and kernel == "scan":
        raise ValueError(
            f"hist_method={method!r} runs K4, which takes no u4-packed bins "
            "(the TPU's sorted kernel has no packed body)")
    rel = rel_pos.to(torch.int32).contiguous()
    on_cpu = bins.device.type == "cpu"
    if kernel in ("int8x2", "scan"):
        q, inv = quantise_int8x2(gpair, max_abs)
        if on_cpu:
            if packed_u4:
                return build_hist_int8x2_u4_reference(
                    bins, packed_u4, q, rel, inv, n_nodes, max_nbins)
            plain = (build_hist_scan_reference if kernel == "scan"
                     else build_hist_int8x2_reference)
            return plain(bins, q, rel, inv, n_nodes, max_nbins)
        from .cuda.hist import hist_int8x2_cuda, hist_scan_cuda

        if kernel == "scan":
            return hist_scan_cuda(bins, q, rel, inv, n_nodes, max_nbins)
        return hist_int8x2_cuda(bins, q, rel, inv, n_nodes, max_nbins,
                                packed_u4=packed_u4)
    qscale, inv = fixed_point_scale(gpair, max_abs, total_rows)
    if on_cpu:
        if packed_u4:
            return build_hist_f32_u4_reference(
                bins, packed_u4, gpair, rel, qscale, inv, n_nodes, max_nbins,
                precision=kernel)
        return build_hist_f32_reference(bins, gpair, rel, qscale, inv,
                                        n_nodes, max_nbins, precision=kernel)
    from .cuda.hist import hist_f32_cuda

    return hist_f32_cuda(bins, gpair.contiguous(), rel, qscale, inv, n_nodes,
                         max_nbins, precision=kernel, packed_u4=packed_u4)


def build_hist_multi(bins: torch.Tensor, gpair: torch.Tensor,
                     rel_pos: torch.Tensor, n_nodes: int, max_nbins: int,
                     method: str = "auto", has_missing: bool = True,
                     packed_u4: int = 0,
                     max_abs: Optional[torch.Tensor] = None,
                     total_rows: Optional[int] = None,
                     col_split: bool = False) -> torch.Tensor:
    """The K-target histogram [n_nodes, F, max_nbins, K, 2] of gpair
    [n, K, 2] (vector-leaf trees; the JAX package's
    ``build_hist_multi``): K passes of :func:`build_hist`, one a target,
    each through the kernel ``method`` gives a scalar build and each
    quantised with its own target's scale. (A K-channel pass that reads
    the bins once for every target is not in either package.)
    ``packed_u4=F``: a u4-packed page, as :func:`build_hist` takes it.
    ``max_abs`` [K, 2]: each target's scale over a mesh's shards;
    ``col_split`` as :func:`build_hist` takes it."""
    K = gpair.shape[1]
    F = packed_u4 or bins.shape[1]
    out = torch.empty((n_nodes, F, max_nbins, K, 2), dtype=torch.float32,
                      device=bins.device)
    for k in range(K):
        out[:, :, :, k] = build_hist(bins, gpair[:, k].contiguous(), rel_pos,
                                     n_nodes, max_nbins, method=method,
                                     has_missing=has_missing,
                                     packed_u4=packed_u4,
                                     max_abs=None if max_abs is None
                                     else max_abs[k],
                                     total_rows=total_rows,
                                     col_split=col_split)
    return out


# ---- K5 and the two-level level sweeps --------------------------------------

def fused_advance_coarse_reference(bins: torch.Tensor, q: torch.Tensor,
                                   inv: torch.Tensor, positions: torch.Tensor,
                                   prev: LevelSplits, lo: int, n_level: int,
                                   missing_bin: int):
    """Plain version of K5: the rows advanced below ``prev``'s splits
    (``ops/partition.py advance_level``), then K2's plain version over
    ``coarse_bin_ids`` at the new level of ``n_level`` nodes from heap
    node ``lo`` -> (positions [n] int64, [n_level, F, COARSE_B, 2] f32)."""
    positions = advance_level(bins, positions, prev, missing_bin)
    hist = build_hist_int8x2_reference(
        coarse_bin_ids(bins, missing_bin), q, level_rel(positions, lo,
                                                        n_level),
        inv, n_level, COARSE_B)
    return positions, hist


def fused_advance_coarse(bins: torch.Tensor, gpair: torch.Tensor,
                         positions: torch.Tensor, prev: LevelSplits, lo: int,
                         n_level: int, missing_bin: int,
                         max_abs: Optional[torch.Tensor] = None,
                         total_rows: Optional[int] = None):
    """One sweep at a level boundary of ``fused``: advance the rows below
    the previous level's splits ``prev`` and build the new level's coarse
    histogram -> (positions [n] int64, [n_level, F, COARSE_B, 2] f32).

    K5 runs where the TPU runs its fused kernel: levels of at most 128
    nodes (``prev`` at most 64) and the int8x2 guard
    ``n * 128 < 2^31``. (The TPU also bounds the kernel's f32 table by its
    VMEM, ``F * COARSE_B * 2 * N * 4 <= 8 MiB``; that is a limit of the
    TPU's memory, not of the function, and K5 has no such limit.)
    Elsewhere the plain advance runs, then ``build_hist`` over the coarse
    ids (K3 above 128 nodes). Both give the same integers
    where both run. ``max_abs`` / ``total_rows``: a mesh's scale."""
    n = bins.shape[0]
    if n_level <= 128 and prev.feat.shape[0] <= 64 and int8x2_fits(n):
        q, inv = quantise_int8x2(gpair, max_abs)
        if bins.device.type == "cpu":
            return fused_advance_coarse_reference(
                bins, q, inv, positions, prev, lo, n_level, missing_bin)
        from .cuda.hist import fused_advance_coarse_cuda

        return fused_advance_coarse_cuda(bins, q, inv, positions, prev, lo,
                                         n_level, missing_bin)
    positions = advance_level(bins, positions, prev, missing_bin)
    hist = build_hist(coarse_bin_ids(bins, missing_bin), gpair,
                      level_rel(positions, lo, n_level), n_level, COARSE_B,
                      max_abs=max_abs, total_rows=total_rows)
    return positions, hist


def scan_level_hists(bins: torch.Tensor, gpair: torch.Tensor,
                     rel: torch.Tensor, n_level: int, max_nbins: int,
                     missing_bin: int, max_abs: Optional[torch.Tensor] = None,
                     total_rows: Optional[int] = None):
    """One level of ``scan`` -> (fine [N, F, max_nbins, 2], coarse
    [N, F, COARSE_B, 2]). At most 128 nodes within the int8x2 guard: one
    K4 build, the coarse histogram folded from its int32 sums
    (:func:`coarse_fold`; on the card in the kernel). Elsewhere, as the
    TPU's f32 branch: K3 builds the fine histogram and, over
    ``coarse_bin_ids``, the coarse one. (The JAX package's opt-in bf16
    accumulator, ``XTPU_SCAN_ACC=bf16``, is not bit-compatible and not
    ported: ROADMAP A.6.) ``max_abs`` / ``total_rows``: a mesh's
    scale."""
    if resolve_hist_kernel("scan", bins.shape[0], n_level,
                           max_nbins) == "scan":
        q, inv = quantise_int8x2(gpair, max_abs)
        rel = rel.to(torch.int32).contiguous()
        if bins.device.type == "cpu":
            acc = scan_acc_reference(bins, q, rel, n_level, max_nbins)
            return (dequant_int8x2(acc, inv),
                    dequant_int8x2(coarse_fold(acc, missing_bin), inv))
        from .cuda.hist import hist_scan_cuda

        return hist_scan_cuda(bins, q, rel, inv, n_level, max_nbins,
                              with_coarse=True, missing_bin=missing_bin)
    fine = build_hist(bins, gpair, rel, n_level, max_nbins, method="segment",
                      max_abs=max_abs, total_rows=total_rows)
    coarse = build_hist(coarse_bin_ids(bins, missing_bin), gpair, rel,
                        n_level, COARSE_B, method="segment", max_abs=max_abs,
                        total_rows=total_rows)
    return fine, coarse


def scan_advance_level(bins: torch.Tensor, gpair: torch.Tensor,
                       positions: torch.Tensor, prev: LevelSplits, lo: int,
                       n_level: int, missing_bin: int, max_nbins: int,
                       max_abs: Optional[torch.Tensor] = None,
                       total_rows: Optional[int] = None):
    """A level boundary of ``scan``: the plain advance below ``prev``'s
    splits, then :func:`scan_level_hists` of the new level ->
    (positions, fine, coarse)."""
    positions = advance_level(bins, positions, prev, missing_bin)
    fine, coarse = scan_level_hists(bins, gpair,
                                    level_rel(positions, lo, n_level),
                                    n_level, max_nbins, missing_bin,
                                    max_abs, total_rows)
    return positions, fine, coarse
