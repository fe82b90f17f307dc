"""ctypes wrappers of the Hopper histogram kernels (``csrc/hist.cu``):
K2 (``hist_int8x2_cuda``), K3 (``hist_f32_cuda``), K4
(``hist_scan_cuda``, which can also hand back its int32 accumulators for
the coarse fold) and K5 (``fused_advance_coarse_cuda``, the level advance
fused with the next level's coarse histogram).

K2 and K3 run on a plan made here (:func:`hist_plan`), where the CPU
tests reach it: groups of consecutive nodes whose [G, F, B] cells of 16
bytes fit one shared-memory tile (features, then bins, cut into tiles
where one node does not fit), and items of at most R rows. A level that
fits one tile is read in row order; otherwise the kernel sorts the rows
by node and cuts each group's run into items (:func:`group_items`, the
arithmetic of the device's ``level_plan``). A group of one item writes its output once; a
split group's items leave integer partials that one more kernel adds
and converts."""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..split import COARSE_B, COARSE_SPAN
from . import build

# launches of each kernel in this process (the counts chip_smoke.py reads
# to show that the main path went through the kernels)
LAUNCHES: Dict[str, int] = {"hist_int8x2": 0, "hist_f32": 0, "hist_scan": 0,
                            "fused_advance_coarse": 0}
_launch_lock = threading.Lock()

_fns: Dict[str, object] = {}
_sms: Dict[int, int] = {}
_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("hist"), f"xtt_{name}")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "hist_f32":
            fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, p, p, p, p, p]
        elif name == "hist_int8x2":
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, p, p, p, p, p]
        elif name == "hist_scan":                    # K2's + work
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, i, p, p, p, p]
        else:                                        # fused_advance_coarse
            fn.argtypes = [p, i, p, p, i, ll, ll, i, i, i, p, p, ll, i, i,
                           i, p, p, p, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _num_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check(name: str, t: torch.Tensor, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, bins are on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _common(bins: torch.Tensor, n_nodes: int, max_nbins: int):
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"the histogram kernels need CUDA tensors, bins "
                         f"are on {dev}")
    if bins.dtype not in _BIN_BYTES:
        raise TypeError(f"bins must be uint8, uint16 or int32, got "
                        f"{bins.dtype}")
    if bins.dim() != 2:
        raise ValueError(f"bins must be 2-D, got shape {tuple(bins.shape)}")
    n, F = bins.shape
    _check("bins", bins, None, dev, (n, F))
    if n_nodes < 1 or max_nbins < 1 or F < 1:
        raise ValueError(f"bad histogram geometry: nodes={n_nodes}, "
                         f"bins={max_nbins}, features={F}")
    return dev, n, F


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins):
    dev, n, F = _common(bins, n_nodes, max_nbins)
    if rel is not None:
        _check("rel", rel, torch.int32, dev, (n,))
    if n * 128 >= 2 ** 31:
        raise ValueError(f"{n} rows overflow the int32 int8x2 counters")
    _check("q", q, torch.int32, dev, (n, 2))
    _check("inv", inv, torch.float32, dev, (2,))
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    return dev, n, F, out


def _table(out: torch.Tensor) -> torch.Tensor:
    """K4's and K5's int32 device table of the four planes of ``out``'s
    cells."""
    return torch.empty((out[..., 0].numel() * 4,), dtype=torch.int32,
                       device=out.device)


# ---- K2 and K3's plan --------------------------------------------------------

TILE_BYTES = 115_200      # csrc/hist.cu kTilePlanBytes: two blocks a SM
CELL_BYTES = 16           # four 32-bit words a cell
SORT_MAX_NODES = 4096     # the sort kernels' shared counts (K4's limit)
MIN_ITEM_ROWS = 1024
ITEMS_PER_SM = 2


class HistPlan(NamedTuple):
    """K2 and K3's launch plan, in the order of ``csrc/hist.cu
    TilePlan`` (the host array the C entry points read)."""
    G: int              # nodes of one group
    fc: int             # features of one tile
    bc: int             # bins of one tile
    bs: int             # a feature's stride in the tile: bc made odd
    n_ftiles: int
    n_btiles: int
    n_groups: int
    R: int              # rows of one item
    sorted: int         # 1: rows sorted by node; 0: one group, row order
    max_items: int      # grid of the tile kernel (items past the count exit)
    max_split: int      # grid of the combine kernel
    max_partials: int   # partial tiles to allocate (items of split groups)

    @property
    def tile_cells(self) -> int:
        return self.G * self.fc * self.bs

    @property
    def n_tiles(self) -> int:
        return self.n_ftiles * self.n_btiles


def tile_geometry(F: int, B: int,
                  N: int) -> Tuple[int, int, int, int, int, int]:
    """(G, fc, bc, bs, n_ftiles, n_btiles): the most consecutive nodes
    whose [F, B] cells fit one tile; where one node does not fit, balanced
    feature tiles of whole features, and where one feature does not fit,
    balanced bin tiles of one feature. A feature's bins sit at the odd
    stride bs (bc, or bc + 1) so that one slot of every feature falls in
    different shared-memory banks."""
    bs = B | 1
    if F * bs * CELL_BYTES <= TILE_BYTES:
        G = max(1, min(N, TILE_BYTES // (F * bs * CELL_BYTES)))
        return G, F, B, bs, 1, 1
    if bs * CELL_BYTES <= TILE_BYTES:
        nft = math.ceil(F / (TILE_BYTES // (bs * CELL_BYTES)))
        return 1, math.ceil(F / nft), B, bs, nft, 1
    nbt = math.ceil(B / (TILE_BYTES // CELL_BYTES - 1))
    bc = math.ceil(B / nbt)
    return 1, 1, bc, bc | 1, F, nbt


def hist_plan(n: int, F: int, B: int, N: int, num_sms: int) -> HistPlan:
    """The plan of one launch of K2 or K3 over n rows and N nodes (at most
    ``SORT_MAX_NODES`` where the rows are sorted; :func:`node_chunks`)."""
    G, fc, bc, bs, nft, nbt = tile_geometry(F, B, N)
    n_groups = math.ceil(N / G)
    R = max(MIN_ITEM_ROWS, math.ceil(n / (ITEMS_PER_SM * num_sms)))
    k = math.ceil(n / R)
    if n_groups == 1:
        items = max(1, k)
        return HistPlan(G, fc, bc, bs, nft, nbt, 1, R, 0, items,
                        int(items > 1), items if items > 1 else 0)
    # a group of c > R rows takes ceil(c / R) < 2c / R items, so the split
    # groups' items number below 2n / R, and at most n // R groups split
    return HistPlan(G, fc, bc, bs, nft, nbt, n_groups, R, 1, n_groups + k,
                    min(n_groups, n // R), min(n_groups + k, 2 * k))


def node_chunks(F: int, B: int, N: int) -> List[Tuple[int, int]]:
    """(first node, nodes) of each launch: one, unless the rows are sorted
    and the level has more than ``SORT_MAX_NODES`` nodes; then chunks of
    whole groups. Rows outside a chunk are inactive in it."""
    G = tile_geometry(F, B, N)[0]
    if N <= G or N <= SORT_MAX_NODES:
        return [(0, N)]
    step = (SORT_MAX_NODES // G) * G
    return [(n0, min(step, N - n0)) for n0 in range(0, N, step)]


def group_items(offsets: List[int], N: int, G: int, R: int):
    """The device's ``group_items`` in Python: over the sorted runs
    (``offsets`` [N + 1]), each group of G nodes takes max(1, ceil(c / R))
    items for its c rows -> (item_start [n_groups + 1], partial slot of
    each group or -1 when it has one item, the split groups)."""
    n_groups = math.ceil(N / G)
    starts, pslot, split = [], [], []
    items = slots = 0
    for g in range(n_groups):
        c = offsets[min((g + 1) * G, N)] - offsets[g * G]
        s = math.ceil(c / R) if c > R else 1
        starts.append(items)
        items += s
        if s > 1:
            pslot.append(slots)
            slots += s
            split.append(g)
        else:
            pslot.append(-1)
    return starts + [items], pslot, split


def hist_work_ints(n: int, N: int, plan: HistPlan) -> int:
    """int32 scratch of one launch: counts [N], offsets [N + 1], cursor
    [N], perm [n], item starts [n_groups + 1], partial slots and split
    groups [n_groups] each, the split count (sorted plans only)."""
    if not plan.sorted:
        return 1
    return 3 * N + 1 + n + 3 * plan.n_groups + 2


def hist_partial_words(plan: HistPlan) -> int:
    """32-bit words of the partial tiles: one tile (four words a cell) per
    item of a split group and tile."""
    return max(1, plan.max_partials * plan.n_tiles * plan.tile_cells * 4)


@functools.lru_cache(maxsize=256)
def _launches(n: int, F: int, B: int, N: int, num_sms: int):
    """(first node, nodes, the plan's kernel fields as a host array, work
    ints, scratch ints) of each launch over a level; the scratch holds the
    work and, from a 16-byte boundary, the partial tiles."""
    out = []
    for n0, nc in node_chunks(F, B, N):
        plan = hist_plan(n, F, B, nc, num_sms)
        work = -(-hist_work_ints(n, nc, plan) // 4) * 4
        # the kernel's fields; max_partials only sizes the scratch
        host = (ctypes.c_longlong * 11)(*plan[:11])
        out.append((n0, nc, host, work, work + hist_partial_words(plan)))
    return tuple(out)


def _tiles(name: str, dev: torch.device, bins: torch.Tensor,
           rel: torch.Tensor, values: Tuple[int, ...],
           out: torch.Tensor) -> None:
    """Launch K2 or K3 (``values``: their gradient pointers) once per node
    chunk of ``out`` [N, F, B, 2]."""
    n, F = bins.shape
    N, _, B, _ = out.shape
    for n0, nc, host, work, total in _launches(n, F, B, N, _num_sms(dev)):
        r = rel if n0 == 0 else rel - n0
        scratch = torch.empty((total,), dtype=torch.int32, device=dev)
        base = scratch.data_ptr()
        _launch(name, dev, bins.data_ptr(), _BIN_BYTES[bins.dtype],
                r.data_ptr(), *values, n, F, B, nc, ctypes.addressof(host),
                base, base + 4 * work, out[n0:n0 + nc].data_ptr())


def _launch(name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count(name)


def hist_int8x2_cuda(bins: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                     inv: torch.Tensor, n_nodes: int,
                     max_nbins: int) -> torch.Tensor:
    """K2 on the card: [n_nodes, F, max_nbins, 2] f32 from the quantised
    gradients ``q`` [n, 2] int32 and the dequantisation factors ``inv``
    [2] f32 (``ops/histogram.py quantise_int8x2``). Computes
    ``build_hist_int8x2_reference``'s function bit for bit. Replaces the
    TPU kernel ``xgboost_tpu/ops/pallas/histogram.py _make_int8_kernel``.
    Launches on the current stream and does not synchronise."""
    dev, _, _, out = _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins)
    _tiles("hist_int8x2", dev, bins, rel, (q.data_ptr(), inv.data_ptr()),
           out)
    return out


def hist_scan_cuda(bins: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                   inv: torch.Tensor, n_nodes: int, max_nbins: int,
                   with_acc: bool = False):
    """K4 on the card: K2's function (the same arguments, the same bits),
    built over the rows counting-sorted by node so that one node's
    [F, B, 4] counters share one shared-memory tile at any level width.
    Computes ``build_hist_scan_reference``'s function bit for bit;
    ``with_acc`` also returns its int32 plane sums [n_nodes, F, B, 4]
    (``scan_acc_reference``'s), from which ``ops/histogram.py
    coarse_fold`` takes the coarse histogram. Replaces the TPU kernel
    ``xgboost_tpu/ops/pallas/histogram.py _make_scan_kernel``. Launches on
    the current stream and does not synchronise."""
    dev, n, F, out = _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins)
    acc = _table(out)
    work = torch.empty((3 * n_nodes + 1 + n,), dtype=torch.int32, device=dev)
    _launch("hist_scan", dev, bins.data_ptr(), _BIN_BYTES[bins.dtype],
            rel.data_ptr(), q.data_ptr(), inv.data_ptr(), n, F, max_nbins,
            n_nodes, _num_sms(dev), work.data_ptr(), acc.data_ptr(),
            out.data_ptr())
    if with_acc:
        return out, acc.view(n_nodes, F, max_nbins, 4)
    return out


def fused_advance_coarse_cuda(bins: torch.Tensor, q: torch.Tensor,
                              inv: torch.Tensor, positions: torch.Tensor,
                              prev, lo: int, n_level: int, missing_bin: int):
    """K5 on the card: advance the rows below the previous level's splits
    ``prev`` (``ops/partition.py LevelSplits``, at most 64 nodes) and build
    the new level's int8x2 coarse histogram in the same pass ->
    (positions [n] int64, [n_level, F, COARSE_B, 2] f32). ``positions``
    [n] int64; ``q``, ``inv`` as for K2. Computes ``ops/histogram.py
    fused_advance_coarse_reference``'s function bit for bit; the coarse
    geometry of ``ops/split.py`` (``COARSE_B`` slots, ids
    ``bin >> log2(COARSE_SPAN)``) is passed to the kernel, which keeps
    none of its own. Replaces the TPU kernel
    ``xgboost_tpu/ops/pallas/histogram.py _make_fused_kernel``. Launches
    on the current stream and does not synchronise."""
    dev, n, F, out = _int8x2_args(bins, q, None, inv, n_level, COARSE_B)
    acc = _table(out)
    _check("positions", positions, torch.int64, dev, (n,))
    n_prev = prev.feat.shape[0]
    if not 1 <= n_prev <= 64:
        raise ValueError(f"K5 advances below levels of 1 to 64 nodes, got "
                         f"{n_prev}")
    payload = torch.stack([a.to(torch.int32) for a in (
        prev.feat.clamp(min=0), prev.thr, prev.dleft, prev.can_split)])
    _check("payload", payload, torch.int32, dev, (4, n_prev))
    pos_out = torch.empty_like(positions)
    _launch("fused_advance_coarse", dev, bins.data_ptr(),
            _BIN_BYTES[bins.dtype], positions.data_ptr(), payload.data_ptr(),
            n_prev, prev.lo, lo, missing_bin, COARSE_B,
            COARSE_SPAN.bit_length() - 1, q.data_ptr(), inv.data_ptr(), n, F,
            n_level, _num_sms(dev), acc.data_ptr(), pos_out.data_ptr(),
            out.data_ptr())
    return pos_out, out


def hist_f32_cuda(bins: torch.Tensor, gpair: torch.Tensor, rel: torch.Tensor,
                  qscale: torch.Tensor, inv: torch.Tensor, n_nodes: int,
                  max_nbins: int) -> torch.Tensor:
    """K3 on the card: [n_nodes, F, max_nbins, 2] f32 from ``gpair``
    [n, 2] f32 through exact int64 fixed point, with ``qscale`` = 2^k and
    ``inv`` = 2^-k ([2] f32 each, ``ops/histogram.py
    fixed_point_scale``). Computes ``build_hist_f32_reference``'s function
    bit for bit. Replaces the f32 variant of the TPU kernel
    ``xgboost_tpu/ops/pallas/histogram.py _make_kernel``. Launches on the
    current stream and does not synchronise."""
    dev, n, F = _common(bins, n_nodes, max_nbins)
    _check("rel", rel, torch.int32, dev, (n,))
    _check("gpair", gpair, torch.float32, dev, (n, 2))
    _check("qscale", qscale, torch.float32, dev, (2,))
    _check("inv", inv, torch.float32, dev, (2,))
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    _tiles("hist_f32", dev, bins, rel,
           (gpair.data_ptr(), qscale.data_ptr(), inv.data_ptr()), out)
    return out
