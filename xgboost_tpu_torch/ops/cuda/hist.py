"""ctypes wrappers of the Hopper histogram kernels (``csrc/hist.cu``):
K2 (``hist_int8x2_cuda``), K3 (``hist_f32_cuda``; its bf16 and bf16x2
precisions through ``precision=``), K4
(``hist_scan_cuda``, K2's function with the two-level search's coarse
fold on request) and K5 (``fused_advance_coarse_cuda``, the level advance
fused with the next level's coarse histogram).

All four run on a plan made here (:func:`hist_plan`), where the CPU
tests reach it: groups of consecutive nodes whose [G, F, B] cells of 16
bytes fit one shared-memory tile (features, then bins, cut into tiles
where one node does not fit), and items of at most R rows. A level that
fits one tile is read in row order; otherwise the kernel sorts the rows
by node and cuts each group's run into items (:func:`group_items`, the
arithmetic of the device's ``level_plan``). A group of one item writes
its output once; a split group's items leave integer partials that one
more kernel adds and converts. K4 folds a node's integer sums into the
coarse histogram where they meet (:func:`fold_fits`); K5 adds each row
at its coarse id and advances the rows in the sort's count, or, at a
level of one group, as the tiles load them (:func:`fused_plan`).

K2 and K3 also read u4-packed pages (``packed_u4=F``: bins [n,
ceil(F/2)] uint8, feature f in byte f // 2, the low nibble for even f),
the external-memory tier's compressed transport; the plan is made over
the logical F, and the kernel reads a feature's nibble where it read its
byte. Their launches count under ``hist_int8x2_u4`` / ``hist_f32_u4`` /
``hist_bf16_u4`` / ``hist_bf16x2_u4``."""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..split import COARSE_B, COARSE_SPAN
from . import build, graphs

# launches of each kernel in this process (the counts chip_smoke.py reads
# to show that the main path went through the kernels)
LAUNCHES: Dict[str, int] = {"hist_int8x2": 0, "hist_f32": 0, "hist_bf16": 0,
                            "hist_bf16x2": 0, "hist_scan": 0,
                            "fused_advance_coarse": 0, "hist_int8x2_u4": 0,
                            "hist_f32_u4": 0, "hist_bf16_u4": 0,
                            "hist_bf16x2_u4": 0}
# K3's precisions -> their kernels
K3_KERNELS = {"f32": "hist_f32", "bf16": "hist_bf16",
              "bf16x2": "hist_bf16x2"}
_launch_lock = threading.Lock()

_fns: Dict[str, object] = {}
_sms: Dict[int, int] = {}
_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
U4_BIN_CODE = 0           # csrc/hist.cu: bin_bytes 0 = u4-packed pages


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("hist"), f"xtt_{name}")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name in K3_KERNELS.values():
            fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, p, p, p, p, p]
        elif name == "hist_int8x2":
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, p, p, p, p, p]
        elif name == "hist_scan":                    # K2's + the fold
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, p, p, p, p, i, i, i,
                           p, p, p]
        else:                                        # fused_advance_coarse
            fn.argtypes = [p, i, p, p, p, p, p, i, ll, ll, i, i, i, p, p, ll,
                           i, i, p, p, p, p, p, p, p]
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


def _common(bins: torch.Tensor, n_nodes: int, max_nbins: int,
            packed_u4: int = 0):
    """-> (device, rows, logical features, the kernel's bin code)."""
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"the histogram kernels need CUDA tensors, bins "
                         f"are on {dev}")
    if bins.dtype not in _BIN_BYTES:
        raise TypeError(f"bins must be uint8, uint16 or int32, got "
                        f"{bins.dtype}")
    if bins.dim() != 2:
        raise ValueError(f"bins must be 2-D, got shape {tuple(bins.shape)}")
    n, W = bins.shape
    _check("bins", bins, None, dev, (n, W))
    F, code = W, _BIN_BYTES[bins.dtype]
    if packed_u4:
        F, code = packed_u4, U4_BIN_CODE
        if bins.dtype != torch.uint8 or W != (F + 1) // 2:
            raise ValueError(f"u4-packed bins of {F} features must be "
                             f"[n, {(F + 1) // 2}] uint8, got "
                             f"{tuple(bins.shape)} {bins.dtype}")
        if max_nbins > 16:
            raise ValueError(f"u4-packed bins take at most 16 bin slots, "
                             f"got {max_nbins}")
    if n_nodes < 1 or max_nbins < 1 or F < 1:
        raise ValueError(f"bad histogram geometry: nodes={n_nodes}, "
                         f"bins={max_nbins}, features={F}")
    return dev, n, F, code


def _count(name: str) -> None:
    """One launch of ``name``; under a graph capture it goes to the
    capture's tally, and each replay adds it (``ops/cuda/graphs.py``)."""
    if graphs.tally("hist", name):
        return
    with _launch_lock:
        LAUNCHES[name] += 1


def add_launches(name: str, k: int) -> None:
    """``k`` launches of ``name`` run by graph replays."""
    with _launch_lock:
        LAUNCHES[name] += k


def _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins, packed_u4=0):
    dev, n, F, code = _common(bins, n_nodes, max_nbins, packed_u4)
    if rel is not None:
        _check("rel", rel, torch.int32, dev, (n,))
    if n * 128 >= 2 ** 31:
        raise ValueError(f"{n} rows overflow the int32 int8x2 counters")
    _check("q", q, torch.int32, dev, (n, 2))
    _check("inv", inv, torch.float32, dev, (2,))
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    return dev, n, F, code, out


def _marks(events):
    """The C entry points' optional phase events: a host array of three
    ``cudaEvent_t`` from three ``torch.cuda.Event(enable_timing=True)``
    (recorded once here, so that each has its handle), or None."""
    if events is None:
        return None
    if len(events) != 3:
        raise ValueError(f"phase_events takes 3 events, got {len(events)}")
    for e in events:
        if not e.cuda_event:
            e.record()
    return (ctypes.c_void_p * 3)(*[e.cuda_event for e in events])


# ---- the plan of the tiles -------------------------------------------------

TILE_BYTES = 115_200      # csrc/hist.cu kTilePlanBytes: two blocks a SM
CELL_BYTES = 16           # four 32-bit words a cell
SORT_MAX_NODES = 4096     # the sort kernels' shared counts
MIN_ITEM_ROWS = 1024
ITEMS_PER_SM = 2
# K5's one-group route keeps the node ids (one byte each) of this many
# rows beside its tile (csrc/hist.cu kAdvanceChunk), so its tiles are
# planned in the rest
ADVANCE_CHUNK = 1024
FUSED_TILE_BYTES = TILE_BYTES - ADVANCE_CHUNK
FUSED_MAX_NODES = 255     # K5's byte node ids (N marks a row outside)


class HistPlan(NamedTuple):
    """The kernels' launch plan, in the order of ``csrc/hist.cu
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


def tile_geometry(F: int, B: int, N: int, tile_bytes: int = TILE_BYTES
                  ) -> Tuple[int, int, int, int, int, int]:
    """(G, fc, bc, bs, n_ftiles, n_btiles): the most consecutive nodes
    whose [F, B] cells fit one tile of ``tile_bytes``; where one node does
    not fit, balanced feature tiles of whole features, and where one
    feature does not fit, balanced bin tiles of one feature. A feature's
    bins sit at the odd stride bs (bc, or bc + 1) so that one slot of
    every feature falls in different shared-memory banks."""
    bs = B | 1
    if F * bs * CELL_BYTES <= tile_bytes:
        G = max(1, min(N, tile_bytes // (F * bs * CELL_BYTES)))
        return G, F, B, bs, 1, 1
    if bs * CELL_BYTES <= tile_bytes:
        nft = math.ceil(F / (tile_bytes // (bs * CELL_BYTES)))
        return 1, math.ceil(F / nft), B, bs, nft, 1
    nbt = math.ceil(B / (tile_bytes // CELL_BYTES - 1))
    bc = math.ceil(B / nbt)
    return 1, 1, bc, bc | 1, F, nbt


def hist_plan(n: int, F: int, B: int, N: int, num_sms: int,
              tile_bytes: int = TILE_BYTES,
              row_order_ftiles: int = 1) -> HistPlan:
    """The plan of one launch over n rows and N nodes (at most
    ``SORT_MAX_NODES`` where the rows are sorted; :func:`node_chunks`).
    A level that does not fit one tile is sorted by node, unless all its
    nodes fit ``row_order_ftiles`` feature tiles: then it is one group
    read in row order, once per feature tile."""
    G, fc, bc, bs, nft, nbt = tile_geometry(F, B, N, tile_bytes)
    n_groups = math.ceil(N / G)
    per = tile_bytes // (N * bs * CELL_BYTES)   # features a tile at N nodes
    if n_groups > 1 and per >= 1 and math.ceil(F / per) <= row_order_ftiles:
        nft = math.ceil(F / per)
        G, fc, n_groups = N, math.ceil(F / nft), 1
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


def fused_plan(n: int, F: int, B: int, N: int, num_sms: int) -> HistPlan:
    """K5's plan: K2's over the [N, F, B] coarse cells in
    ``FUSED_TILE_BYTES``, read in row order up to two feature tiles (at
    28 features x 20 slots up to 24 nodes). Row order: the tiles advance
    the rows as they load them, once per feature tile; sorted: the sort's
    count does, once (the sort costs about one such pass)."""
    return hist_plan(n, F, B, N, num_sms, FUSED_TILE_BYTES, 2)


def fold_fits(max_nbins: int, missing_bin: int) -> bool:
    """K4's in-tile fold takes the layouts of the two-level schedules
    (``tree/grow.py two_level_schedule``): at most 256 real bins, the
    missing slot last, so that a feature's bins fit one tile and every
    real bin has a real coarse slot."""
    return max_nbins <= 256 or (max_nbins == 257 and missing_bin == 256)


def node_chunks(F: int, B: int, N: int,
                tile_bytes: int = TILE_BYTES) -> List[Tuple[int, int]]:
    """(first node, nodes) of each launch: one, unless the rows are sorted
    and the level has more than ``SORT_MAX_NODES`` nodes; then chunks of
    whole groups. Rows outside a chunk are inactive in it."""
    G = tile_geometry(F, B, N, tile_bytes)[0]
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


def hist_work_ints(n: int, N: int, plan: HistPlan,
                   fused: bool = False) -> int:
    """int32 scratch of one launch: counts [N], offsets [N + 1], cursor
    [N], perm [n], item starts [n_groups + 1], partial slots and split
    groups [n_groups] each, the split count, and for K5 (``fused``) the
    advanced rows' nodes [n] (sorted plans only)."""
    if not plan.sorted:
        return 1
    return 3 * N + 1 + n + 3 * plan.n_groups + 2 + (n if fused else 0)


def hist_partial_words(plan: HistPlan) -> int:
    """32-bit words of the partial tiles: one tile (four words a cell) per
    item of a split group and tile."""
    return max(1, plan.max_partials * plan.n_tiles * plan.tile_cells * 4)


@functools.lru_cache(maxsize=256)
def _launches(n: int, F: int, B: int, N: int, num_sms: int,
              fused: bool = False):
    """(first node, nodes, the plan's kernel fields as a host array, work
    ints, scratch ints) of each launch over a level (K5's: ``fused``); the
    scratch holds the work and, from a 16-byte boundary, the partial
    tiles."""
    tile_bytes = FUSED_TILE_BYTES if fused else TILE_BYTES
    out = []
    for n0, nc in node_chunks(F, B, N, tile_bytes):
        plan = (fused_plan if fused else hist_plan)(n, F, B, nc, num_sms)
        work = -(-hist_work_ints(n, nc, plan, fused) // 4) * 4
        # the kernel's fields; max_partials only sizes the scratch
        host = (ctypes.c_longlong * 11)(*plan[:11])
        out.append((n0, nc, host, work, work + hist_partial_words(plan)))
    return tuple(out)


def _tiles(name: str, dev: torch.device, bins: torch.Tensor, code: int,
           rel: torch.Tensor, values: Tuple[int, ...], out: torch.Tensor,
           tail=None, count: Optional[str] = None) -> None:
    """Launch K2, K3 or K4 (``values``: their gradient pointers; ``code``:
    the bin code, bytes an id or ``U4_BIN_CODE``; ``tail``: K4's further
    arguments for the chunk at node n0 of nc nodes) once per node chunk
    of ``out`` [N, F, B, 2] (F the logical features); each launch counts
    under ``count`` (default ``name``)."""
    n = bins.shape[0]
    N, F, B, _ = out.shape
    for n0, nc, host, work, total in _launches(n, F, B, N, _num_sms(dev)):
        r = rel if n0 == 0 else rel - n0
        scratch = torch.empty((total,), dtype=torch.int32, device=dev)
        base = scratch.data_ptr()
        _launch(name, dev, bins.data_ptr(), code,
                r.data_ptr(), *values, n, F, B, nc, ctypes.addressof(host),
                base, base + 4 * work, out[n0:n0 + nc].data_ptr(),
                *(tail(n0, nc) if tail is not None else ()), count=count)


def _launch(name: str, dev: torch.device, *args,
            count: Optional[str] = None) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count(count or name)


def hist_int8x2_cuda(bins: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                     inv: torch.Tensor, n_nodes: int, max_nbins: int,
                     packed_u4: int = 0) -> torch.Tensor:
    """K2 on the card: [n_nodes, F, max_nbins, 2] f32 from the quantised
    gradients ``q`` [n, 2] int32 and the dequantisation factors ``inv``
    [2] f32 (``ops/histogram.py quantise_int8x2``). Computes
    ``build_hist_int8x2_reference``'s function bit for bit. Replaces the
    TPU kernel ``xgboost_tpu/ops/pallas/histogram.py _make_int8_kernel``.
    ``packed_u4=F``: ``bins`` is a u4-packed page of F features (its
    ``packed_u4`` body, ``_u4_row``), the function of
    ``build_hist_int8x2_u4_reference``. Launches on the current stream and
    does not synchronise."""
    dev, _, _, code, out = _int8x2_args(bins, q, rel, inv, n_nodes,
                                        max_nbins, packed_u4)
    _tiles("hist_int8x2", dev, bins, code, rel,
           (q.data_ptr(), inv.data_ptr()), out,
           count="hist_int8x2_u4" if packed_u4 else None)
    return out


def hist_scan_cuda(bins: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                   inv: torch.Tensor, n_nodes: int, max_nbins: int,
                   with_coarse: bool = False,
                   missing_bin: Optional[int] = None,
                   phase_events=None):
    """K4 on the card: K2's function (the same arguments, the same bits)
    over K2's tiles, one node a tile at 28 features x 257 slots.
    Computes ``build_hist_scan_reference``'s function bit for bit.
    ``with_coarse``: also the two-level search's coarse histogram
    [n_nodes, F, COARSE_B, 2] f32, folded from each node's integer sums
    before one dequantisation (``ops/histogram.py coarse_fold``, with
    ``missing_bin``, ``max_nbins`` or more when there is none) -> (fine,
    coarse). ``phase_events``: three ``torch.cuda.Event(enable_timing=
    True)`` recorded after the sort, the tiles and the combine (for
    timing). Replaces the TPU kernel ``xgboost_tpu/ops/pallas/
    histogram.py _make_scan_kernel`` with its ``with_coarse`` fold.
    Launches on the current stream and does not synchronise."""
    dev, n, F, code, out = _int8x2_args(bins, q, rel, inv, n_nodes,
                                        max_nbins)
    coarse = None
    if with_coarse:
        if missing_bin is None or not fold_fits(max_nbins, missing_bin):
            raise ValueError(
                f"K4's coarse fold takes at most 256 real bins with the "
                f"missing slot last, got {max_nbins} slots, missing bin "
                f"{missing_bin}")
        coarse = torch.empty((n_nodes, F, COARSE_B, 2), dtype=torch.float32,
                             device=dev)
    marks = _marks(phase_events)
    shift = COARSE_SPAN.bit_length() - 1

    def tail(n0, nc):
        dst = None if coarse is None else coarse[n0:n0 + nc].data_ptr()
        return (max_nbins if missing_bin is None else missing_bin, COARSE_B,
                shift, dst, marks)

    _tiles("hist_scan", dev, bins, code, rel,
           (q.data_ptr(), inv.data_ptr()), out, tail)
    return (out, coarse) if with_coarse else out


def _splits(prev, dev: torch.device):
    """K5's view of the previous level's splits (``ops/partition.py
    LevelSplits``), as the grower hands them over: feature and threshold
    int64, default_left and can_split one byte each (no copy when they
    already are)."""
    n_prev = prev.feat.shape[0]
    out = []
    for name, t, dtype in (("feat", prev.feat, torch.int64),
                           ("thr", prev.thr, torch.int64),
                           ("dleft", prev.dleft, torch.bool),
                           ("can_split", prev.can_split, torch.bool)):
        t = t.to(dtype).contiguous()
        if t.device != dev or tuple(t.shape) != (n_prev,):
            raise ValueError(f"prev.{name} must be [{n_prev}] on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        out.append(t)
    return out


def fused_advance_coarse_cuda(bins: torch.Tensor, q: torch.Tensor,
                              inv: torch.Tensor, positions: torch.Tensor,
                              prev, lo: int, n_level: int, missing_bin: int,
                              phase_events=None):
    """K5 on the card: advance the rows below the previous level's splits
    ``prev`` (``ops/partition.py LevelSplits``, at most 64 nodes) and build
    the new level's int8x2 coarse histogram in the same sweep ->
    (positions [n] int64, [n_level, F, COARSE_B, 2] f32). ``positions``
    [n] int64; ``q``, ``inv`` as for K2; ``phase_events`` as for K4 (the
    first phase is the advance and the sort). Computes ``ops/histogram.py
    fused_advance_coarse_reference``'s function bit for bit; the coarse
    geometry of ``ops/split.py`` (``COARSE_B`` slots, ids
    ``bin >> log2(COARSE_SPAN)``) is passed to the kernel, which keeps
    none of its own. Replaces the TPU kernel
    ``xgboost_tpu/ops/pallas/histogram.py _make_fused_kernel``. Launches
    on the current stream and does not synchronise."""
    dev, n, F, _, out = _int8x2_args(bins, q, None, inv, n_level, COARSE_B)
    _check("positions", positions, torch.int64, dev, (n,))
    n_prev = prev.feat.shape[0]
    if not 1 <= n_prev <= 64:
        raise ValueError(f"K5 advances below levels of 1 to 64 nodes, got "
                         f"{n_prev}")
    if n_level > FUSED_MAX_NODES:
        raise ValueError(f"K5 builds levels of at most {FUSED_MAX_NODES} "
                         f"nodes, got {n_level}")
    splits = _splits(prev, dev)
    pos_out = torch.empty_like(positions)
    (_, _, host, work, total), = _launches(n, F, COARSE_B, n_level,
                                           _num_sms(dev), True)
    scratch = torch.empty((total,), dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    _launch("fused_advance_coarse", dev, bins.data_ptr(),
            _BIN_BYTES[bins.dtype], positions.data_ptr(),
            *(t.data_ptr() for t in splits), n_prev, prev.lo, lo,
            missing_bin, COARSE_B,
            COARSE_SPAN.bit_length() - 1, q.data_ptr(), inv.data_ptr(), n, F,
            n_level, ctypes.addressof(host), base, base + 4 * work,
            pos_out.data_ptr(), out.data_ptr(), _marks(phase_events))
    return pos_out, out


def hist_f32_cuda(bins: torch.Tensor, gpair: torch.Tensor, rel: torch.Tensor,
                  qscale: torch.Tensor, inv: torch.Tensor, n_nodes: int,
                  max_nbins: int, precision: str = "f32",
                  packed_u4: int = 0) -> torch.Tensor:
    """K3 on the card: [n_nodes, F, max_nbins, 2] f32 from ``gpair``
    [n, 2] f32 through exact int64 fixed point, with ``qscale`` = 2^k and
    ``inv`` = 2^-k ([2] f32 each, ``ops/histogram.py
    fixed_point_scale``). ``precision`` ``"bf16"`` / ``"bf16x2"``: each
    row's (g, h) rounded to bfloat16 first (``ops/histogram.py
    bf16_parts``). Computes ``build_hist_f32_reference``'s function at
    the same precision bit for bit. Replaces the TPU kernel
    ``xgboost_tpu/ops/pallas/histogram.py _make_kernel`` (its f32, bf16
    and bf16x2 bodies). ``packed_u4=F``: ``bins`` is a u4-packed page of
    F features (the ``packed_u4`` body, in each precision), the function
    of ``build_hist_f32_u4_reference``. Launches on the current stream
    and does not synchronise."""
    if precision not in K3_KERNELS:
        raise ValueError(f"unknown K3 precision {precision!r}")
    dev, n, F, code = _common(bins, n_nodes, max_nbins, packed_u4)
    _check("rel", rel, torch.int32, dev, (n,))
    _check("gpair", gpair, torch.float32, dev, (n, 2))
    _check("qscale", qscale, torch.float32, dev, (2,))
    _check("inv", inv, torch.float32, dev, (2,))
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    name = K3_KERNELS[precision]
    _tiles(name, dev, bins, code, rel,
           (gpair.data_ptr(), qscale.data_ptr(), inv.data_ptr()), out,
           count=f"{name}_u4" if packed_u4 else None)
    return out
