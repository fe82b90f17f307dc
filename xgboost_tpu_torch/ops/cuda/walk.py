"""ctypes wrapper of the Hopper packed-forest walk (``csrc/walk.cu``, K1),
and its launch plan.

:func:`walk_plan` picks one of the kernel's two schedules where the CPU
tests reach it: **spread** (a block's threads take tree slots of one row
or a few, each walking its tree out of L1/L2) for small batches and for
forests whose largest tree does not fit the staging budget; **staged** (a
thread a row of a tile, the forest streamed through shared memory in
chunks of consecutive tree slots) for large batches. Both sum a row's
terms in one order (``ops/walk.py walk_fold_kernel_order``), so a row's
margin does not depend on its batch or schedule.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build, graphs

# launches of the walk kernel in this process, in all and per schedule
# (the counts chip_smoke.py reads to show that the main path went through
# the kernel, and on which schedule)
LAUNCHES = 0
SCHEDULE_LAUNCHES: Dict[str, int] = {"spread": 0, "staged": 0}
_launch_lock = threading.Lock()

_fn = None
_sms: Dict[int, int] = {}

# ---- the plan ---------------------------------------------------------------

SPREAD_THREADS = 512        # csrc/walk.cu kSpreadThreads
STAGED_MAX_ROWS = 768       # kStagedMaxThreads: rows (threads) of a tile
# kSmemMax: dynamic shared memory of a block. A staged block takes all of
# it, one block a SM: the fewer tiles, the fewer times the pool is copied
# from L2
SMEM_MAX = 232_448
SPREAD_X_FEATURES = 1024    # the spread schedule stages a row up to this
CHUNK_MAX_SLOTS = 256       # kChunkMaxSlots: tree slots of a staged chunk
META_BYTES = 16             # a slot's (root, weight, group) in a chunk
# batches of more rows take the staged schedule where the forest fits
# (the crossover measured on the H100, PERF.md)
SPREAD_MAX_ROWS = 8192
SCHEDULES = ("spread", "staged")


class WalkPlan(NamedTuple):
    """One launch of K1; the first eight fields in the order of
    ``csrc/walk.cu WalkPlan`` (the host array the entry point reads)."""
    staged: int         # 0: spread, 1: staged
    threads: int        # of a block
    rows: int           # rows of a block (spread: rows x slots = threads)
    slots: int          # spread: tree slots a round; staged: 0
    stage_x: int        # features staged in shared memory (else __ldg)
    n_chunks: int       # staged: chunks of tree slots
    capacity: int       # staged: nodes of one chunk buffer (words, values)
    smem: int           # dynamic shared memory of a block, bytes
    chunks: Tuple[Tuple[int, int, int, int], ...]
    # staged: (first slot, end slot, span start, span nodes) of each chunk;
    # the span start is aligned down to 2 nodes (16 bytes)

    @property
    def schedule(self) -> str:
        return SCHEDULES[self.staged]


def slot_spans(tree_offsets: np.ndarray, n_nodes: int) -> np.ndarray:
    """[Tp, 2] int64 (first node, end node) of each tree slot's nodes in
    the forest-major pool: from its root to the next larger root, or to
    the pool's end (pad slots: the inert leaf after the last tree)."""
    offs = np.asarray(tree_offsets, np.int64)
    roots = np.unique(offs)
    nxt = np.append(roots[1:], n_nodes)
    return np.stack([offs, nxt[np.searchsorted(roots, offs)]], axis=1)


def _chunks(spans: np.ndarray, capacity: int):
    """Consecutive slots, greedily, while their span (aligned down to 2
    nodes, 16 bytes) fits ``capacity`` nodes, at most ``CHUNK_MAX_SLOTS``
    of them; None where one slot does not fit."""
    out = []
    t, Tp = 0, spans.shape[0]
    while t < Tp:
        lo, hi = int(spans[t, 0]) & ~1, int(spans[t, 1])
        if hi - lo > capacity:
            return None
        u = t + 1
        while u < Tp and u - t < CHUNK_MAX_SLOTS:
            lo2 = min(lo, int(spans[u, 0]) & ~1)
            hi2 = max(hi, int(spans[u, 1]))
            if hi2 - lo2 > capacity:
                break
            lo, hi, u = lo2, hi2, u + 1
        out.append((t, u, lo, hi - lo))
        t = u
    return tuple(out)


def staged_rows(n: int, num_sms: int) -> int:
    """Rows of a staged tile: the batch over one block a SM, in whole
    warps, at most ``STAGED_MAX_ROWS``."""
    per = math.ceil(n / num_sms)
    return min(STAGED_MAX_ROWS, max(32, -(-per // 32) * 32))


def _staged(n, spans, F, G, num_sms) -> Optional[WalkPlan]:
    T = staged_rows(n, num_sms)
    x_bytes = T * F * 4
    stage_x = x_bytes <= SMEM_MAX // 2
    meta = 2 * min(spans.shape[0], CHUNK_MAX_SLOTS) * META_BYTES
    fixed = (meta + (x_bytes if stage_x else 0)
             + (G * T * 4 if G > 1 else 0))
    # two buffers of 8-byte nodes, a whole number of 16-byte pieces each
    capacity = (SMEM_MAX - fixed) // 16 // 2 * 2
    chunks = _chunks(spans, capacity) if capacity >= 2 else None
    if chunks is None:
        return None
    return WalkPlan(1, T, T, 0, int(stage_x), len(chunks), capacity,
                    capacity * 16 + fixed, chunks)


def _spread(Tp, F, G) -> WalkPlan:
    S = min(SPREAD_THREADS, -(-Tp // 32) * 32)
    rows = SPREAD_THREADS // S
    stage_x = F <= SPREAD_X_FEATURES
    smem = (rows * S * 4 + (S * 4 + rows * G * 4 if G > 1 else 0)
            + (rows * F * 4 if stage_x else 0))
    if smem > SMEM_MAX:
        raise ValueError(f"{G} output groups overflow the spread walk's "
                         f"shared memory ({smem} bytes)")
    return WalkPlan(0, rows * S, rows, S, int(stage_x), 0, 0, smem, ())


def walk_plan(n: int, Tp: int, spans: np.ndarray, n_features: int,
              n_groups: int, num_sms: int,
              schedule: Optional[str] = None) -> WalkPlan:
    """The plan of one walk of ``n`` rows over ``Tp`` tree slots whose
    nodes lie at ``spans`` (:func:`slot_spans`). Staged when the batch has
    more than ``SPREAD_MAX_ROWS`` rows and every slot's tree fits a chunk
    buffer; else spread. ``schedule`` names one instead (timing and
    tests); a staged walk the forest does not fit raises."""
    if schedule not in (None, *SCHEDULES):
        raise ValueError(f"unknown walk schedule {schedule!r}")
    if spans.shape != (Tp, 2):
        raise ValueError(f"spans must have shape ({Tp}, 2), got "
                         f"{spans.shape}")
    if schedule == "spread" or (schedule is None and n <= SPREAD_MAX_ROWS):
        return _spread(Tp, n_features, n_groups)
    plan = _staged(n, spans, n_features, n_groups, num_sms)
    if plan is not None:
        return plan
    if schedule == "staged":
        raise ValueError("a tree of this forest does not fit the staged "
                         "walk's chunk buffer")
    return _spread(Tp, n_features, n_groups)


# ---- the launch -------------------------------------------------------------

def _kernel():
    global _fn
    if _fn is None:
        f = build.load("walk").xtt_walk_packed
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, i, p, p, p, i, p, ctypes.c_longlong, i, p, i, i,
                      p, p, p, p, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _num_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device,
           ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _planned(n, Tp, spans, F, G, dev, schedule, plans):
    """(plan, its host array, its chunk table on ``dev``), kept in
    ``plans`` (a dict of the forest and device) by the plan's shape."""
    sms = _num_sms(dev)
    staged = schedule == "staged" or (schedule is None
                                      and n > SPREAD_MAX_ROWS)
    key = (staged, staged_rows(n, sms) if staged else 0, F, G, schedule)
    hit = plans.get(key) if plans is not None else None
    if hit is None:
        plan = walk_plan(n, Tp, spans, F, G, sms, schedule)
        host = (ctypes.c_longlong * 8)(*plan[:8])
        table = (torch.tensor(plan.chunks, dtype=torch.int32, device=dev)
                 if plan.staged else None)
        hit = (plan, host, table)
        if plans is not None:
            plans[key] = hit
    return hit


def walk_packed_cuda(words: torch.Tensor, values: torch.Tensor,
                     tree_offsets: torch.Tensor, tree_weight: torch.Tensor,
                     tree_group: torch.Tensor, X: torch.Tensor,
                     base: torch.Tensor,
                     cat_words: Optional[torch.Tensor] = None, *,
                     max_depth: int, max_feature: int,
                     leaf_index: bool = False,
                     nodes: Optional[torch.Tensor] = None,
                     spans: Optional[np.ndarray] = None,
                     plans: Optional[dict] = None,
                     schedule: Optional[str] = None):
    """Margin [n, G] of a packed forest on the card, and the final flat
    node index [n, Tp] int32 when ``leaf_index`` (else ``None``).

    Replaces the TPU kernel ``xgboost_tpu/ops/pallas/walk.py
    _walk_kernel`` and computes ``ops/walk.py walk_packed``'s function,
    categorical splits included, summed in the order of
    ``ops/walk.py walk_fold_kernel_order``. Bound: the least time is the
    larger of bytes (the pool read once, ``N*8``; X once, ``n*F*4``; the
    output once, ``n*G*4``) over 3.35 TB/s and the comparisons and leaf
    sums over the f32 rate; the dependent loads of the walk keep it above
    that bound.

    ``words``/``cat_words`` are int32 tensors holding the uint32 bits;
    ``tree_group`` [Tp] int32 is each tree's output group. ``nodes``
    [N, 2] int32: each node's word and value bits side by side, as the
    kernel reads them (``PackedForest.device_arrays``); ``spans``:
    :func:`slot_spans` of the forest; ``plans``: a dict the forest keeps
    per device for the plans and their chunk tables; ``schedule``: force
    ``"spread"`` or ``"staged"`` (timing and tests; else
    :func:`walk_plan` picks). Launches on the current stream and does not
    synchronise.
    """
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"walk_packed_cuda needs CUDA tensors, X is on {dev}")
    _check("X", X, torch.float32, dev, 2)
    _check("words", words, torch.int32, dev, 1)
    _check("values", values, torch.float32, dev, 1)
    _check("tree_offsets", tree_offsets, torch.int32, dev, 1)
    _check("tree_weight", tree_weight, torch.float32, dev, 1)
    _check("tree_group", tree_group, torch.int32, dev, 1)
    _check("base", base, torch.float32, dev, 1)
    n, F = X.shape
    N = words.shape[0]
    Tp = tree_offsets.shape[0]
    G = base.shape[0]
    if values.shape[0] != N:
        raise ValueError(f"values has {values.shape[0]} nodes, words {N}")
    if tree_weight.shape[0] != Tp or tree_group.shape[0] != Tp:
        raise ValueError("tree_weight and tree_group must have one entry "
                         f"per tree ({Tp})")
    if max_feature >= F:
        raise ValueError(f"the forest splits on feature {max_feature} but X "
                         f"has only {F} columns")
    if max_depth < 0 or N >= 2 ** 31 or Tp == 0:
        raise ValueError(f"bad walk geometry: max_depth={max_depth}, "
                         f"nodes={N}, trees={Tp}")
    n_words = 0
    if cat_words is not None:
        _check("cat_words", cat_words, torch.int32, dev, 2)
        if cat_words.shape[0] != N:
            raise ValueError(f"cat_words has {cat_words.shape[0]} rows, "
                             f"words {N}")
        n_words = cat_words.shape[1]
    out = torch.empty((n, G), dtype=torch.float32, device=dev)
    leaves = (torch.empty((n, Tp), dtype=torch.int32, device=dev)
              if leaf_index else None)
    if n == 0:
        return out, leaves
    if nodes is None or spans is None:
        raise ValueError("the walk kernel needs the forest's nodes and "
                         "spans (PackedForest.device_arrays, slot_spans)")
    _check("nodes", nodes, torch.int32, dev, 2)
    if tuple(nodes.shape) != (N, 2) or nodes.data_ptr() % 16:
        raise ValueError(f"nodes must be a 16-byte aligned [{N}, 2] tensor, "
                         f"got shape {tuple(nodes.shape)}")
    plan, host, table = _planned(n, Tp, spans, F, G, dev, schedule, plans)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            nodes.data_ptr(),
            cat_words.data_ptr() if cat_words is not None else None,
            n_words, tree_offsets.data_ptr(), tree_weight.data_ptr(),
            tree_group.data_ptr(), Tp, X.data_ptr(), n, F, base.data_ptr(),
            G, int(max_depth), ctypes.addressof(host),
            table.data_ptr() if table is not None else None, out.data_ptr(),
            leaves.data_ptr() if leaves is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    if not graphs.tally("walk", plan.schedule):    # a capture's, else ours
        add_launches(plan.schedule, 1)
    return out, leaves


def add_launches(schedule: str, k: int) -> None:
    """``k`` launches on ``schedule`` (a launch, or graph replays)."""
    global LAUNCHES
    with _launch_lock:
        LAUNCHES += k
        SCHEDULE_LAUNCHES[schedule] += k
