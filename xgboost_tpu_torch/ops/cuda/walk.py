"""ctypes wrapper of the Hopper packed-forest walk (``csrc/walk.cu``)."""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build

# launches of the walk kernel in this process (the count chip_smoke.py
# reads to show that the main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load("walk").xtt_walk_packed
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, i, p, p, p, i, p, ctypes.c_longlong, i, p, i,
                      i, p, p, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


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


def walk_packed_cuda(words: torch.Tensor, values: torch.Tensor,
                     tree_offsets: torch.Tensor, tree_weight: torch.Tensor,
                     tree_group: torch.Tensor, X: torch.Tensor,
                     base: torch.Tensor,
                     cat_words: Optional[torch.Tensor] = None, *,
                     max_depth: int, max_feature: int,
                     leaf_index: bool = False):
    """Margin [n, G] of a packed forest on the card, and the final flat
    node index [n, Tp] int32 when ``leaf_index`` (else ``None``).

    Replaces the TPU kernel ``xgboost_tpu/ops/pallas/walk.py
    _walk_kernel`` and computes ``ops/walk.py walk_packed``'s function,
    categorical splits included. Bound: the least time is the larger of
    bytes (the pool read once, ``N*8``; X once, ``n*F*4``; the output
    once, ``n*G*4``) over 3.35 TB/s and the comparisons and leaf sums
    over the f32 rate; the dependent gathers of the walk keep it far
    above that bound.

    ``words``/``cat_words`` are int32 tensors holding the uint32 bits;
    ``tree_group`` [Tp] int32 is each tree's output group. Launches on
    the current stream and does not synchronise.
    """
    global LAUNCHES
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            words.data_ptr(), values.data_ptr(),
            cat_words.data_ptr() if cat_words is not None else None,
            n_words, tree_offsets.data_ptr(), tree_weight.data_ptr(),
            tree_group.data_ptr(), Tp, X.data_ptr(), n, F, base.data_ptr(),
            G, int(max_depth), out.data_ptr(),
            leaves.data_ptr() if leaves is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
    return out, leaves
