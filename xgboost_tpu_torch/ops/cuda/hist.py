"""ctypes wrappers of the Hopper histogram kernels (``csrc/hist.cu``):
K2 (``hist_int8x2_cuda``), K3 (``hist_f32_cuda``) and K4
(``hist_scan_cuda``)."""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import build

# launches of each kernel in this process (the counts chip_smoke.py reads
# to show that the main path went through the kernels)
LAUNCHES: Dict[str, int] = {"hist_int8x2": 0, "hist_f32": 0, "hist_scan": 0}
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
            fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, i, p, p, p]
        elif name == "hist_int8x2":
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, i, p, p, p]
        else:                                        # hist_scan: + work
            fn.argtypes = [p, i, p, p, p, ll, i, i, i, i, p, p, p, p]
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


def _common(bins: torch.Tensor, rel: torch.Tensor, n_nodes: int,
            max_nbins: int):
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
    _check("rel", rel, torch.int32, dev, (n,))
    if n_nodes < 1 or max_nbins < 1 or F < 1:
        raise ValueError(f"bad histogram geometry: nodes={n_nodes}, "
                         f"bins={max_nbins}, features={F}")
    return dev, n, F


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins):
    dev, n, F = _common(bins, rel, n_nodes, max_nbins)
    if n * 128 >= 2 ** 31:
        raise ValueError(f"{n} rows overflow the int32 int8x2 counters")
    _check("q", q, torch.int32, dev, (n, 2))
    _check("inv", inv, torch.float32, dev, (2,))
    acc = torch.empty((n_nodes * F * max_nbins * 4,), dtype=torch.int32,
                      device=dev)
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    return dev, n, F, acc, out


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
    dev, n, F, acc, out = _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins)
    _launch("hist_int8x2", dev, bins.data_ptr(), _BIN_BYTES[bins.dtype],
            rel.data_ptr(), q.data_ptr(), inv.data_ptr(), n, F, max_nbins,
            n_nodes, _num_sms(dev), acc.data_ptr(), out.data_ptr())
    return out


def hist_scan_cuda(bins: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                   inv: torch.Tensor, n_nodes: int,
                   max_nbins: int) -> torch.Tensor:
    """K4 on the card: K2's function (the same arguments, the same bits),
    built over the rows counting-sorted by node so that one node's
    [F, B, 4] counters share one shared-memory tile at any level width.
    Computes ``build_hist_scan_reference``'s function bit for bit.
    Replaces the TPU kernel ``xgboost_tpu/ops/pallas/histogram.py
    _make_scan_kernel``. Launches on the current stream and does not
    synchronise."""
    dev, n, F, acc, out = _int8x2_args(bins, q, rel, inv, n_nodes, max_nbins)
    work = torch.empty((3 * n_nodes + 1 + n,), dtype=torch.int32, device=dev)
    _launch("hist_scan", dev, bins.data_ptr(), _BIN_BYTES[bins.dtype],
            rel.data_ptr(), q.data_ptr(), inv.data_ptr(), n, F, max_nbins,
            n_nodes, _num_sms(dev), work.data_ptr(), acc.data_ptr(),
            out.data_ptr())
    return out


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
    dev, n, F = _common(bins, rel, n_nodes, max_nbins)
    _check("gpair", gpair, torch.float32, dev, (n, 2))
    _check("qscale", qscale, torch.float32, dev, (2,))
    _check("inv", inv, torch.float32, dev, (2,))
    acc = torch.empty((n_nodes * F * max_nbins * 2,), dtype=torch.int64,
                      device=dev)
    out = torch.empty((n_nodes, F, max_nbins, 2), dtype=torch.float32,
                      device=dev)
    _launch("hist_f32", dev, bins.data_ptr(), _BIN_BYTES[bins.dtype],
            rel.data_ptr(), gpair.data_ptr(), qscale.data_ptr(),
            inv.data_ptr(), n, F, max_nbins, n_nodes, _num_sms(dev),
            acc.data_ptr(), out.data_ptr())
    return out
