"""Quantized bin matrices: resident on the device, or paged from the host.

The port of the JAX package's ``data/binned.py BinnedMatrix``: a dense
``[n_rows, n_features]`` tensor of LOCAL bin ids with a uniform slot
count ``max_nbins = max_f n_real_bins(f) + has_missing``; when the data
holds a NaN, slot ``max_nbins - 1`` of every feature is its missing bin.
Bins are uint8 while the largest id fits a byte and uint16 above, the
layout policy of ``_matrix_layout`` / ``_dtype_for`` (so 256 real bins
plus a missing slot is uint16). Binning runs on the device:
``torch.searchsorted(side="left")`` against each feature's cuts, clamped
into the last real bin, NaN -> the missing bin (on the CPU for the
batches of an iterator).

:class:`PagedBinnedMatrix` is the external-memory tier (the JAX
package's class of that name): the bins stay in host memory (a memmap
under the iterator's ``cache_prefix``) and stream to the device in row
pages through a device page cache and a prefetch ring (module docstring
of ``tree/paged.py``), or, over a data mesh (:class:`PagedMeshMatrix`),
to each shard's device in blocks of its own rows. The ring records
``ring/upload`` and ``ring/blocked`` spans (``obs/trace.py``) and books
the page caches for the memory monitor (``obs/memory.py``).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import memory as _mem
from ..obs import trace as _trace
from .quantile import (FeatureSummary, HistogramCuts, WeightedSketch,
                       cuts_from_summaries)

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.uint16,
                 np.dtype(np.int32): torch.int32}


def np_dtype_for(max_local_bins: int) -> np.dtype:
    """The smallest of uint8 / uint16 / int32 that holds the bin ids."""
    if max_local_bins <= np.iinfo(np.uint8).max:
        return np.dtype(np.uint8)
    if max_local_bins <= np.iinfo(np.uint16).max:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def _dtype_for(max_local_bins: int) -> torch.dtype:
    return _TORCH_DTYPES[np_dtype_for(max_local_bins)]


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
    n_real = torch.from_numpy(cuts.n_real_bins().astype(np.int64)).to(
        X.device)
    return search_bin_t(X.t().contiguous(), table, n_real, missing_bin).t()


def search_bin_t(Xt: torch.Tensor, table: torch.Tensor,
                 n_real: torch.Tensor, missing_bin: int) -> torch.Tensor:
    """:func:`search_bin` over the transposed matrix Xt [F, n] against a
    cut table [F, W] (+inf padded) and the real-bin counts [F], all on
    one device -> [F, n] int64 bin ids."""
    b = torch.searchsorted(table, Xt, side="left")           # [F, n]
    b = torch.minimum(b, (n_real - 1)[:, None])
    return torch.where(torch.isnan(Xt), torch.full_like(b, missing_bin), b)


def values_of_bins(local: np.ndarray, cuts: HistogramCuts) -> np.ndarray:
    """Representative feature values [n, F] f32 of host bin ids (each
    bin's upper cut; NaN at the missing slot): what an iterator-built
    matrix, which keeps no raw values, predicts on (the JAX package's
    ``_values_page``)."""
    ptrs = np.asarray(cuts.ptrs[:-1], np.int64)
    vals = np.asarray(cuts.values, np.float32)
    n_real = cuts.n_real_bins().astype(np.int64)
    local = np.asarray(local, np.int64)
    gb = np.clip(ptrs[None, :] + np.minimum(local, n_real - 1), 0,
                 len(vals) - 1)
    page = vals[gb]
    page[local >= n_real[None, :]] = np.nan
    return page


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

    @property
    def shape(self):
        return tuple(self.bins.shape)

    @staticmethod
    def from_dense(X: np.ndarray, cuts: HistogramCuts,
                   device: torch.device) -> "BinnedMatrix":
        """Bin a dense f32 numpy matrix on ``device``."""
        Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(
            device)
        has_missing = bool(torch.isnan(Xd).any())
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(has_missing)
        b = search_bin(Xd, cuts, max(max_nbins - 1, 0))
        return BinnedMatrix.from_bin_ids(b, cuts, has_missing)

    is_paged = False

    @staticmethod
    def from_bin_ids(b: torch.Tensor, cuts: HistogramCuts,
                     has_missing: bool) -> "BinnedMatrix":
        """Bin ids [n, F] int64 from :func:`search_bin` (missing at
        ``max_nbins - 1`` of ``cuts``' layout) in the layout's dtype."""
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(has_missing)
        bins = b.to(_dtype_for(max(max_nbins - 1, 0))).contiguous()
        return BinnedMatrix(bins=bins, cuts=cuts, max_nbins=max_nbins,
                            has_missing=has_missing)

    @staticmethod
    def from_local_bins(local: np.ndarray, cuts: HistogramCuts,
                        max_nbins: int, has_missing: bool,
                        device: torch.device) -> "BinnedMatrix":
        """Host bin ids (missing already at ``max_nbins - 1``) copied to
        ``device``."""
        bins = torch.from_numpy(np.ascontiguousarray(local)).to(device)
        return BinnedMatrix(bins=bins, cuts=cuts, max_nbins=max_nbins,
                            has_missing=has_missing)


def _pack_into(arr: np.ndarray, out: np.ndarray) -> None:
    """u4-pack the bin ids ``arr`` [p, F] (each < 16) into ``out``
    [p, ceil(F/2)] uint8: byte w = feature 2w | feature 2w+1 << 4, the
    high nibble of the last byte zero when F is odd."""
    F = arr.shape[1]
    h = F // 2
    np.bitwise_or(arr[:, 0:2 * h:2], arr[:, 1:2 * h:2] << 4, out=out[:, :h])
    if F % 2:
        out[:, h] = arr[:, F - 1]


class _Staging:
    """The ring's device side: ``depth`` pinned host buffers of one page
    each, the copy stream, and the CUDA event of each buffer's last
    copy."""

    def __init__(self, depth: int, nbytes: int, device: torch.device) -> None:
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(depth)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * depth
        self.stream = torch.cuda.Stream(device)


@dataclass(eq=False)
class PagedBinnedMatrix:
    """Quantized matrix in HOST memory (numpy array or memmap), streamed
    to one device in row pages: the training counterpart of the
    reference's external-memory ``SparsePageDMatrix``, whose pages reach
    the updater through a prefetch ring
    (``src/data/sparse_page_source.h:180-200``). Per-row vectors
    (gradients, positions, margins) stay on the device.

    The page cache (``XTPU_PAGE_CACHE_BYTES``, default 4 GiB): a page
    uploaded on its first visit stays on the device while the cache
    holds fewer than ``budget // page_nbytes()`` pages; the others
    upload on every visit. The cache fills in page order and never
    evicts, so its pages are a prefix and ``cached + streamed`` is page
    order under every budget: a pass adds its pages' histograms in the
    same order whatever the budget.

    Compressed transport (``XTPU_PAGE_PACK``, default on): at
    ``max_nbins <= 16`` with uint8 bins a page ships and caches u4-packed,
    [p, ceil(F/2)] bytes (:meth:`_pack_host`); the histogram kernels read
    the packed page themselves and other consumers decode it
    (:meth:`decode_page`).

    The prefetch ring (``XTPU_PAGE_RING`` pages ahead, default 3): one
    worker thread reads each streamed page from host memory, packs it if
    needed, and, on the card, copies it through a pinned staging buffer
    on a copy stream, the buffer refilled only after its last copy's
    event; the consumer's stream waits on that event. On the CPU the
    ring yields tensors made straight from numpy.

    ``ring_stats``: ``upload_s`` (the worker's wall time reading and
    packing pages and, on the card, queueing their copies), ``blocked_s``
    (the consumer's wall time waiting for a page), ``uploads`` and
    ``bytes`` (pages and transport bytes shipped); reset with
    :meth:`reset_ring_stats`.

    Over a data mesh of ``world`` shards (:meth:`mesh_layout`,
    :meth:`stream_pages_sharded`) a mesh page is every shard's block of
    ``p_loc`` of its rows, each uploaded to its shard's device through
    that device's staging buffers; it costs :meth:`mesh_page_nbytes` of
    the same budget and caches apart from the pages of one device, under
    its local start (the shards of one card share a device name, so a
    cache keyed by device would mix their rows). The ring and its
    statistics are shared."""

    bins_host: np.ndarray
    cuts: HistogramCuts
    max_nbins: int
    has_missing: bool = True
    page_rows: int = 1_000_000
    cache_budget_bytes: int = -1      # -1: XTPU_PAGE_CACHE_BYTES or 4 GiB

    is_paged = True

    def __post_init__(self) -> None:
        # per device: {page start: (page end, device page)}
        self._device_cache: Dict[str, Dict[int, Tuple[int, torch.Tensor]]] = {}
        # a mesh's pages (:meth:`stream_pages_sharded`), by local start:
        # (local end, every shard's block); apart from ``_device_cache``,
        # whose key is a device, since a mesh's shards may share one
        self._mesh_cache: Dict[int, Tuple[int, List[torch.Tensor]]] = {}
        self._mesh_of = None       # the mesh (and rows) it holds
        self._staging: Dict[str, _Staging] = {}
        self._mesh_staging: Dict[str, _Staging] = {}
        self._resident: Optional[Tuple[str, BinnedMatrix]] = None
        self._stats_lock = threading.Lock()
        self.ring_stats = {"upload_s": 0.0, "blocked_s": 0.0, "uploads": 0,
                           "bytes": 0}
        if self.cache_budget_bytes < 0:
            self.set_cache_budget()
        self.packed = (os.environ.get("XTPU_PAGE_PACK", "1") != "0"
                       and self.max_nbins <= 16
                       and self.bins_host.dtype == np.uint8)
        self.ring_depth = max(1, int(os.environ.get("XTPU_PAGE_RING", 3)))

    # -- geometry -------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.bins_host.shape[0]

    @property
    def n_features(self) -> int:
        return self.bins_host.shape[1]

    @property
    def shape(self):
        return self.bins_host.shape

    @property
    def missing_bin(self) -> int:
        return self.max_nbins - 1 if self.has_missing else self.max_nbins

    def n_real_bins(self) -> np.ndarray:
        return np.asarray(self.cuts.n_real_bins())

    def n_pages(self) -> int:
        return max(-(-self.n_rows // self.page_rows), 1)

    def page_width(self) -> int:
        """Columns of a page in transport layout: ceil(F/2) packed."""
        return (self.n_features + 1) // 2 if self.packed else self.n_features

    def page_nbytes(self) -> int:
        """Device (and host-to-device) bytes of one full page in transport
        layout."""
        return (self.page_rows * self.page_width()
                * self.bins_host.dtype.itemsize)

    # -- pages ----------------------------------------------------------------
    @staticmethod
    def _pack_host(arr: np.ndarray) -> np.ndarray:
        """u4-pack a host page along the feature axis: byte w = feature 2w
        (low nibble) | feature 2w+1 << 4; an odd F pads a zero column."""
        out = np.empty((arr.shape[0], (arr.shape[1] + 1) // 2), np.uint8)
        _pack_into(arr, out)
        return out

    def decode_page(self, page: torch.Tensor) -> torch.Tensor:
        """A page in transport layout -> its [p, F] bin ids, for consumers
        other than the histogram kernels (the resident collapse, the
        margin walk over bins)."""
        if not self.packed:
            return page
        from ..ops.histogram import unpack_u4

        return unpack_u4(page, self.n_features)

    def _host_page(self, s: int, e: int, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """Rows [s, e) in transport layout, into ``out`` when given."""
        src = self.bins_host[s:e]
        if out is None:
            return (self._pack_host(src) if self.packed
                    else np.ascontiguousarray(src))
        if self.packed:
            _pack_into(src, out)
        else:
            np.copyto(out, src)
        return out

    @staticmethod
    def _key(device: torch.device) -> str:
        """One name for a device however it is spelled ("cuda" and a
        tensor's "cuda:0" name the same card)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return str(device)

    def _cache(self, device: torch.device):
        return self._device_cache.setdefault(self._key(device), {})

    def set_cache_budget(self, nbytes: Optional[int] = None) -> None:
        """A new page-cache budget (None: ``XTPU_PAGE_CACHE_BYTES``, or
        4 GiB); the cached pages are dropped, and the next pass fills the
        cache anew in page order."""
        if nbytes is None:
            nbytes = int(os.environ.get("XTPU_PAGE_CACHE_BYTES", 4 << 30))
        self.cache_budget_bytes = int(nbytes)
        self._drop_caches()

    def _drop_caches(self) -> None:
        """Drop the device page caches (one device's and a mesh's) and a
        resident collapse."""
        self._device_cache.clear()
        self._mesh_cache.clear()
        _mem.unbook("page_cache")
        _mem.unbook("page_cache/mesh")
        self._resident = None

    def reset_ring_stats(self) -> None:
        self.ring_stats.update(upload_s=0.0, blocked_s=0.0, uploads=0,
                               bytes=0)

    def streaming_overlap(self) -> Optional[float]:
        """The share of upload time hidden behind the consumer since the
        last :meth:`reset_ring_stats`, ``max(0, 1 - blocked / upload)``;
        None before any upload."""
        up = self.ring_stats["upload_s"]
        if up <= 0:
            return None
        return max(0.0, 1.0 - self.ring_stats["blocked_s"] / up)

    def _staging_of(self, device: torch.device) -> _Staging:
        st = self._staging.get(self._key(device))
        if st is None:
            st = self._staging[self._key(device)] = _Staging(
                self.ring_depth, self.page_nbytes(), device)
        return st

    def _page_bytes_at(self, s: int) -> int:
        return ((min(s + self.page_rows, self.n_rows) - s) * self.page_width()
                * self.bins_host.dtype.itemsize)

    def _fetch(self, s: int, slot: int, device: torch.device,
               raw: Optional[torch.Tensor] = None):
        """(start, (end, page), uploaded, bytes) of the page at ``s``: the
        cached page, or an upload through staging buffer ``slot`` into
        ``raw``, the page's device memory (uint8, allocated by the ring's
        consumer thread; new memory when None)."""
        e = min(s + self.page_rows, self.n_rows)
        hit = self._cache(device).get(s)
        if hit is not None:
            return s, hit, False, 0
        shape = (e - s, self.page_width())
        if device.type != "cuda":
            page = torch.from_numpy(self._host_page(s, e))
            return s, (e, page), True, page.numel() * page.element_size()
        st = self._staging_of(device)
        nbytes = self._page_bytes_at(s)
        ev = st.events[slot]
        if ev is not None:
            ev.synchronize()        # the buffer's last copy has completed
        host = st.bufs[slot][:nbytes]
        self._host_page(s, e, host.numpy().view(self.bins_host.dtype)
                        .reshape(shape))
        with torch.cuda.device(device), torch.cuda.stream(st.stream):
            if raw is None:
                raw = torch.empty(nbytes, dtype=torch.uint8, device=device)
            raw.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(st.stream)
        st.events[slot] = ev
        page = raw.view(_TORCH_DTYPES[self.bins_host.dtype]).view(shape)
        return s, (e, page, ev), True, nbytes

    def _ring(self, starts: List[int], fetch, alloc, cache: dict,
              unit_bytes: int, settle, book_key: str = "page_cache"):
        """``(start, end, payload)`` of the page ``starts`` in order, the
        prefetch ring shared by one device's pages and a mesh's
        (:meth:`stream_pages_sharded`): cached pages straight from
        ``cache``, the others uploaded ``ring_depth`` pages ahead by one
        worker thread, ``fetch(start, slot, raw) -> (start, (end,
        payload, ...), uploaded, bytes)``; an uploaded page joins
        ``cache`` while it holds fewer than ``cache_budget_bytes //
        unit_bytes``. The upload of page i + ``ring_depth`` is asked for
        as page i is taken, its device memory (``alloc(start)``, on the
        card) allocated then, on the consumer's thread, whatever the
        worker's progress: a consumer that lets go of each page before it
        takes the next (a pass, ``tree/paged.py _drive``) holds
        ``ring_depth + 1`` streamed pages at most, and at that from the
        first page on. ``settle(payload)`` makes the consumer's streams
        wait on an upload's events and records its memory on them (the
        caching allocator keeps it until their work on it is done). The
        cache's bytes are booked under ``book_key`` for the memory
        monitor's CPU accounting (``obs/memory.py``)."""
        self._resident = None      # streaming supersedes a collapse
        max_cached = self.cache_budget_bytes // unit_bytes if unit_bytes \
            else 0
        stats = self.ring_stats
        depth = self.ring_depth

        def timed_fetch(s, slot, raw):
            t0 = time.perf_counter()
            with _trace.span("ring/upload"):
                out = fetch(s, slot, raw)
            if out[2]:
                with self._stats_lock:
                    stats["upload_s"] += time.perf_counter() - t0
                    stats["uploads"] += 1
                    stats["bytes"] += out[3]
            return out

        def ask(ex, i):
            s = starts[i]
            raw = None if s in cache else alloc(s)
            return ex.submit(timed_fetch, s, i % depth, raw)

        with ThreadPoolExecutor(1) as ex:
            pending = deque(ask(ex, i) for i in range(min(depth, len(starts))))
            for i in range(len(starts)):
                t0 = time.perf_counter()
                with _trace.span("ring/blocked"):
                    s, payload, uploaded, _ = pending.popleft().result()
                if uploaded:
                    with self._stats_lock:
                        stats["blocked_s"] += time.perf_counter() - t0
                if i + depth < len(starts):
                    pending.append(ask(ex, i + depth))
                if uploaded:
                    payload = settle(payload)
                    if len(cache) < max_cached:
                        cache[s] = payload
                        _mem.book(book_key, len(cache) * unit_bytes)
                yield (s,) + tuple(payload)
                payload = None

    def _settle(self, device: torch.device, payload):
        """One device's upload: the consumer's stream waits on its event
        (see :meth:`_ring`)."""
        if device.type != "cuda":
            return payload
        e, page, ev = payload
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        page.record_stream(stream)
        return (e, page)

    def _alloc(self, device: torch.device, s: int):
        """A page's device memory, on the staging stream (see
        :meth:`_ring`); None off the card."""
        if device.type != "cuda":
            return None
        with torch.cuda.device(device), \
                torch.cuda.stream(self._staging_of(device).stream):
            return torch.empty(self._page_bytes_at(s), dtype=torch.uint8,
                               device=device)

    def stream_pages(self, starts: List[int], device: torch.device):
        """(start, end, device page) for the page ``starts`` through the
        ring, pages in transport layout."""
        if not starts or self.n_rows == 0:
            return
        fetch = self._fetch     # read once a pass
        yield from self._ring(
            list(starts), lambda s, slot, raw: fetch(s, slot, device, raw),
            lambda s: self._alloc(device, s), self._cache(device),
            self.page_nbytes(), lambda p: self._settle(device, p))

    def pages(self, device: torch.device):
        """(start, end, device page) of every page, in order."""
        yield from self.stream_pages(
            list(range(0, self.n_rows, self.page_rows)), device)

    def cached_split(self, device: torch.device):
        """``(cached, streamed)``: [(start, end, page)] of the pages in the
        device's cache and the starts of the pages that upload this visit;
        a prefix and the rest, so together they are in page order."""
        cache = self._cache(device)
        cached, streamed = [], []
        for s in range(0, self.n_rows, self.page_rows):
            hit = cache.get(s)
            if hit is None:
                streamed.append(s)
            else:
                cached.append((s, hit[0], hit[1]))
        return cached, streamed

    def cached_pages(self, device: torch.device) -> int:
        return len(self._cache(device))

    def resident_binned(self, device: torch.device) -> Optional[BinnedMatrix]:
        """A device-resident :class:`BinnedMatrix` of this matrix when all
        of it fits the page-cache budget (and ``XTPU_PAGED_COLLAPSE`` is
        not ``0``), else None. Pages copy into one preallocated buffer one
        at a time, each cache entry freed after its copy, so the peak is
        about the matrix plus one page. Only a device allocation failure
        (``torch.cuda.OutOfMemoryError``) is caught: it warns and the
        matrix keeps streaming on the same device."""
        if (self.bins_host.nbytes > self.cache_budget_bytes
                or os.environ.get("XTPU_PAGED_COLLAPSE") == "0"
                or self.n_rows == 0):
            return None
        key = self._key(device)
        if self._resident is None or self._resident[0] != key:
            cache = self._cache(device)
            bins = None
            try:
                for s, e, page in self.pages(device):
                    page = self.decode_page(page)
                    if bins is None:
                        bins = torch.empty((self.n_rows, self.n_features),
                                           dtype=page.dtype, device=device)
                    bins[s:e] = page
                    cache.pop(s, None)
            except torch.cuda.OutOfMemoryError as exc:
                warnings.warn(f"resident collapse of the paged matrix failed "
                              f"({exc}); it keeps streaming", stacklevel=2)
                cache.clear()
                _mem.unbook("page_cache")
                return None
            cache.clear()
            _mem.unbook("page_cache")
            self._resident = (key, BinnedMatrix(
                bins=bins, cuts=self.cuts, max_nbins=self.max_nbins,
                has_missing=self.has_missing))
        return self._resident[1]

    # -- host values ----------------------------------------------------------
    def _values_page(self, s: int) -> np.ndarray:
        """Representative feature values of one host page (NaN missing)."""
        return values_of_bins(self.bins_host[s:s + self.page_rows], self.cuts)

    def to_values_host(self) -> np.ndarray:
        """Representative feature values [n, F] f32 from the bin ids, page
        by page on the host."""
        out = np.empty((self.n_rows, self.n_features), np.float32)
        for s in range(0, self.n_rows, self.page_rows):
            page = self._values_page(s)
            out[s:s + page.shape[0]] = page
        return out

    # -- approx and appends ---------------------------------------------------
    def resketch(self, max_bin: int, hess: np.ndarray,
                 feature_types=None) -> "PagedBinnedMatrix":
        """A new quantization weighted by ``hess`` [n] (the JAX package's
        ``resketch``; ``tree_method="approx"`` over pages, reference
        ``GlobalApproxUpdater``): per page the representative values of
        the current bins (:meth:`_values_page`) are summarised per feature
        with the hessian as weights, the summaries merged and pruned to
        ``max_bin * 8`` as the iterator's are, the cuts made from them, and
        the pages re-binned one at a time into a new host matrix. Host
        work, and the JAX package's cuts and bins bit for bit: a value is
        its bin's, so a page's summary of a feature is its bins' weight
        sums (``np.bincount``, in row order from 0.0 as
        ``FeatureSummary.from_data`` sums ties) at the bins' values, and a
        page re-bins through a table of each old bin's new bin
        (:func:`search_bin` of the bins' values). Under a multi-rank
        communicator the summaries merge across the ranks first."""
        F, n = self.n_features, self.n_rows
        n_real = self.n_real_bins().astype(np.int64)
        B = self.max_nbins + 1
        # [B, F]: each bin's value (NaN at the missing slot and past the
        # real bins), the values of ``values_of_bins``
        table = values_of_bins(np.tile(np.arange(B)[:, None], (1, F)),
                               self.cuts)
        summaries = None
        for s in range(0, n, self.page_rows):
            page = np.asarray(self.bins_host[s:s + self.page_rows], np.int64)
            if not page.shape[0]:
                continue
            w = np.asarray(hess[s:s + page.shape[0]], np.float64)
            batch = []
            for f in range(F):
                ids = page[:, f]
                ok = ids < n_real[f]
                cnt = np.bincount(ids[ok], minlength=n_real[f])
                wsum = np.bincount(ids[ok], weights=w[ok],
                                   minlength=n_real[f])
                seen = cnt > 0
                batch.append(FeatureSummary(
                    table[:n_real[f], f][seen].astype(np.float64) + 0.0,
                    wsum[seen]))
            summaries = batch if summaries is None else [
                a.merge(b).prune(max_bin * 8)
                for a, b in zip(summaries, batch)]
        from ..parallel import collective

        if collective.is_distributed():
            # every rank's pages: the merge across ranks (the JAX
            # package's ``binned.py:800-819``)
            summaries = collective.merge_summaries(summaries or [], max_bin)
        cuts = cuts_from_summaries(summaries or [], max_bin, feature_types)
        max_nbins = (int(cuts.n_real_bins().max(initial=0))
                     + int(self.has_missing))
        dtype = np_dtype_for(max(max_nbins - 1, 0))
        new_ids = search_bin(torch.from_numpy(table), cuts,
                             max_nbins - 1).numpy().astype(dtype)    # [B, F]
        out = np.empty((n, F), dtype)
        cols = np.arange(F)[None, :]
        for s in range(0, n, self.page_rows):
            page = np.asarray(self.bins_host[s:s + self.page_rows], np.int64)
            out[s:s + page.shape[0]] = new_ids[page, cols]
        return PagedBinnedMatrix(
            bins_host=out, cuts=cuts, max_nbins=max_nbins,
            has_missing=self.has_missing, page_rows=self.page_rows,
            cache_budget_bytes=self.cache_budget_bytes)

    def append_rows(self, X: np.ndarray) -> None:
        """Bin raw rows X [m, F] against the frozen cuts and append them
        (the JAX package's ``append_rows``): the trees' split bins keep
        their meaning. A memmap grows its file and is mapped anew; the
        device page cache and a resident collapse are dropped."""
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"append_rows expects [n, {self.n_features}] features, "
                f"got {X.shape}")
        if not self.has_missing and np.isnan(X).any():
            raise ValueError(
                "appended rows contain missing values but this matrix was "
                "quantized without a missing slot; rebuild it from data "
                "that includes missing values (or impute the new rows)")
        old_n, F = self.bins_host.shape
        new_n = old_n + X.shape[0]
        host = self.bins_host
        if isinstance(host, np.memmap):
            path, dtype = host.filename, host.dtype
            host.flush()
            with open(path, "r+b") as fh:
                fh.truncate(new_n * F * dtype.itemsize)
            grown = np.memmap(path, mode="r+", dtype=dtype,
                              shape=(new_n, F))
        else:
            grown = np.empty((new_n, F), host.dtype)
            grown[:old_n] = host
        grown[old_n:] = search_bin(torch.from_numpy(X), self.cuts,
                                   self.max_nbins - 1).numpy()
        self.bins_host = grown
        self._drop_caches()

    # -- pages over a data mesh -----------------------------------------------
    def mesh_layout(self, world: int) -> Tuple[int, int, int]:
        """The rows over a mesh of ``world`` shards -> ``(n_pad, n_loc,
        p_loc)`` (the JAX package's ``mesh_layout``): shard d holds rows
        [d * n_loc, min((d + 1) * n_loc, n)); a mesh page is ``p_loc =
        ceil(min(page_rows, n) / world)`` rows of each shard, and
        ``n_loc`` is rounded up to a multiple of ``p_loc``, so that every
        shard's block of every page has one shape. Per-row vectors pad to
        ``n_pad = world * n_loc`` rows, the pad rows with zero gradient."""
        p_loc = max(1, -(-min(self.page_rows, max(self.n_rows, 1)) // world))
        n_loc = max(1, -(-self.n_rows // world))
        n_loc = -(-n_loc // p_loc) * p_loc
        return world * n_loc, n_loc, p_loc

    def mesh_page_nbytes(self, world: int) -> int:
        """Device (and host-to-device) bytes of one mesh page, every
        shard's block, in transport layout: what it costs the page-cache
        budget."""
        p_loc = self.mesh_layout(world)[2]
        return (world * p_loc * self.page_width()
                * self.bins_host.dtype.itemsize)

    def _mesh_block(self, s_loc: int, d: int, n_loc: int, p_loc: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """Shard ``d``'s block of the mesh page at local row ``s_loc``:
        its rows [d * n_loc + s_loc, + p_loc) in transport layout, the
        rows past the matrix at bin ``min(missing_bin, max_nbins - 1)``
        (the JAX package's fill), into ``out`` when given."""
        n = self.n_rows
        g0 = d * n_loc + s_loc
        k = max(0, min(g0 + p_loc, n) - g0)
        if out is None:
            out = np.empty((p_loc, self.page_width()), self.bins_host.dtype)
        src = self.bins_host[g0:g0 + k]
        fill = min(self.missing_bin, self.max_nbins - 1)
        if self.packed:
            if k:
                _pack_into(src, out[:k])
            if k < p_loc:
                out[k:] = self._pack_host(np.full(
                    (1, self.n_features), fill, self.bins_host.dtype))[0]
        else:
            if k:
                np.copyto(out[:k], src)
            out[k:] = fill
        return out

    def _mesh_staging_of(self, device: torch.device,
                         nbytes: int) -> _Staging:
        """The ring's staging buffers of one device of a mesh, each holding
        that device's blocks of one mesh page."""
        key = self._key(device)
        st = self._mesh_staging.get(key)
        if st is None or st.bufs[0].numel() != nbytes:
            st = self._mesh_staging[key] = _Staging(self.ring_depth, nbytes,
                                                    device)
        return st

    def _mesh_groups(self, devices) -> Dict[str, List[int]]:
        """The shards of each distinct device, in shard order."""
        groups: Dict[str, List[int]] = {}
        for d, dev in enumerate(devices):
            groups.setdefault(self._key(dev), []).append(d)
        return groups

    def _fetch_mesh(self, s_loc: int, slot: int, devices,
                    raws: Optional[List[Optional[torch.Tensor]]]):
        """(start, (end, blocks[, events]), uploaded, bytes) of the mesh
        page at local row ``s_loc``: the cached page, or each shard's
        block built on the host and, on the card, copied through its
        device's staging buffer ``slot`` into ``raws[d]`` (allocated by
        the consumer, :meth:`_ring`); a CPU shard's block is the host
        array itself."""
        world = len(devices)
        _, n_loc, p_loc = self.mesh_layout(world)
        hit = self._mesh_cache.get(s_loc)
        if hit is not None:
            return s_loc, hit, False, 0
        W, dt = self.page_width(), self.bins_host.dtype
        bb = p_loc * W * dt.itemsize
        blocks: List[Optional[torch.Tensor]] = [None] * world
        events = []
        for _, idxs in self._mesh_groups(devices).items():
            dev = torch.device(devices[idxs[0]])
            if dev.type != "cuda":
                for d in idxs:
                    blocks[d] = torch.from_numpy(self._mesh_block(
                        s_loc, d, n_loc, p_loc))
                continue
            st = self._mesh_staging_of(dev, len(idxs) * bb)
            ev = st.events[slot]
            if ev is not None:
                ev.synchronize()    # the buffer's last copies have completed
            buf = st.bufs[slot]
            with torch.cuda.device(dev), torch.cuda.stream(st.stream):
                for j, d in enumerate(idxs):
                    host = buf[j * bb:(j + 1) * bb]
                    self._mesh_block(s_loc, d, n_loc, p_loc,
                                     host.numpy().view(dt).reshape(p_loc, W))
                    raws[d].copy_(host, non_blocking=True)
                    blocks[d] = raws[d].view(_TORCH_DTYPES[dt]).view(p_loc,
                                                                    W)
                ev = torch.cuda.Event()
                ev.record(st.stream)
            st.events[slot] = ev
            events.append((dev, ev, idxs))
        payload = (s_loc + p_loc, blocks)
        if events:
            payload = payload + (events,)
        return s_loc, payload, True, world * bb

    def _alloc_mesh(self, devices, s_loc: int):
        """Each CUDA shard's device memory for one mesh page, on its
        device's staging stream (see :meth:`_ring`)."""
        if all(torch.device(d).type != "cuda" for d in devices):
            return None
        p_loc = self.mesh_layout(len(devices))[2]
        bb = p_loc * self.page_width() * self.bins_host.dtype.itemsize
        raws: List[Optional[torch.Tensor]] = [None] * len(devices)
        for _, idxs in self._mesh_groups(devices).items():
            dev = torch.device(devices[idxs[0]])
            if dev.type != "cuda":
                continue
            st = self._mesh_staging_of(dev, len(idxs) * bb)
            with torch.cuda.device(dev), torch.cuda.stream(st.stream):
                for d in idxs:
                    raws[d] = torch.empty(bb, dtype=torch.uint8, device=dev)
        return raws

    @staticmethod
    def _settle_mesh(payload):
        """A mesh page's uploads: each device's stream waits on its event
        and takes its blocks' memory (see :meth:`_ring`)."""
        if len(payload) == 2:
            return payload
        e, blocks, events = payload
        for dev, ev, idxs in events:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            for d in idxs:
                blocks[d].record_stream(stream)
        return (e, blocks)

    def _check_mesh(self, mesh) -> None:
        """The mesh cache holds one mesh's pages: another mesh (or a
        matrix that grew) starts it anew."""
        key = (tuple(self._key(d) for d in mesh.devices), self.n_rows)
        if self._mesh_of != key:
            self._mesh_cache.clear()
            _mem.unbook("page_cache/mesh")
            self._mesh_of = key

    def pages_sharded(self, mesh):
        """(local start, local end, every shard's block) of every mesh
        page, in order (the JAX package's ``pages_sharded``): external
        memory over a data mesh, each shard streaming its own rows
        (reference: ``SparsePageDMatrix`` under row split,
        ``src/data/sparse_page_dmatrix.cc``, one process a GPU; here one
        mesh shard a device, and a device may repeat)."""
        n_loc, p_loc = self.mesh_layout(mesh.size)[1:]
        yield from self.stream_pages_sharded(list(range(0, n_loc, p_loc)),
                                             mesh)

    def stream_pages_sharded(self, starts: List[int], mesh):
        """(local start, local end, blocks) for the mesh pages at the local
        ``starts``, through the ring: ``blocks[d]`` is shard d's
        [p_loc, page_width()] block on its device, in transport layout. A
        mesh page costs :meth:`mesh_page_nbytes` of the page-cache budget
        and caches, every shard's block in one entry, by its local start,
        apart from one device's pages."""
        if not starts:
            return
        self._check_mesh(mesh)
        devices = mesh.devices
        fetch = self._fetch_mesh
        yield from self._ring(
            list(starts), lambda s, slot, raw: fetch(s, slot, devices, raw),
            lambda s: self._alloc_mesh(devices, s), self._mesh_cache,
            self.mesh_page_nbytes(mesh.size), self._settle_mesh,
            "page_cache/mesh")

    def cached_split_mesh(self, mesh):
        """``(cached, streamed)`` of the mesh pages (see
        :meth:`cached_split`): [(local start, local end, blocks)] in the
        mesh cache and the local starts that upload this visit, a prefix
        and the rest."""
        self._check_mesh(mesh)
        n_loc, p_loc = self.mesh_layout(mesh.size)[1:]
        cached, streamed = [], []
        for s in range(0, n_loc, p_loc):
            hit = self._mesh_cache.get(s)
            if hit is None:
                streamed.append(s)
            else:
                cached.append((s, hit[0], hit[1]))
        return cached, streamed

    def cached_mesh_pages(self) -> int:
        return len(self._mesh_cache)


class PagedMeshMatrix:
    """A paged matrix over a data mesh, as the growers take it (the JAX
    package's paged branch of ``_make_sharded_train_state``): the bins
    stay on the host and stream to each shard in its own blocks
    (:meth:`PagedBinnedMatrix.stream_pages_sharded`); only per-row
    vectors (gradients, positions) live on the shards' devices, padded
    to ``n_pad`` rows (:meth:`PagedBinnedMatrix.mesh_layout`), the pad
    rows with zero gradient."""

    is_paged = True

    def __init__(self, paged: PagedBinnedMatrix, mesh) -> None:
        self.paged = paged
        self.mesh = mesh

    @property
    def layout(self) -> Tuple[int, int, int]:
        """``(n_pad, n_loc, p_loc)``, read at each call: a matrix that
        grew has another."""
        return self.paged.mesh_layout(self.mesh.size)

    @property
    def n_pad(self) -> int:
        return self.layout[0]

    @property
    def cuts(self) -> HistogramCuts:
        return self.paged.cuts

    @property
    def max_nbins(self) -> int:
        return self.paged.max_nbins

    @property
    def has_missing(self) -> bool:
        return self.paged.has_missing

    @property
    def shape(self):
        return (self.n_pad, self.paged.n_features)


class PagedApproxSource:
    """``tree_method="approx"`` over a paged matrix: :meth:`binned`
    re-sketches the pages with each class's hessian
    (:meth:`PagedBinnedMatrix.resketch`, host work) and hands the new
    paged matrix to the paged grower. ``seconds``: each re-sketch's wall
    time."""

    def __init__(self, paged: PagedBinnedMatrix, max_bin: int,
                 feature_types: Optional[List[str]] = None) -> None:
        self.paged = paged
        self.max_bin = max_bin
        self.feature_types = feature_types
        self.seconds: List[float] = []

    def binned(self, weights: torch.Tensor) -> PagedBinnedMatrix:
        t0 = time.perf_counter()
        out = self.paged.resketch(
            self.max_bin, weights.detach().cpu().numpy().astype(np.float64),
            self.feature_types)
        self.seconds.append(time.perf_counter() - t0)
        return out


class ApproxSource:
    """The training matrix of ``tree_method="approx"``: its raw values on
    the device (for a matrix built from an iterator, the values of its
    bins, :func:`values_of_bins`, as the JAX package sketches them) and
    their :class:`~.quantile.WeightedSketch`, built once.
    :meth:`binned` re-sketches with new weights and re-bins the resident
    values against the new cut table on the device."""

    def __init__(self, X: torch.Tensor, max_bin: int,
                 feature_types: Optional[List[str]] = None) -> None:
        self.Xt = X.t().contiguous()                              # [F, n]
        self.n_rows = X.shape[0]
        self.has_missing = bool(torch.isnan(self.Xt).any())
        self.sketch = WeightedSketch(X, max_bin, feature_types)

    def binned(self, weights: torch.Tensor) -> BinnedMatrix:
        """A :class:`BinnedMatrix` of the values under the cuts sketched
        with ``weights`` [n] (its ``max_nbins`` and dtype follow them)."""
        cuts, table, n_real = self.sketch.cuts(weights)
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(
            self.has_missing)
        b = search_bin_t(self.Xt, table, n_real, max(max_nbins - 1, 0))
        return BinnedMatrix.from_bin_ids(b.t(), cuts, self.has_missing)


def feature_pad_for_mesh(F: int, world: int) -> int:
    """The columns a column-split mesh pads the feature axis by, so that
    every shard holds an equal block (the JAX package's one definition of
    the rule: the bins, and the monotone, constraint-set and categorical
    arrays of every grower, ``TreeGrower.padded``, are padded by it)."""
    return (-F) % world


def pad_features_for_mesh(bm: BinnedMatrix, mesh) -> BinnedMatrix:
    """A resident matrix over a column-split mesh (the JAX package's
    ``pad_features_for_mesh``, reference ``DataSplitMode::kCol``): the
    features padded to a multiple of the mesh's size with bin-0 columns
    whose real-bin count is 0 (they never win a split), then cut into
    the mesh's equal blocks of features, every row on every shard. The
    result's ``bins`` is a ``tree/shards.py ColShards``."""
    from ..tree.shards import ColShards

    return BinnedMatrix(bins=ColShards.split_matrix(bm.bins, mesh),
                        cuts=bm.cuts, max_nbins=bm.max_nbins,
                        has_missing=bm.has_missing)


def shard_binned(bm: BinnedMatrix, mesh) -> BinnedMatrix:
    """A resident matrix over a data mesh (the JAX package's
    ``_make_sharded_train_state``): rows padded to a multiple of the
    mesh's size with rows at bin ``min(missing_bin, max_nbins - 1)`` (any
    in-range bin: the trainer gives pad rows zero gradient, the weight-0
    rows of the JAX package), then cut into the mesh's equal blocks of
    rows, each on its device (``tree/shards.py RowShards``). The result's
    ``bins`` is that ``RowShards``."""
    from ..tree.shards import RowShards

    bins = bm.bins
    n, F = bins.shape
    n_pad = -(-n // mesh.size) * mesh.size
    if n_pad > n:
        fill = torch.full((n_pad - n, F), min(bm.missing_bin,
                                              bm.max_nbins - 1),
                          dtype=bins.dtype, device=bins.device)
        bins = torch.cat([bins, fill])
    return BinnedMatrix(bins=RowShards.split_matrix(bins, mesh),
                        cuts=bm.cuts, max_nbins=bm.max_nbins,
                        has_missing=bm.has_missing)


class MeshApproxSource:
    """``tree_method="approx"`` over a data mesh: the sketch of ``inner``
    (an :class:`ApproxSource` over every local row, or sharded
    ingestion's source, whose sketch merges across ranks) with the real
    rows' hessians, the matrix re-binned and cut into the mesh's shards
    (:func:`shard_binned`). Every shard bins with the same cuts: the
    sketch synchronised over the shards (the JAX package's
    ``gbtree.py:331-354``). ``col``: a column mesh, whose shards take
    every row of a block of the re-binned features
    (:func:`pad_features_for_mesh`, the JAX package's
    ``gbtree.py:378-390``); rows are not padded."""

    def __init__(self, inner, mesh, col: bool = False) -> None:
        self.inner = inner
        self.mesh = mesh
        self.col = col
        self.n = inner.n_rows
        self.n_pad = self.n if col else -(-self.n // mesh.size) * mesh.size

    def binned(self, weights: torch.Tensor) -> BinnedMatrix:
        """``weights`` [n_pad]: the padded rows' hessians."""
        layout = pad_features_for_mesh if self.col else shard_binned
        return layout(self.inner.binned(weights[:self.n]), self.mesh)
