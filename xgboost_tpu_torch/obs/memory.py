"""Device-memory accounting: samples at stage boundaries, and watermarks.

The port of the JAX package's ``obs/memory.py``. A
:class:`MemoryMonitor` reads the CUDA caching allocator's counters
(``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
``allocated_bytes.all.peak``, summed over the distinct CUDA devices in
use) at the stage boundaries the drivers mark (``round``,
``paged/level``, ``serve/batch``), and keeps a live watermark and the
peak of each round. The peak is the allocator's own, so an allocation
that came and went between two samples still counts; the monitor
restarts the allocator's peak counters when it starts and at each round
boundary (``torch.cuda.reset_peak_memory_stats``), so a process that
reads those counters itself should not run it beside. Both reach the
metrics registry as ``xtpu_hbm_bytes_in_use`` and
``xtpu_hbm_peak_bytes`` (the JAX package's names: "hbm" is the card's
device memory here).

Without a CUDA device (the CPU) the monitor counts EXPLICIT bookings
instead, as the JAX package does on backends without allocator stats:
the paged tier books its device page cache (``data/binned.py``) and the
round loop books the margin cache (``core.py``).

Sampling is off by default, and the disabled path is free: the module's
:func:`sample` / :func:`book` / :func:`unbook` / :func:`note_round` are
one test each when no monitor is installed (``tests/test_torch_obs.py``
holds this to zero allocations).

Knob, read at import (:func:`enable` / :func:`disable` switch at run
time):

- ``XTPU_FLIGHT_MEM``: ``1`` turns sampling on (default ``0``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Set

from .metrics import Family, Sample, get_registry

__all__ = ["MemoryMonitor", "enable", "disable", "enabled", "monitor",
           "sample", "book", "unbook", "note_round", "watch_device"]


class MemoryMonitor:
    """Watermarks over the CUDA allocator's counters, or over explicit
    bookings where no CUDA device is in use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bookings: Dict[str, int] = {}
        self._booked = 0                 # the bookings' sum, bytes
        self._devices: Set[int] = set()  # CUDA device indices read
        self.live_bytes = 0
        self.peak_bytes = 0
        self.samples = 0
        self.source = "booked"           # "device" once a card is read
        self._round_peak = 0
        self._round_peaks: list = []     # each round's peak, bytes
        self._last_tag = ""
        self._restart_peaks()

    @staticmethod
    def _restart_peaks(devices=None) -> None:
        """Restart the CUDA allocator's peak counters (of ``devices``,
        else of every visible card), so that a peak read later is the
        window's own."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        for d in (range(torch.cuda.device_count()) if devices is None
                  else devices):
            torch.cuda.reset_peak_memory_stats(d)

    # -- the device read ------------------------------------------------------
    def watch(self, index: int) -> None:
        """Read CUDA device ``index`` at every sample from now on."""
        with self._lock:
            self._devices.add(int(index))

    def _device_bytes(self):
        """(current, peak) allocated bytes summed over the watched CUDA
        devices (the current device when none is watched yet), or None
        without CUDA."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        devs = self._devices or {torch.cuda.current_device()}
        cur = peak = 0
        for d in sorted(devs):
            st = torch.cuda.memory_stats(d)
            cur += int(st.get("allocated_bytes.all.current", 0))
            peak += int(st.get("allocated_bytes.all.peak", 0))
        return cur, peak

    # -- sampling -------------------------------------------------------------
    def sample(self, tag: str = "") -> int:
        """One watermark sample -> the live bytes."""
        dev = self._device_bytes()
        with self._lock:
            if dev is not None:
                self.source = "device"
                live, peak = dev
            else:
                live = peak = self._booked
            self.live_bytes = live
            self.peak_bytes = max(self.peak_bytes, peak)
            self._round_peak = max(self._round_peak, peak)
            self.samples += 1
            self._last_tag = tag
        return live

    def book(self, key: str, nbytes: int) -> None:
        """Count ``nbytes`` live under ``key`` (the CPU's accounting);
        booking a key again replaces its size."""
        nbytes = int(nbytes)
        with self._lock:
            self._booked += nbytes - self._bookings.get(key, 0)
            self._bookings[key] = nbytes

    def unbook(self, key: str) -> None:
        with self._lock:
            self._booked -= self._bookings.pop(key, 0)

    def note_round(self) -> None:
        """Close the current round's peak window (a bounded history). On
        the card the allocator's peak counters restart (as they do when
        the monitor starts), so the next round's peak is its own."""
        with self._lock:
            self._round_peaks.append(self._round_peak)
            if len(self._round_peaks) > 4096:
                del self._round_peaks[:2048]
            self._round_peak = self.live_bytes
            devs = sorted(self._devices) if self.source == "device" else []
        if devs:
            self._restart_peaks(devs)

    # -- reading --------------------------------------------------------------
    def peak_per_round(self) -> int:
        """The largest round peak seen (the overall peak before the first
        round boundary)."""
        with self._lock:
            if self._round_peaks:
                return max(self._round_peaks)
            return self.peak_bytes

    def round_peaks(self) -> list:
        """Each closed round's peak, oldest first."""
        with self._lock:
            return list(self._round_peaks)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "live_bytes": self.live_bytes,
                "peak_bytes": self.peak_bytes,
                "samples": self.samples,
                "source": self.source,
                "last_tag": self._last_tag,
                "rounds": len(self._round_peaks),
                "hbm_peak_bytes_per_round": (max(self._round_peaks)
                                             if self._round_peaks
                                             else self.peak_bytes),
                "bookings": dict(self._bookings),
            }

    # -- registry -------------------------------------------------------------
    def _collect(self):
        with self._lock:
            live, peak, n = self.live_bytes, self.peak_bytes, self.samples
        return [
            Family("xtpu_hbm_bytes_in_use", "gauge",
                   "live device-memory watermark, bytes",
                   [Sample(float(live))]),
            Family("xtpu_hbm_peak_bytes", "gauge",
                   "peak device-memory watermark, bytes",
                   [Sample(float(peak))]),
            Family("xtpu_hbm_samples_total", "counter",
                   "memory watermark samples taken",
                   [Sample(float(n))]),
        ]


# ---- module state -------------------------------------------------------------

_monitor: Optional[MemoryMonitor] = None
_collector_sid: Optional[int] = None


def enable() -> MemoryMonitor:
    """Install the process's memory monitor (idempotent)."""
    global _monitor, _collector_sid
    if _monitor is None:
        _monitor = MemoryMonitor()
        _collector_sid = get_registry().register(MemoryMonitor._collect,
                                                 owner=_monitor)
    return _monitor


def disable() -> None:
    global _monitor, _collector_sid
    if _monitor is not None:
        if _collector_sid is not None:
            get_registry().unregister(_collector_sid)
            _collector_sid = None
        _monitor = None


def enabled() -> bool:
    return _monitor is not None


def monitor() -> Optional[MemoryMonitor]:
    return _monitor


def watch_device(device) -> None:
    """Read ``device`` (a CUDA ``torch.device``) at every sample; a no-op
    for other devices and when sampling is off."""
    m = _monitor
    if m is not None and getattr(device, "type", None) == "cuda":
        import torch

        m.watch(device.index if device.index is not None
                else torch.cuda.current_device())


def sample(tag: str = "") -> None:
    """The stage-boundary hook. Disabled: one test, no allocation."""
    m = _monitor
    if m is not None:
        m.sample(tag)


def book(key: str, nbytes: int) -> None:
    """The explicit-booking hook (the CPU's accounting); free when
    disabled."""
    m = _monitor
    if m is not None:
        m.book(key, nbytes)


def unbook(key: str) -> None:
    m = _monitor
    if m is not None:
        m.unbook(key)


def note_round() -> None:
    """The round-boundary hook; free when disabled."""
    m = _monitor
    if m is not None:
        m.note_round()


if os.environ.get("XTPU_FLIGHT_MEM", "0") not in ("0", ""):
    enable()
