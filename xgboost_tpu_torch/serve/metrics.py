"""Serving observability: per-stage latency histograms + counters.

The pipeline is measured at five stages per batch — ``queue`` (submit ->
batch formation), ``pad`` (host assembly + bucket padding), ``h2d``
(copy from a pinned buffer onto the device), ``compute`` (walk +
transform until the device is done), ``d2h`` (copy back) — plus
per-request ``e2e``. Histograms are fixed log-spaced buckets (factor
``10^(1/20)`` ~= 1.12, so interpolated percentiles carry <~6% relative
error): recording is O(1) and snapshots are mergeable.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Sequence

STAGES = ("queue", "pad", "h2d", "compute", "d2h", "e2e")


class LatencyHistogram:
    """Log-spaced latency histogram over [lo, hi) seconds."""

    def __init__(self, lo: float = 1e-5, hi: float = 600.0,
                 per_decade: int = 20) -> None:
        self._lo = lo
        self._ratio = 10.0 ** (1.0 / per_decade)
        self._log_ratio = math.log(self._ratio)
        n = int(math.ceil(math.log(hi / lo) / self._log_ratio))
        # counts[0] = under lo; counts[-1] = over hi
        self.counts: List[int] = [0] * (n + 2)
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def _index(self, seconds: float) -> int:
        if seconds < self._lo:
            return 0
        i = 1 + int(math.log(seconds / self._lo) / self._log_ratio)
        return min(i, len(self.counts) - 1)

    def observe(self, seconds: float) -> None:
        self.counts[self._index(seconds)] += 1
        self.total += seconds
        self.n += 1
        if seconds > self.max:
            self.max = seconds

    def _edge(self, i: int) -> float:
        """Upper edge of bucket i (seconds)."""
        return self._lo * self._ratio ** i

    def percentile(self, p: float) -> float:
        """p in [0, 100]; log-interpolated within the crossing bucket.
        0.0 when empty."""
        if self.n == 0:
            return 0.0
        target = self.n * min(max(p, 0.0), 100.0) / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i == 0:
                    return self._lo
                lo_e, hi_e = self._edge(i - 1), self._edge(i)
                frac = (target - cum) / c
                return min(lo_e * (hi_e / lo_e) ** frac, self.max)
            cum += c
        return self.max

    def summary_ms(self) -> Dict[str, float]:
        mean = (self.total / self.n) if self.n else 0.0
        return {"count": self.n,
                "mean_ms": mean * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "max_ms": self.max * 1e3}


class ServeMetrics:
    """Counters + stage histograms behind one small lock.

    Counters: requests, rows, batches, batch_rows_padded, sheds,
    deadline_exceeded, errors, swaps, warmup_batches — anything
    incremented via :meth:`inc`. Bucket hits are tracked per bucket size.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.bucket_hits: Dict[int, int] = {}
        self.hists: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram() for s in STAGES}
        self.started_at = time.time()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def get_many(self, names: Sequence[str]) -> Dict[str, int]:
        """One locked read for several counters — a consistent cut."""
        with self._lock:
            return {n: self.counters.get(n, 0) for n in names}

    def hit_bucket(self, size: int, padded_rows: int) -> None:
        with self._lock:
            self.bucket_hits[size] = self.bucket_hits.get(size, 0) + 1
            self.counters["batch_rows_padded"] = (
                self.counters.get("batch_rows_padded", 0) + padded_rows)

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.hists[stage].observe(seconds)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "uptime_s": time.time() - self.started_at,
                "counters": dict(self.counters),
                "bucket_hits": {str(k): v
                                for k, v in sorted(self.bucket_hits.items())},
                "stages": {s: h.summary_ms()
                           for s, h in self.hists.items() if h.n},
            }
