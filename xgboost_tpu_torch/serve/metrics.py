"""Serving observability: per-stage latency histograms + counters.

The pipeline is measured at five stages per batch — ``queue`` (submit ->
batch formation), ``pad`` (host assembly + bucket padding), ``h2d``
(copy from a pinned buffer onto the device), ``compute`` (walk +
transform until the device is done), ``d2h`` (copy back) — plus
per-request ``e2e``; a contribs call adds ``shap`` (its whole call).
Histograms are fixed log-spaced buckets (factor ``10^(1/20)`` ~= 1.12,
so interpolated percentiles carry <~6% relative error): recording is
O(1) and snapshots are mergeable. Each ``ServeMetrics`` registers a
collector with the process-wide registry (``obs/metrics.py``), which
``GET /metrics`` renders.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..obs.metrics import Family, HistogramData, Sample, get_registry

STAGES = ("queue", "pad", "h2d", "compute", "d2h", "e2e", "shap")

# always exposed (at 0 before the first increment): pre-declared series
# let rate()/increase() see the first real increment, and give scrape
# consumers a stable schema to alert on. "recompiles" is the serving
# captures made since warmup (``buckets.py RecompileCounter``), written
# at each periodic log line as the JAX package writes its executable-
# cache misses.
CORE_COUNTERS = ("requests", "rows", "batches", "sheds",
                 "deadline_exceeded", "errors", "swaps", "rollbacks",
                 "recompiles")


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
    deadline_exceeded, errors, swaps, rollbacks, evictions,
    warmup_batches, contrib_requests, contrib_rows — anything
    incremented via :meth:`inc`. Bucket hits are tracked per bucket size.
    ``labels`` is stamped on every exposed sample (a fleet replica's
    ``(("replica", "r0"),)``).
    """

    def __init__(self, labels: Sequence = ()) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.bucket_hits: Dict[int, int] = {}
        self.hists: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram() for s in STAGES}
        self.started_at = time.time()
        self.labels = tuple(tuple(kv) for kv in labels)
        # weakref registration: a collected server's metrics drop out of
        # /metrics on their own
        get_registry().register(ServeMetrics._collect_obs, owner=self)

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def set(self, name: str, value: int) -> None:
        """Overwrite a gauge-style counter (``recompiles``) under the lock
        that :meth:`inc` and :meth:`snapshot` hold."""
        with self._lock:
            self.counters[name] = value

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

    def percentile_ms(self, stage: str, p: float) -> float:
        with self._lock:
            return self.hists[stage].percentile(p) * 1e3

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

    def report_line(self, extra: Optional[Dict[str, object]] = None) -> str:
        """One-line periodic log summary (``ServeConfig.log_every_s``)."""
        with self._lock:
            c = self.counters
            e2e = self.hists["e2e"]
            q = self.hists["queue"]
            parts = [
                f"serve: req={c.get('requests', 0)}",
                f"rows={c.get('rows', 0)}",
                f"batches={c.get('batches', 0)}",
                f"shed={c.get('sheds', 0)}",
                f"deadline={c.get('deadline_exceeded', 0)}",
                f"recompiles={c.get('recompiles', 0)}",
                f"p50={e2e.percentile(50) * 1e3:.2f}ms",
                f"p99={e2e.percentile(99) * 1e3:.2f}ms",
                f"queue_p99={q.percentile(99) * 1e3:.2f}ms",
            ]
        if extra:
            parts += [f"{k}={v}" for k, v in extra.items()]
        return " ".join(parts)

    # ------------------------------------------------------- obs collector
    def _collect_obs(self) -> List[Family]:
        """Registry collector: counters as ``xtpu_serve_<name>_total``,
        bucket hits labeled by ladder size, stage latencies as one
        Prometheus histogram family labeled by stage."""
        with self._lock:
            counters = {**{k: 0 for k in CORE_COUNTERS}, **self.counters}
            hits = dict(self.bucket_hits)
            hist_rows = [(s, list(h.counts), h.total, h.n, h._lo, h._ratio)
                         for s, h in self.hists.items() if h.n]
            uptime = time.time() - self.started_at
        lab = self.labels
        fams = [
            Family("xtpu_serve_uptime_seconds", "gauge",
                   "seconds since ServeMetrics construction",
                   [Sample(round(uptime, 3), lab)]),
        ]
        for name, v in sorted(counters.items()):
            fams.append(Family(f"xtpu_serve_{name}_total", "counter",
                               f"serve counter {name!r}", [Sample(v, lab)]))
        if hits:
            fams.append(Family(
                "xtpu_serve_bucket_hits_total", "counter",
                "device batches per ladder bucket size",
                [Sample(v, lab + (("bucket", str(k)),))
                 for k, v in sorted(hits.items())]))
        samples = []
        for stage, counts, total, n, lo, ratio in hist_rows:
            cum = 0
            buckets = []
            for i, c in enumerate(counts[:-1]):
                cum += c
                buckets.append((lo * ratio ** i, cum))
            buckets.append((math.inf, cum + counts[-1]))
            samples.append(Sample(HistogramData(buckets, total, n),
                                  lab + (("stage", stage),)))
        if samples:
            fams.append(Family(
                "xtpu_serve_stage_latency_seconds", "histogram",
                "per-stage serving latency "
                "(queue/pad/h2d/compute/d2h/e2e/shap)", samples))
        return fams
