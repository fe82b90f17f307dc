"""One process-wide metrics registry + Prometheus text exposition.

The port's copy of the JAX package's ``obs/metrics.py``. Every part of
the serving stack that counts things (``serve.ServeMetrics``, each
``Server``'s live queue, the ``FleetRouter``) *registers a collector*
here instead of growing its own snapshot format. Collection is
pull-based (the Prometheus model): sources keep their state behind their
own locks and hand the registry a locked read on demand, so registration
adds nothing to the hot paths, and a dead source (a collected server)
drops out through its weakref.

Exposition follows the Prometheus text format 0.0.4: ``# HELP`` /
``# TYPE`` headers, ``_total`` counter suffixes, histograms as
cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``. When
two live sources emit the same (name, labels) sample (two servers in
one process), counter and histogram samples are summed and gauges keep
the last value collected.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Sample", "Family", "HistogramData", "MetricsRegistry",
           "get_registry", "render_families"]

LabelSet = Tuple[Tuple[str, str], ...]


class HistogramData:
    """One histogram labelset: cumulative ``(le, count)`` pairs (the final
    edge must be ``inf``), plus sum and count."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self, buckets: List[Tuple[float, int]], sum_: float,
                 count: int) -> None:
        self.buckets = buckets
        self.sum = sum_
        self.count = count


class Sample:
    __slots__ = ("labels", "value")

    def __init__(self, value, labels: LabelSet = ()) -> None:
        self.labels = labels
        self.value = value  # number, or HistogramData for histograms


class Family:
    """One metric family: a name, a kind, and its samples."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str,
                 samples: Iterable[Sample]) -> None:
        assert kind in ("counter", "gauge", "histogram"), kind
        self.name = name
        self.kind = kind
        self.help = help
        self.samples = list(samples)


_NAME_OK = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def sanitize(name: str) -> str:
    out = "".join(ch if ch in _NAME_OK else "_" for ch in name)
    return out if out and not out[0].isdigit() else "_" + out


def _fmt_value(v) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: LabelSet, extra: Optional[Tuple[str, str]] = None
                ) -> str:
    items = list(labels) + ([extra] if extra else [])
    if not items:
        return ""
    parts = []
    for k, v in items:
        ve = str(v).replace("\\", r"\\").replace('"', r'\"') \
                   .replace("\n", r"\n")
        parts.append(f'{sanitize(k)}="{ve}"')
    return "{" + ",".join(parts) + "}"


def render_families(families: List[Family]) -> str:
    """Prometheus text exposition 0.0.4 for a merged family list."""
    lines: List[str] = []
    for fam in sorted(families, key=lambda f: f.name):
        name = sanitize(fam.name)
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for s in fam.samples:
            if fam.kind == "histogram":
                h: HistogramData = s.value
                for le, cum in h.buckets:
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(s.labels, ('le', _fmt_value(le)))}"
                        f" {cum}")
                lines.append(f"{name}_sum{_fmt_labels(s.labels)} "
                             f"{_fmt_value(h.sum)}")
                lines.append(f"{name}_count{_fmt_labels(s.labels)} "
                             f"{h.count}")
            else:
                lines.append(f"{name}{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.value)}")
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Collector registry + a small set of direct counters/gauges.

    Direct counters (:meth:`inc`/:meth:`set_gauge`) serve code that has
    no natural stats object of its own (retry events, checkpoint
    flushes); everything stateful registers a collector instead.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # name -> (kind, help); shared across direct metrics
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._counters: Dict[Tuple[str, LabelSet], float] = {}
        self._gauges: Dict[Tuple[str, LabelSet], float] = {}
        # id -> (weakref-to-owner | None, collect(owner) -> List[Family])
        self._sources: Dict[int, Tuple[Optional[weakref.ref], Callable]] = {}
        self._next_id = 0

    # -------------------------------------------------------- direct metrics
    def inc(self, name: str, by: float = 1.0, labels: LabelSet = (),
            help: str = "") -> None:
        with self._lock:
            self._meta.setdefault(name, ("counter", help))
            key = (name, labels)
            self._counters[key] = self._counters.get(key, 0.0) + by

    def set_gauge(self, name: str, value: float, labels: LabelSet = (),
                  help: str = "") -> None:
        with self._lock:
            self._meta.setdefault(name, ("gauge", help))
            self._gauges[(name, labels)] = float(value)

    def get(self, name: str, labels: LabelSet = (), default: float = 0.0
            ) -> float:
        with self._lock:
            key = (name, labels)
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key, default)

    # ------------------------------------------------------------ collectors
    def register(self, collect: Callable[..., List[Family]],
                 owner: Optional[object] = None) -> int:
        """Add a collector. With ``owner``, ``collect(owner)`` is called
        on each collection and the registration dies with the owner
        (weakref — pass the *unbound* function, not a bound method).
        Without, ``collect()`` is called until :meth:`unregister`."""
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            ref = None
            if owner is not None:
                ref = weakref.ref(owner, lambda _r, s=sid: self.unregister(s))
            self._sources[sid] = (ref, collect)
            return sid

    def unregister(self, sid: int) -> None:
        with self._lock:
            self._sources.pop(sid, None)

    # ------------------------------------------------------------ collection
    def collect(self) -> List[Family]:
        """Merged family list: direct metrics + every live collector.
        Duplicate (name, labels) samples sum (counters/histograms) or
        keep the last value (gauges)."""
        with self._lock:
            metas = dict(self._meta)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            sources = list(self._sources.values())
        raw: List[Family] = []
        for name, (kind, hlp) in metas.items():
            store = counters if kind == "counter" else gauges
            samples = [Sample(v, lbls) for (n, lbls), v in store.items()
                       if n == name]
            if samples:
                raw.append(Family(name, kind, hlp, samples))
        for ref, fn in sources:
            if ref is not None:
                owner = ref()
                if owner is None:
                    continue
                fams = fn(owner)
            else:
                fams = fn()
            raw.extend(fams or [])
        return _merge(raw)

    def render_prometheus(self) -> str:
        return render_families(self.collect())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly view of every collected sample (debug surface;
        the exposition format is the contract)."""
        out: Dict[str, Any] = {}
        for fam in self.collect():
            for s in fam.samples:
                key = fam.name + "".join(f"{{{k}={v}}}" for k, v in s.labels)
                if isinstance(s.value, HistogramData):
                    out[key] = {"count": s.value.count,
                                "sum": s.value.sum}
                else:
                    out[key] = s.value
        return out


def _merge(raw: List[Family]) -> List[Family]:
    by_name: Dict[str, Family] = {}
    for fam in raw:
        cur = by_name.get(fam.name)
        if cur is None:
            by_name[fam.name] = Family(fam.name, fam.kind, fam.help,
                                       fam.samples)
            continue
        by_label: Dict[LabelSet, Sample] = {s.labels: s for s in cur.samples}
        for s in fam.samples:
            old = by_label.get(s.labels)
            if old is None:
                by_label[s.labels] = s
            elif cur.kind == "counter":
                by_label[s.labels] = Sample(old.value + s.value, s.labels)
            elif cur.kind == "histogram":
                by_label[s.labels] = Sample(_merge_hist(old.value, s.value),
                                            s.labels)
            else:  # gauge: last write wins
                by_label[s.labels] = s
        cur.samples = list(by_label.values())
    return list(by_name.values())


def _merge_hist(a: HistogramData, b: HistogramData) -> HistogramData:
    if len(a.buckets) != len(b.buckets):  # mismatched layouts: keep newest
        return b
    buckets = [(le, ca + cb) for (le, ca), (_, cb)
               in zip(a.buckets, b.buckets)]
    return HistogramData(buckets, a.sum + b.sum, a.count + b.count)


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every source registers into."""
    return _registry
