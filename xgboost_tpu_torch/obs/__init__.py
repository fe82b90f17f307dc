"""Observability (the port of the JAX package's ``obs/``):

- :mod:`~.trace`: ring-buffered host spans, each named on the
  ``torch.profiler`` timeline too; ``XTPU_TRACE=1`` turns it on, and it
  exports Chrome / Perfetto JSON or jsonl.
- :mod:`~.metrics`: the process-wide :class:`MetricsRegistry` that the
  serving stack, the memory monitor and the page ring's accounting
  register into, rendered as Prometheus text on the front end's
  ``GET /metrics``.
- :mod:`~.monitor`: the wall-clock :class:`Monitor` by label
  (``utils/timer.py`` and ``logging_utils.py`` re-export it), whose
  ``sync=True`` mode times device work.
- :mod:`~.memory`: device-memory watermarks at stage boundaries (the
  CUDA allocator's counters; explicit bookings on the CPU) behind
  ``XTPU_FLIGHT_MEM=1``.
- :mod:`~.flight`: the flight recorder: ``(rank, world)``-tagged rings,
  clock-aligned merging of several ranks' rings, the overlap arithmetic,
  and the crash black box (``python -m xgboost_tpu_torch.obs postmortem
  <bundle>`` renders a bundle, ``merge`` joins rings).
- :mod:`~.insight`: learning-health telemetry (round scalars and the
  in-carry eval behind ``XTPU_INSIGHT`` / ``XTPU_INSIGHT_EVAL``), the
  :class:`TrainingLog` (``obs/training_log.py`` re-exports it), and the
  model report and diff.
"""

from . import flight, insight, memory, metrics, monitor, trace
from .flight import BlackBox, FlightRecorder, StragglerWarning
from .insight import TrainingLog
from .metrics import Family, HistogramData, MetricsRegistry, Sample, \
    get_registry
from .monitor import Monitor, Timer, annotate, profile
from .trace import Span, Tracer, span

__all__ = [
    "trace", "metrics", "flight", "memory", "insight", "monitor",
    "Span", "Tracer", "span", "TrainingLog",
    "FlightRecorder", "BlackBox", "StragglerWarning",
    "MetricsRegistry", "Family", "Sample", "HistogramData", "get_registry",
    "Monitor", "Timer", "annotate", "profile",
]
