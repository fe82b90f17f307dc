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
- :mod:`~.training_log`: the per-round training log.

The flight recorder, the insight telemetry and ``python -m ... obs``
are ROADMAP A.10.
"""

from . import memory, metrics, monitor, trace
from .metrics import Family, HistogramData, MetricsRegistry, Sample, \
    get_registry
from .monitor import Monitor, Timer, annotate, profile
from .trace import Span, Tracer, span
from .training_log import TrainingLog

__all__ = [
    "trace", "metrics", "memory", "monitor",
    "Span", "Tracer", "span", "TrainingLog",
    "MetricsRegistry", "Family", "Sample", "HistogramData", "get_registry",
    "Monitor", "Timer", "annotate", "profile",
]
