"""Observability: the Prometheus metrics registry (``obs/metrics.py``)
and the training log (``obs/training_log.py``).
Traces, memory accounting and the model insight report are ROADMAP
A.10."""
