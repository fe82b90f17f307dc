"""Observability: the Prometheus metrics registry (``obs/metrics.py``).
Traces, memory accounting and the model insight report are ROADMAP
A.10."""
