from .base import METRICS, Metric, get_metric
from . import elementwise  # noqa: F401  (registers the metrics)

__all__ = ["METRICS", "Metric", "get_metric"]
