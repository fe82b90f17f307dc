from .base import METRICS, Metric, get_metric
from . import elementwise, multiclass  # noqa: F401  (register metrics)

__all__ = ["METRICS", "Metric", "get_metric"]
