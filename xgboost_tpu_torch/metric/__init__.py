from .base import METRICS, Metric, get_metric
from . import (auc, elementwise, multiclass, rank_metric,  # noqa: F401
               survival_metric)

__all__ = ["METRICS", "Metric", "get_metric"]
