from . import multiclass, ranking, regression  # noqa: F401  (register objectives)
from .base import OBJECTIVES, Objective, get_objective

__all__ = ["OBJECTIVES", "Objective", "get_objective"]
