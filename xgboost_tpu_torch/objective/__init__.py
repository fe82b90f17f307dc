from . import regression  # noqa: F401  (registers the objectives)
from .base import OBJECTIVES, Objective, get_objective

__all__ = ["OBJECTIVES", "Objective", "get_objective"]
