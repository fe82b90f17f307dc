from . import (adaptive, multiclass, ranking, regression,  # noqa: F401
               survival)                                   # (register)
from .base import OBJECTIVES, Objective, get_objective

__all__ = ["OBJECTIVES", "Objective", "get_objective"]
