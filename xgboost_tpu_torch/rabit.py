"""Deprecated rabit compatibility shim (reference
``python-package/xgboost/rabit.py`` keeps the pre-collective API alive;
the JAX package's ``rabit.py``). Every call forwards to
:mod:`xgboost_tpu_torch.parallel.collective`."""

from __future__ import annotations

import warnings
from typing import Any, List, Optional

import numpy as np

from .parallel import collective

__all__ = ["init", "finalize", "get_rank", "get_world_size", "is_distributed",
           "allreduce", "broadcast", "tracker_print", "get_processor_name",
           "Op"]


class Op:
    """Reduction op ids (reference rabit.Op enum)."""

    MAX = "max"
    MIN = "min"
    SUM = "sum"
    OR = "bitwise_or"


def _warn(name: str) -> None:
    warnings.warn(f"xgboost_tpu_torch.rabit.{name} is deprecated; use "
                  f"xgboost_tpu_torch.parallel.collective.{name}",
                  FutureWarning)


def init(args: Optional[List[bytes]] = None) -> None:
    _warn("init")
    collective.init(communicator="torch")


def finalize() -> None:
    _warn("finalize")
    collective.finalize()


def get_rank() -> int:
    _warn("get_rank")
    return collective.get_rank()


def get_world_size() -> int:
    _warn("get_world_size")
    return collective.get_world_size()


def is_distributed() -> bool:
    _warn("is_distributed")
    return collective.is_distributed()


def allreduce(data: np.ndarray, op: str = Op.SUM) -> np.ndarray:
    _warn("allreduce")
    return collective.allreduce(data, op=op)


def broadcast(data: Any, root: int = 0) -> Any:
    _warn("broadcast")
    return collective.broadcast(data, root=root)


def tracker_print(msg: Any) -> None:
    _warn("tracker_print")
    collective.communicator_print(msg)


def get_processor_name() -> str:
    _warn("get_processor_name")
    return collective.get_processor_name()
