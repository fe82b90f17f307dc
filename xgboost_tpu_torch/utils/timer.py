"""The wall-clock ``Monitor`` under its older home: it lives in
:mod:`xgboost_tpu_torch.obs.monitor` (the JAX package's
``utils/timer.py`` re-exports it the same way)."""

from __future__ import annotations

from ..obs.monitor import Monitor, Timer, annotate, profile

__all__ = ["Timer", "Monitor", "annotate", "profile"]
