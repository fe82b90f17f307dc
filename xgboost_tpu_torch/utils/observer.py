"""Training observer (reference ``TrainingObserver``,
``src/common/observer.h:38``; the JAX package's ``utils/observer.py``):
while the ``XGBOOST_TPU_DEBUG_OUTPUT`` environment variable is set,
each boosting round prints summaries of its gradient and of the
training margin, so that where two runs or two devices part ways can be
found. The reference compiles this in under
``XGBOOST_USE_DEBUG_OUTPUT``; here it is an environment test, read at
each call, and costs nothing more while the variable is unset."""

from __future__ import annotations

import os

import numpy as np


def enabled() -> bool:
    return bool(os.environ.get("XGBOOST_TPU_DEBUG_OUTPUT"))


def observe(name: str, array, iteration: int = -1) -> None:
    """Print ``array``'s shape, sum, mean and first values (a tensor on
    any device, or anything numpy takes) when enabled."""
    if not enabled():
        return
    if hasattr(array, "detach"):
        array = array.detach().cpu().numpy()
    a = np.asarray(array, dtype=np.float64).reshape(-1)
    head = ", ".join(f"{v:.6g}" for v in a[:8])
    print(f"[observer] iter={iteration} {name}: shape={np.shape(array)} "
          f"sum={a.sum():.9g} mean={a.mean():.9g} [{head}...]")
