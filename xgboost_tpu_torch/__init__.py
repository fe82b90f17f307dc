"""xgboost_tpu_torch — the PyTorch/CUDA port of xgboost_tpu.

This slice loads gbtree models, packs them, and answers predictions
through ``Booster.predict`` and ``serve.Server``; the forest walk is a
CUDA kernel written by hand for Hopper (``csrc/walk.cu``). Entry points
run on the card unless the caller asks for ``device="cpu"``.
"""

from .context import Context, resolve_device
from .core import Booster
from .data.dmatrix import DMatrix

__version__ = "0.1.0"

__all__ = ["Booster", "Context", "DMatrix", "resolve_device"]
