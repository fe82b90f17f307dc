"""xgboost_tpu_torch — the PyTorch/CUDA port of xgboost_tpu.

``train`` grows gbtree models (depthwise ``hist``, ``binary:logistic``
or ``reg:squarederror``) with histograms built by CUDA kernels written
by hand for Hopper (``csrc/hist.cu``); ``Booster.predict`` and
``serve.Server`` answer predictions through the forest walk kernel
(``csrc/walk.cu``). Entry points run on the card unless the caller asks
for ``device="cpu"``.
"""

from .context import Context, resolve_device
from .config import config_context, get_config, set_config
from .core import Booster, train
from .data.dmatrix import DMatrix

__version__ = "0.1.0"

__all__ = ["Booster", "Context", "DMatrix", "config_context", "get_config",
           "resolve_device", "set_config", "train"]
