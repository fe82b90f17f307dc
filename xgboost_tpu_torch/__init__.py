"""xgboost_tpu_torch — the PyTorch/CUDA port of xgboost_tpu.

``train`` grows gbtree models (depthwise ``hist``; ``binary:logistic``,
``reg:squarederror``, ``multi:softprob`` / ``multi:softmax``, and over
a matrix's query groups ``rank:ndcg`` / ``rank:pairwise`` /
``rank:map``; row and column sampling, boosted random forests, early
stopping and the stock ``callback`` objects) with histograms built by
CUDA kernels written by hand for Hopper (``csrc/hist.cu``);
``Booster.predict`` and
``serve.Server`` answer predictions through the forest walk kernel
(``csrc/walk.cu``). A ``DMatrix`` or ``QuantileDMatrix`` built from a
``DataIter`` with a ``cache_prefix`` trains from host memory, its pages
streamed to the card (external memory). A ``DMatrix`` also reads
libsvm / CSV files and ``save_binary`` containers by path, scipy sparse
matrices, pandas DataFrames and pyarrow tables. Models are dumped
(``Booster.get_dump``), refreshed (``process_type="update"``) and written
in the reference XGBoost schema (``save_xgboost_model``). Entry points
run on the card unless the caller asks for ``device="cpu"``.
"""

from . import callback
from .context import Context, resolve_device
from .config import config_context, get_config, set_config
from .core import Booster, train
from .data.dmatrix import DataIter, DMatrix, QuantileDMatrix
from .interop import load_xgboost_model, save_xgboost_model

__version__ = "0.1.0"

__all__ = ["Booster", "Context", "DataIter", "DMatrix", "QuantileDMatrix",
           "callback", "config_context", "get_config",
           "load_xgboost_model", "resolve_device", "save_xgboost_model",
           "set_config", "train"]
