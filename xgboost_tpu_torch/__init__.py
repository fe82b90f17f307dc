"""xgboost_tpu_torch — the PyTorch/CUDA port of xgboost_tpu.

``train`` grows gbtree and dart models (depthwise or leaf-wise ``hist``,
``approx`` and ``exact``; every objective and metric of the JAX
package, ranking over a matrix's query groups, label matrices with one
tree a target or vector-leaf trees; row and column sampling, boosted
random forests, monotone and interaction constraints, early stopping
and the stock ``callback`` objects) with histograms built by CUDA
kernels written by hand for Hopper (``csrc/hist.cu``), and linear
models (``booster="gblinear"``, ``shotgun`` or ``coord_descent``).
``Booster.predict`` and ``serve.Server`` answer predictions through the
forest walk kernel (``csrc/walk.cu``); ``Booster.predict`` also gives
SHAP contributions, their interactions and Saabas contributions
(``pred_contribs`` / ``pred_interactions`` / ``approx_contribs``),
computed on the card in float64 (``ops/shap.py``). A ``DMatrix`` or
``QuantileDMatrix`` built from a ``DataIter`` with a ``cache_prefix``
trains from host memory, its pages streamed to the card (external
memory). A ``DMatrix`` also reads libsvm / CSV files and
``save_binary`` containers by path, scipy sparse matrices, pandas
DataFrames and pyarrow tables. Models are dumped
(``Booster.get_dump``), refreshed (``process_type="update"``) and
written in the reference XGBoost schema (``save_xgboost_model``).
``XGBClassifier`` / ``XGBRegressor`` / ``XGBRanker`` / ``XGBRF*`` wrap
training for scikit-learn (which is optional), ``cv`` cross-validates,
and ``python -m xgboost_tpu_torch <config> [key=value ...]`` is the
command line (train / dump / pred / serve: ``serve.frontend``, the HTTP
and jsonl front ends over one ``serve.Server`` or a ``serve.FleetRouter``
of several). A gradient with NaN or Inf raises ``NumericalDivergence``
unless ``XTPU_NAN_POLICY`` says ``zero`` or ``off``. Row-split
training runs over a data mesh of row shards (``params["mesh"] =
make_data_mesh()``; a device may repeat) and across processes
(``parallel.launch.train_per_host`` over ``torch.distributed``, the host
communicators of ``parallel.collective``). Entry points run on the card
unless the caller asks for ``device="cpu"``.
"""

from . import callback
from .context import Context, Mesh, make_data_mesh, resolve_device
from .config import config_context, get_config, set_config
from .core import Booster, train
from .data.dmatrix import DataIter, DMatrix, QuantileDMatrix
from .interop import load_xgboost_model, save_xgboost_model
from .objective.base import NumericalDivergence
from .parallel import collective
from .sklearn import (XGBClassifier, XGBModel, XGBRanker, XGBRegressor,
                      XGBRFClassifier, XGBRFRegressor)
from .training import cv
from .utils.checkpoint import CheckpointConfig, TrainingSnapshot

__version__ = "0.1.0"

__all__ = ["Booster", "CheckpointConfig", "Context", "DataIter", "DMatrix",
           "Mesh", "collective", "make_data_mesh",
           "QuantileDMatrix", "TrainingSnapshot", "XGBClassifier", "XGBModel", "XGBRanker", "XGBRegressor",
           "NumericalDivergence", "XGBRFClassifier", "XGBRFRegressor", "callback",
           "config_context", "cv", "get_config", "load_xgboost_model",
           "resolve_device", "save_xgboost_model", "set_config", "train"]
