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
communicators of ``parallel.collective``); a paged matrix trains on a
mesh too, each shard streaming its own rows. ``obs`` holds the span
tracer (``XTPU_TRACE``), the ``Monitor`` timing table and the
device-memory watermarks (``XTPU_FLIGHT_MEM``); ``plot_importance`` /
``plot_tree`` / ``to_graphviz`` draw a model, the six component
registries (``OBJECTIVES`` ... ``LINEAR_UPDATERS``) take plugins, and
``build_info()`` describes the torch / CUDA build. Entry points run on
the card unless the caller asks for ``device="cpu"``.
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
from .tree.param import TrainParam
from .utils.checkpoint import CheckpointConfig, TrainingSnapshot
from .plotting import plot_importance, plot_tree, to_graphviz
from . import registry
from .registry import (BOOSTERS, LINEAR_UPDATERS, METRICS, OBJECTIVES,
                       PREDICTORS, TREE_UPDATERS, Registry)

__version__ = "0.1.0"


def build_info() -> dict:
    """The runtime's build (reference ``xgboost.build_info``; the JAX
    package's describes its JAX stack): the torch and CUDA versions, the
    backend and its device, the kernel libraries built and loaded so far
    (``ops/cuda/build.py``; ``native_runtime``: the host text parser),
    and ``USE_CUDA`` / ``USE_NCCL`` as the torch build reports them."""
    import importlib.util

    import torch

    from .ops.cuda import build

    libs = build.loaded()
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available()
    return {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "kernels_loaded": [n for n in libs if not n.startswith("host:")],
        "native_runtime": "host:text_parser" in libs,
        "USE_CUDA": torch.backends.cuda.is_built(),
        "USE_NCCL": bool(dist and torch.distributed.is_nccl_available()),
        "USE_FEDERATED": importlib.util.find_spec("grpc") is not None,
    }


__all__ = ["Booster", "CheckpointConfig", "Context", "DataIter", "DMatrix",
           "Mesh", "collective", "make_data_mesh",
           "QuantileDMatrix", "TrainingSnapshot", "XGBClassifier", "XGBModel", "XGBRanker", "XGBRegressor",
           "NumericalDivergence", "XGBRFClassifier", "XGBRFRegressor", "callback",
           "config_context", "cv", "get_config", "load_xgboost_model",
           "resolve_device", "save_xgboost_model", "set_config", "train",
           "TrainParam", "build_info", "plot_importance", "plot_tree",
           "registry", "to_graphviz", "__version__", "Registry",
           "OBJECTIVES", "METRICS", "BOOSTERS", "TREE_UPDATERS",
           "PREDICTORS", "LINEAR_UPDATERS"]
