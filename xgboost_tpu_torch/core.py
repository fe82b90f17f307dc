"""Booster and ``train``: the main training path, prediction and model IO.

Training is the JAX package's ``core.py`` general round loop on one
device: ``Booster.update`` computes the gradient [n, K, 2] from a margin
cache [n, K] (K = 1, or ``num_class``), derives the round's key
``fold_in(make_key(it), it)`` and has ``GBTree.do_boost`` grow the
round's trees (row and column samples from that key, histograms through
kernels K2 to K5); the cache moves by their per-row deltas. A ``dart``
booster (``boosting/dart.py``) has no such cache: each round it draws
the trees to drop, takes its gradient from the margin without them and
rolls its own full margin forward. ``train``
runs the rounds through ``callback.CallbackContainer`` (evaluation of
``evals`` after each one, ``EvaluationMonitor``, ``EarlyStopping``), as
the JAX package's ``train`` does. ``predict`` and the
eval sets other than the training matrix go through the packed walk
(``serve/packed.py`` + ``ops/walk.py``, kernel K1). Everything runs on
the card unless the Booster was made with ``{"device": "cpu"}``.

A matrix built from a ``DataIter`` keeps no raw values: its margin cache
walks new trees over its bins (``GBTree.margin_delta_binned``), page by
page when it is paged, and never as an [n, F] float matrix on the card.
A paged training matrix that fits the page-cache budget collapses to
the resident tier first (:meth:`Booster._collapse_paged_if_fits`).

``save_raw`` writes the model JSON the JAX package writes
(``_model_to_json``), ``config`` block included, so a model trained
here loads into ``xgboost_tpu`` and a model loaded here saves back to the
bytes it was read from.

``process_type="update"`` (:meth:`Booster._update_existing_trees`)
re-processes a model's trees round by round with the ``updater`` list
(``tree/updaters.py``: refresh, prune, sync) on the host. Custom
objectives (``train(obj=)``, ``update(fobj=)``, :meth:`Booster.boost`)
and metrics (``custom_metric=`` / ``feval=``) take and give numpy.
``predict(pred_leaf=True)`` walks the trees as torch ops
(``boosting/predict.py leaf_positions``); dumps, importances and the
structural report are ``dump.py``'s.

Under ``tree_method="approx"`` or ``"exact"`` the training matrix's
cache entry keeps no bins: it keeps what the method grows from
(:meth:`Booster._method_source`), its margin moves by the grown trees'
deltas, and every other matrix walks raw values through K1, as in the
JAX package, so none is binned with one round's cuts.

A label matrix [n, K] trains K outputs: one tree a target and round
(``multi_strategy="one_output_per_tree"``, the default), or one
vector-leaf tree a round for all K (``"multi_output_tree"``,
``tree/multi.py``), whose margins walk as torch ops.

Row-split training (``params["mesh"]``, a ``context.Mesh``; the JAX
package's ``_make_sharded_train_state``): the growers take the training
matrix's rows padded to a multiple of the mesh's size and cut into its
shards (:meth:`Booster._grow_source`), and the round's gradients padded
with zero rows; the margin caches, labels, evals, predictions and
snapshots keep the real rows, so they are what one device gives. A
mesh whose communicator spans processes (``parallel/launch.py``) sums
its shards' histograms across the ranks too; without one, a resident
matrix under a multi-rank communicator is refused
(:meth:`Booster._check_row_comm_sync`), and the paged tier syncs each
level through the communicator. A paged matrix on a mesh stays paged
(``data/binned.py PagedMeshMatrix``): each shard streams its own rows of
each page, the gradients padded to the mesh layout's ``n_pad`` rows
(``PagedBinnedMatrix.mesh_layout``). ``tree_method="exact"`` and
``gblinear`` refuse a mesh, and ``approx`` over pages refuses one with
the JAX package's words.

Each round runs the JAX package's ``Monitor("Booster")`` sections
``GetGradient``, ``BoostOneIter`` and ``UpdateCache`` (``obs/monitor.py``;
spans of those names under ``XTPU_TRACE``, the table at verbosity >= 3
when ``train`` ends), the debug observer's two summaries
(``utils/observer.py``, ``XGBOOST_TPU_DEBUG_OUTPUT``) and, under
``XTPU_FLIGHT_MEM``, the memory monitor's round boundary
(:meth:`Booster._mem_round`).

Column split (``data_split_mode="col"``, reference ``DataSplitMode::kCol``)
trains the pooled columns' model two ways. On a mesh: the training
matrix's features padded and cut into the shards' blocks, every row on
every shard (``data/binned.py pad_features_for_mesh``; the growers'
``ColShards``). Across vertical federated parties (a multi-rank
communicator and no mesh, :meth:`Booster._is_vertical_federated`): each
rank's ``DMatrix`` holds its block of features, built with
``data_split_mode="col"``, and only the label rank its labels; the base
score, gradients, leaf refreshes and metrics are the label rank's,
broadcast by ``collective.apply_with_labels``, and margins and
predictions walk the trees by the decision-bit protocol
(``tree/vertical.py federated_vertical_margin``). ``exact`` is refused
under both, vector leaves and ``gblinear`` across parties, and a paged
matrix under both, with the JAX package's words.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from . import dump
from .boosting.dart import Dart
from .boosting.gblinear import GBLinear
from .boosting.gbtree import GBTree
from .boosting.predict import leaf_positions, margin_raw, stack_trees
from .callback import CallbackContainer, EarlyStopping, EvaluationMonitor
from .config import get_config
from .context import Context
from .data.binned import (ApproxSource, BinnedMatrix, MeshApproxSource,
                          PagedApproxSource, PagedMeshMatrix,
                          pad_features_for_mesh, shard_binned)
from .data.dmatrix import DMatrix
from .interop import is_reference_model, reference_to_native_json
from .metric import get_metric
from .objective import get_objective
from .objective.adaptive import label_matrix_refusal
from .objective.base import (NumericalDivergence, Objective,
                             guard_gradient)
from .objective.survival import sort_by_time
from .parallel import collective
from .obs import memory as obs_memory
from .obs.monitor import Monitor
from .obs.training_log import TrainingLog
from .ops import shap as shap_ops
from .ops.shap import ShapPack, build_shap_pack
from .serve.packed import PackedForest
from .tree.exact import ExactQuantization
from .tree.multi import is_vector_leaf
from .tree.param import (TrainParam, parse_interaction_constraints,
                         parse_monotone_constraints)
from .tree.updaters import UPDATERS, prune_tree, refresh_tree, sync_trees
from .tree.vertical import federated_vertical_margin
from .utils import observer
from .utils import random as xrandom
from .utils.ubjson import dumps_ubjson, loads_ubjson

# learner-level keys that are not TrainParam fields (the JAX package's
# list); "device" stays with the Context and is not saved with the model
_LEARNER_KEYS = {
    "objective", "num_class", "base_score", "eval_metric", "booster",
    "num_parallel_tree", "tree_method", "seed", "random_state",
    "nthread", "n_jobs", "verbosity", "disable_default_eval_metric",
    "hist_method", "validate_parameters", "seed_per_iteration",
    "multi_strategy", "data_split_mode",
    # objective-specific passthroughs
    "scale_pos_weight", "huber_slope", "tweedie_variance_power",
    "quantile_alpha", "aft_loss_distribution", "aft_loss_distribution_scale",
    "lambdarank_pair_method", "lambdarank_num_pair_per_sample",
    "lambdarank_unbiased", "lambdarank_bias_norm", "ndcg_exp_gain",
    "max_delta_step",
    # dart
    "rate_drop", "one_drop", "skip_drop", "sample_type", "normalize_type",
    # gblinear
    "updater", "feature_selector", "top_k",
}
_DEVICE_KEYS = ("device", "device_type")
_HIST_TREE_METHODS = ("auto", "hist", "gpu_hist", "tpu_hist")


def _squeeze(a: np.ndarray) -> np.ndarray:
    """[n, 1] -> [n]; anything else as it is."""
    return a[:, 0] if a.ndim == 2 and a.shape[1] == 1 else a


def _jsonable(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


class Booster:
    """A gradient-boosted tree model: trained here or loaded.

    ``params`` may name ``"device"`` (``"cuda"`` by default, ``"cpu"``)
    and any training parameter of the JAX package; the ones this slice
    does not run raise ``NotImplementedError`` naming their ROADMAP item
    when training starts."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 model_file: Union[str, bytes, bytearray, None] = None
                 ) -> None:
        self.tree_param = TrainParam()
        self.learner_params: Dict[str, Any] = {
            "objective": "reg:squarederror", "booster": "gbtree",
            "num_parallel_tree": 1, "tree_method": "auto", "num_class": 0,
        }
        self.ctx = Context()
        self.attributes_: Dict[str, str] = {}
        self.feature_names: Optional[List[str]] = None
        self.feature_types: Optional[List[str]] = None
        self.obj = None
        self.gbm: Optional[Union[GBTree, GBLinear]] = None
        # every key a caller set (gblinear's lambda and alpha are 0 unless
        # set, the JAX package's rule)
        self._explicit_params: set = set()
        self.base_margin_: Optional[np.ndarray] = None
        self._num_features = 0
        self._version: List[int] = [0, 1, 0]
        self._configured = False
        self._caches: Dict[int, Dict[str, Any]] = {}
        self._eval_metrics: List = []
        # the eval history of ``train`` (``obs/training_log.py``), which a
        # training snapshot carries
        self.training_log: Optional[TrainingLog] = None
        # packed forests by tree range, and SHAP path tables by ("shap",
        # range)
        self._packed: Dict[tuple, Union[PackedForest, ShapPack]] = {}
        self._packed_lock = threading.Lock()
        # the round's timing table (reference ``common::Monitor``), printed
        # at verbosity >= 3 when ``train`` ends
        self._monitor = Monitor("Booster")
        if params:
            self.set_param(params)
        self.device = self.ctx.torch_device()   # raises without CUDA
        if model_file is not None:
            self.load_model(model_file)
            # upstream applies params after the model's own (the JAX
            # package keeps the file's tree parameters; ROADMAP C.3)
            if params:
                self.set_param(params)

    # ------------------------------------------------------------------ params
    def set_param(self, params: Union[Dict[str, Any], str],
                  value: Optional[Any] = None) -> None:
        if isinstance(params, str):
            params = {params: value}
        params = dict(params)
        self._explicit_params.update(params)
        for k in _DEVICE_KEYS:
            if k in params:
                self.ctx = dataclasses.replace(self.ctx,
                                               device=str(params.pop(k)))
        if "mesh" in params:
            # a data mesh (``context.Mesh``): row-split training over its
            # shards; the model's state lives on its first device
            mesh = params.pop("mesh")
            if mesh is not None:
                self.ctx = self.ctx.with_mesh(mesh)
                if hasattr(self, "device"):
                    self.device = self.ctx.torch_device()
        if "eval_metric" in params:
            em = params.pop("eval_metric")
            names = em if isinstance(em, (list, tuple)) else [em]
            self.learner_params["eval_metric"] = list(names)
            self._eval_metrics = [get_metric(n) for n in names]
        for k in list(params):
            if k in _LEARNER_KEYS:
                self.learner_params[k] = params.pop(k)
        self._seed_from_params()
        for k in self.tree_param.update_allow_unknown(params):
            warnings.warn(f"Unknown parameter: {k}", stacklevel=2)
        if self._configured and self.obj is not None:
            self.obj = get_objective(
                self.learner_params.get("objective", self.obj.name),
                self._obj_params())
            if isinstance(self.gbm, GBTree):
                self.gbm.tree_param = self.tree_param
                self._configure_constraints(None)
                self.gbm._grower = None
                if isinstance(self.gbm, Dart):
                    self.gbm.configure(self.learner_params, self.ctx.seed)
            elif self.gbm is not None:
                self._configure_linear()
        self._packed = {}

    def _seed_from_params(self) -> None:
        """The random stream's seed from ``seed`` / ``random_state`` and
        ``seed_per_iteration`` (kept in ``learner_params``, so a saved
        model carries them). The context is replaced, not changed, since
        a slice of this Booster shares it."""
        seed, per_it = self.ctx.seed, self.ctx.seed_per_iteration
        for k in ("seed", "random_state"):
            if k in self.learner_params:
                seed = int(self.learner_params[k])
        if "seed_per_iteration" in self.learner_params:
            per_it = bool(self.learner_params["seed_per_iteration"])
        self.ctx = dataclasses.replace(self.ctx, seed=seed,
                                       seed_per_iteration=per_it)

    def _obj_params(self) -> Dict[str, Any]:
        return {k: v for k, v in self.learner_params.items()
                if k not in ("objective", "booster")}

    # ------------------------------------------------------------ metadata
    @property
    def n_groups(self) -> int:
        return self.gbm.n_groups if self.gbm is not None else 1

    def _base_np(self) -> np.ndarray:
        if self.base_margin_ is None:
            return np.zeros(self.n_groups, np.float32)
        return self.base_margin_

    def num_features(self) -> int:
        if self.feature_names:
            return len(self.feature_names)
        return self._num_features

    def num_boosted_rounds(self) -> int:
        return self.gbm.num_boosted_rounds() if self.gbm is not None else 0

    # ------------------------------------------------------------ attributes
    def attr(self, key: str) -> Optional[str]:
        return self.attributes_.get(key)

    def attributes(self) -> Dict[str, str]:
        return dict(self.attributes_)

    def set_attr(self, **kwargs: Any) -> None:
        """Set string attributes (saved with the model); None removes
        one."""
        for k, v in kwargs.items():
            if v is None:
                self.attributes_.pop(k, None)
            else:
                self.attributes_[k] = str(v)

    @property
    def best_iteration(self) -> int:
        """The round early stopping found best, else the last round."""
        b = self.attr("best_iteration")
        if b is None:
            return self.num_boosted_rounds() - 1
        return int(b)

    @property
    def best_score(self) -> float:
        return float(self.attr("best_score"))

    def __getitem__(self, val: slice) -> "Booster":
        """A Booster of the rounds ``val`` selects (a slice of rounds,
        ``step`` included), sharing this one's trees (a dart forest's
        with their weights)."""
        if not isinstance(val, slice):
            raise TypeError("Booster slicing requires a slice of iterations")
        self._require_model()
        if isinstance(self.gbm, GBLinear):
            raise NotImplementedError("only tree boosters support slicing")
        begin = val.start or 0
        end = val.stop if val.stop is not None else self.num_boosted_rounds()
        step = val.step if val.step is not None else 1
        new = Booster.__new__(Booster)
        new.__dict__.update(self.__dict__)
        new.gbm = self.gbm.slice_rounds(
            range(begin, min(end, self.num_boosted_rounds()), step))
        new._caches = {}
        new._packed = {}
        new._packed_lock = threading.Lock()
        new.attributes_ = dict(self.attributes_)
        new.learner_params = dict(self.learner_params)
        return new

    def _require_model(self) -> None:
        if self.gbm is None:
            raise ValueError("no model loaded; pass model_file= or call "
                             "load_model()")

    # ------------------------------------------------------------- configure
    def _configure(self, dtrain: Optional[DMatrix]) -> None:
        if self._configured:
            return
        tm = self._tree_method()
        booster = self.learner_params.get("booster", "gbtree")
        if booster not in ("gbtree", "dart", "gblinear"):
            raise ValueError(f"unknown booster: {booster}")
        ms = self.learner_params.get("multi_strategy", "one_output_per_tree")
        self._check_split_mode(tm, booster, ms, dtrain)
        if booster == "gblinear" and self.ctx.mesh is not None:
            raise NotImplementedError(
                "booster=gblinear does not support a device mesh; train "
                "mesh configs with booster=gbtree or dart")
        if ms not in ("one_output_per_tree", "multi_output_tree"):
            raise ValueError(f"unknown multi_strategy: {ms}")
        if self.tree_param.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError(
                f"unknown grow_policy={self.tree_param.grow_policy}; use "
                "'depthwise' or 'lossguide'")
        self._check_tree_method(tm, dtrain)
        obj_name = self.learner_params.get("objective", "reg:squarederror")
        if self.obj is None or self.obj.name != obj_name:
            self.obj = get_objective(obj_name, self._obj_params())
        if dtrain is not None and self.obj.info.zero_hess \
                and np.ndim(dtrain.info.labels) == 2 \
                and dtrain.info.labels.shape[1] > 1:
            raise ValueError(label_matrix_refusal(self.obj.name))
        n_groups = max(1, self.obj.n_targets(
            dtrain.info if dtrain is not None else None))
        if dtrain is not None and not self._num_features:
            self._num_features = dtrain.num_col()
        if self.gbm is None and booster == "gblinear":
            self.gbm = GBLinear(n_groups)
        elif self.gbm is None:
            cls = Dart if booster == "dart" else GBTree
            self.gbm = cls(
                n_groups, num_parallel_tree=int(self.learner_params.get(
                    "num_parallel_tree", 1)), multi_strategy=ms)
        if isinstance(self.gbm, GBLinear):
            self._configure_linear()
        else:
            self._configure_trees(dtrain, booster, tm, ms)
            self.gbm.vertical = self._is_vertical_federated()
        if self.base_margin_ is None:
            bs = self.learner_params.get("base_score")
            if bs is not None:
                margin = self.obj.prob_to_margin(np.asarray([float(bs)]))
                self.base_margin_ = np.full(
                    n_groups, float(np.asarray(margin).reshape(-1)[0]),
                    np.float32)
            elif dtrain is not None and (dtrain.info.labels is not None
                                         or self._is_vertical_federated()):
                st = self._state_of(dtrain, is_train=True)
                # column split: every rank holds the rows, whose sums no
                # rank reduces; vertical parties take the label rank's
                row_split = self.learner_params.get(
                    "data_split_mode", "row") == "row"
                self.base_margin_ = np.asarray(self._with_labels(
                    lambda: self.obj.init_estimation(
                        st["labels"], st["weights"], row_split=row_split,
                        **self._obj_inputs(st)).reshape(-1)), np.float32)
            else:
                self.base_margin_ = np.zeros(n_groups, np.float32)
        if not self._eval_metrics and not bool(self.learner_params.get(
                "disable_default_eval_metric", False)):
            self._eval_metrics = [get_metric(self.obj.default_metric)]
        if dtrain is not None and self.feature_names is None:
            self.feature_names = dtrain.info.feature_names
            self.feature_types = dtrain.info.feature_types
        self._configured = True

    def _check_split_mode(self, tm: str, booster: str, ms: str,
                          dtrain: Optional[DMatrix]) -> None:
        """``data_split_mode``'s checks, with the JAX package's words
        (``core.py:591-625``, ``:451-461``)."""
        dsm = self.learner_params.get("data_split_mode", "row")
        if dsm not in ("row", "col"):
            raise ValueError(f"unknown data_split_mode: {dsm}")
        if dsm != "col":
            return
        if self.ctx.mesh is None and not collective.is_distributed():
            raise ValueError(
                "data_split_mode=col requires a mesh (in-process column "
                "sharding) or an active distributed communicator "
                "(vertical federated training)")
        if tm == "exact":
            # the reference's ColMaker has no distributed support
            raise NotImplementedError(
                "data_split_mode=col supports tree_method=hist/approx")
        if self.ctx.mesh is None:
            if ms == "multi_output_tree":
                raise NotImplementedError(
                    "vertical federated column split supports scalar trees "
                    "only")
            if booster == "gblinear":
                raise NotImplementedError(
                    "vertical federated column split supports tree "
                    "boosters only (the reference's linear updaters run "
                    "under DataSplitMode::kRow)")
            if dtrain is not None and \
                    dtrain.info.data_split_mode != "col":
                # the flag keeps the metrics' and objectives' reductions
                # off the ranks; without it the ranks would deadlock
                raise ValueError(
                    "vertical federated training requires the DMatrix to be "
                    "constructed with data_split_mode='col' (got "
                    f"{dtrain.info.data_split_mode!r})")

    def _is_vertical_federated(self) -> bool:
        """Column split across communicator ranks, no mesh: rows and
        margins are on every rank, the features are split and the labels
        may be the label rank's only (the JAX package's
        ``_is_vertical_federated``)."""
        return (self.learner_params.get("data_split_mode", "row") == "col"
                and self.ctx.mesh is None and collective.is_distributed())

    def _with_labels(self, fn: Callable) -> Any:
        """``fn()``, or, across vertical parties, the label rank's
        ``fn()`` on every rank (``collective.apply_with_labels``)."""
        if not self._is_vertical_federated():
            return fn()
        return collective.apply_with_labels(fn)

    def _configure_trees(self, dtrain: Optional[DMatrix], booster: str,
                         tm: str, ms: str) -> None:
        if isinstance(self.gbm, Dart):
            self.gbm.configure(self.learner_params, self.ctx.seed)
        self.gbm.tree_param = self.tree_param
        self.gbm.tree_method = tm
        self._configure_constraints(dtrain)
        if "multi_output_tree" in (ms, self.gbm.multi_strategy):
            self._refuse_for_vector_leaves(booster)
        self.gbm.hist_method = str(self.learner_params.get("hist_method",
                                                           "auto"))

    def _configure_linear(self) -> None:
        """The linear booster's parameters (the JAX package's
        ``_make_booster``): ``lambda`` and ``alpha`` are 0 unless a caller
        set them, ``eta`` is the tree parameters'; applied again after
        ``set_param``, so the latest parameters rule, as upstream's."""
        explicit = self._explicit_params
        tp, gbm = self.tree_param, self.gbm
        gbm.reg_lambda = tp.reg_lambda if {"lambda", "reg_lambda"} \
            & explicit else 0.0
        gbm.reg_alpha = tp.reg_alpha if {"alpha", "reg_alpha"} \
            & explicit else 0.0
        gbm.eta = tp.eta
        gbm.updater = self.learner_params.get("updater", gbm.updater)
        gbm.feature_selector = self.learner_params.get("feature_selector",
                                                       "cyclic")

    def _tree_method(self) -> str:
        """``"hist"`` (any of its names), ``"approx"`` or ``"exact"``."""
        tm = self.learner_params.get("tree_method", "auto")
        if tm in _HIST_TREE_METHODS:
            return "hist"
        if tm not in ("approx", "exact"):
            raise NotImplementedError(
                f"tree_method={tm} is not implemented; use "
                "hist/approx/exact")
        return tm

    def _check_tree_method(self, tm: str,
                           dtrain: Optional[DMatrix]) -> None:
        """What ``approx`` and ``exact`` do not take, refused with the JAX
        package's exceptions and words (``exact``'s as upstream's
        ``ColMaker``); categorical data under ``exact`` is refused as
        upstream refuses it, where the JAX package trains the codes as
        numbers (ROADMAP C)."""
        if tm == "hist":
            return
        if tm == "exact" and self.ctx.mesh is not None:
            raise ValueError("tree_method=exact does not support "
                             "distributed training (reference ColMaker "
                             "limitation)")
        if tm == "exact" and self.tree_param.grow_policy == "lossguide":
            raise ValueError("tree_method=exact only supports "
                             "grow_policy=depthwise (reference ColMaker)")
        if tm == "exact" and self.tree_param.max_leaves > 0:
            raise NotImplementedError(
                "tree_method=exact does not support max_leaves")
        if self.learner_params.get("hist_method") in ("coarse", "fused",
                                                      "scan", "mega"):
            raise NotImplementedError(
                "hist_method='coarse'/'fused'/'scan'/'mega' supports the "
                "hist updaters (depthwise or lossguide, resident or "
                "external-memory depthwise) with scalar trees only")
        if tm == "exact" and dtrain is not None and "c" in (
                dtrain.info.feature_types or ()):
            raise ValueError("Updater `grow_colmaker` or `exact` tree "
                             "method doesn't support categorical data.")

    def _refuse_for_vector_leaves(self, booster: str) -> None:
        """What ``multi_output_tree`` does not take, refused as the JAX
        package refuses it (the reference rejects monotone constraints
        and dart for vector-leaf trees)."""
        if self.gbm.monotone is not None or booster == "dart":
            raise NotImplementedError(
                "multi_output_tree does not support monotone constraints "
                "or the dart booster (the reference rejects both for "
                "vector-leaf trees)")
        if self.learner_params.get("hist_method") in ("coarse", "fused",
                                                      "scan", "mega"):
            raise NotImplementedError(
                "hist_method='coarse'/'fused'/'scan'/'mega' supports the "
                "hist updaters (depthwise or lossguide, resident or "
                "external-memory depthwise) with scalar trees only")

    def _configure_constraints(self, dtrain: Optional[DMatrix]) -> None:
        """Parse the monotone and interaction constraints for the forest
        (the JAX package's ``_make_gbm``): over the training matrix's
        features, or the loaded model's when no matrix was seen; names in
        the interaction sets are the feature names. Vertical parties parse
        them over the global features, every party's in rank order."""
        names = self.feature_names or (
            dtrain.info.feature_names if dtrain is not None else None)
        nf = self._num_features or (len(names) if names else 0)
        if dtrain is not None and self._is_vertical_federated():
            # the parties' constraints are over every party's features
            nf = int(sum(collective.get_communicator().allgather_objects(
                int(dtrain.num_col()))))
        self.gbm.monotone = parse_monotone_constraints(
            self.tree_param.monotone_constraints, nf)
        self.gbm.constraint_sets = parse_interaction_constraints(
            self.tree_param.interaction_constraints or None, nf, names)

    # ----------------------------------------------------------- margin caches
    def _state_of(self, dm: DMatrix, is_train: bool) -> Dict[str, Any]:
        """The cache entry of one DMatrix: its device tensors, its base
        margin ``base`` [n, G] and a margin covering the first
        ``n_trees`` trees (both None until the base margin is known)."""
        st = self._caches.get(id(dm))
        # a matrix that grew (``DMatrix.append``) starts a new entry, its
        # margin walked anew
        if st is None or st["dm"] is not dm or st["n"] != dm.num_row():
            dev = self.device
            info = dm.info
            st = {"dm": dm, "n": dm.num_row(), "margin": None, "n_trees": 0,
                  "binned": None,
                  "X": None, "is_train": False,
                  "labels": None if info.labels is None else
                  torch.from_numpy(info.labels).to(dev),
                  "weights": None if info.weights is None else
                  torch.from_numpy(info.weights).to(dev)}
            self._caches[id(dm)] = st
        if is_train and not st["is_train"]:
            if isinstance(self.gbm, GBLinear):
                pass        # trains on the values (``linear_features``)
            elif self._tree_method() == "hist":
                st["binned"] = self._collapse_paged_if_fits(
                    dm.binned(self.tree_param.max_bin, self.device))
            else:
                st["source"] = self._method_source(st)
            st["is_train"] = True
        if is_train and not getattr(dm, "presharded", False):
            # checked on every training call: a communicator may come
            # after the entry (a continuation on a persistent booster),
            # and a paged matrix the collapse made resident is resident
            self._check_row_comm_sync(paged=(
                getattr(st["binned"], "is_paged", False)
                or isinstance(st.get("source"), PagedApproxSource)))
        if "vertical_walk" not in st and self._is_vertical_federated():
            # dart's dropped trees, walked by the parties' protocol
            st["vertical_walk"] = lambda idx, w, dm=dm: \
                self._vertical_margin_delta(dm, 0, 0, idx, w)
        if st["margin"] is None and self.base_margin_ is not None:
            n = dm.num_row()
            if dm.info.base_margin is not None:
                st["margin"] = torch.from_numpy(np.ascontiguousarray(
                    dm.info.base_margin, np.float32).reshape(n, -1)).to(
                        self.device)
            else:
                base = torch.from_numpy(self._base_np()).to(self.device)
                st["margin"] = base[None, :].expand(n, -1).contiguous()
            st["base"] = st["margin"]
        return st

    def _raw_on_device(self, st: Dict[str, Any]) -> torch.Tensor:
        """The cached matrix's raw values [n, F] f32 on this Booster's
        device (an iterator-built matrix's bin values), copied once."""
        if st["X"] is None:
            st["X"] = torch.from_numpy(np.ascontiguousarray(
                st["dm"].values())).to(self.device)
        return st["X"]

    def _method_source(self, st: Dict[str, Any]):
        """What ``approx`` or ``exact`` grows from, in place of a shared
        binned matrix (the training entry keeps none, as in the JAX
        package, so no other matrix is ever binned with one round's cuts
        and evaluation sets walk raw values through K1): the raw values
        and their device sketch (``data/binned.py ApproxSource``; a paged
        matrix re-sketches its pages, ``PagedApproxSource``), or the
        rank encoding (``tree/exact.py ExactQuantization``, which a paged
        matrix refuses)."""
        dm = st["dm"]
        exact = self._tree_method() == "exact"
        if getattr(dm, "presharded", False):
            # sharded ingestion (``parallel/launch.py``): the local X is a
            # 1/N shard, so exact would silently fit it alone; approx
            # re-sketches through the merge across ranks every round
            if exact:
                raise NotImplementedError(
                    "tree_method=exact is not supported with sharded "
                    "multi-process ingestion; use hist or approx")
            return dm.approx_source(self.tree_param.max_bin, self.device)
        if dm.is_paged and exact:
            raise NotImplementedError(
                "tree_method=exact rank-encodes the raw matrix and does "
                "not support external-memory (paged) matrices; use "
                "tree_method=hist")
        if isinstance(self.gbm, Dart):
            self._raw_on_device(st)     # dart walks its dropped trees on it
        if dm.is_paged:
            return PagedApproxSource(
                dm.binned(self.tree_param.max_bin, self.device),
                self.tree_param.max_bin, dm.info.feature_types)
        X = self._raw_on_device(st)
        if exact:
            return ExactQuantization(np.asarray(dm.values(), np.float32))
        return ApproxSource(X, self.tree_param.max_bin, dm.info.feature_types)

    def _obj_inputs(self, st: Dict[str, Any]) -> Dict[str, Any]:
        """The matrix's inputs the objective takes besides labels and
        weights (``Objective.takes``): the query offsets, the label bounds
        [n] f32 on this Booster's device, or the rows sorted by |label|,
        the last two made once a cache entry."""
        out: Dict[str, Any] = {}
        info = st["dm"].info
        for name in self.obj.takes:
            if name == "group_ptr":
                out[name] = info.group_ptr
                continue
            if name not in st:
                if name == "bounds":
                    lo, hi = info.label_lower_bound, info.label_upper_bound
                    st[name] = None if lo is None or hi is None else tuple(
                        torch.from_numpy(np.ascontiguousarray(
                            b, np.float32)).to(self.device) for b in (lo, hi))
                else:
                    st[name] = sort_by_time(st["labels"])
            out[name] = st[name]
        return out

    def _collapse_paged_if_fits(self, binned):
        """A paged matrix that fits the page-cache budget, as a resident
        ``BinnedMatrix`` on this Booster's device (``PagedBinnedMatrix.
        resident_binned``; ``XTPU_PAGED_COLLAPSE=0`` keeps it paged);
        anything else as it is. Multi-rank row split keeps the paged
        tier: its per-level histogram allreduce is the cross-rank sync
        (:meth:`_check_row_comm_sync`), as in the JAX package. A mesh keeps
        it too, for training and evaluation alike: the collapse would put
        every page on one device of a mesh that is there to split them
        (each shard streams its own rows, ``tree/paged.py``)."""
        if (not binned.is_paged or collective.get_world_size() > 1
                or self.ctx.mesh is not None):
            return binned
        res = binned.resident_binned(self.device)
        return binned if res is None else res

    def _check_row_comm_sync(self, paged: bool) -> None:
        """Refuse silently-local training (the JAX package's
        ``_check_row_comm_sync``, its words): with an active world > 1
        communicator, row-split training syncs on the external-memory
        tier (per-level histogram allreduce, ``tree/paged.py``) and on
        sharded ingestion (``parallel/launch.py``, whose mesh carries the
        communicator); a resident matrix would fit only its local rows
        on each rank and diverge without any error."""
        if paged or self.learner_params.get(
                "data_split_mode", "row") != "row":
            return
        if self.tree_param.process_type == "update":
            # prune/refresh/sync are rank-local ops on replicated trees
            # (no histogram build): safe under a communicator
            return
        comm = collective.get_communicator()
        if comm.is_distributed() and comm.get_world_size() > 1:
            raise NotImplementedError(
                "row-split training of a RESIDENT matrix under a "
                "multi-rank communicator is not synchronized (each rank "
                "would silently fit only its local rows); use "
                "parallel.launch.train_per_host (sharded ingestion over "
                "the global mesh) or an external-memory DMatrix (pages "
                "sync through the communicator)")

    def _grow_source(self, st: Dict[str, Any]):
        """What the round's trees grow from: the training matrix's bins
        (or its ``approx`` / ``exact`` source), or, under a data mesh,
        its rows padded to a multiple of the mesh's size with weight-0
        rows and cut into the mesh's shards (the JAX package's
        ``_make_sharded_train_state``; ``data/binned.py shard_binned``,
        ``MeshApproxSource``), or, under column split, its features
        padded and cut into the shards' blocks
        (``pad_features_for_mesh``), made once a cache entry."""
        mesh = self.ctx.mesh
        src = st["binned"] if st["binned"] is not None else st.get("source")
        col = self.learner_params.get("data_split_mode", "row") == "col"
        if col and (getattr(src, "is_paged", False)
                    or isinstance(src, PagedApproxSource)):
            raise NotImplementedError(
                "external-memory (paged) training supports "
                "data_split_mode=row only")
        if mesh is None:
            return src
        if isinstance(src, PagedApproxSource):
            raise NotImplementedError(
                "tree_method=approx over external-memory pages supports "
                "row split without a device mesh (single- or multi-host)")
        if "mesh_source" not in st:
            if getattr(src, "is_paged", False):
                # the bins stay on the host and stream to each shard
                st["mesh_source"] = PagedMeshMatrix(src, mesh)
            elif isinstance(src, BinnedMatrix):
                layout = pad_features_for_mesh if col else shard_binned
                st["mesh_source"] = layout(src, mesh)
            else:
                st["mesh_source"] = MeshApproxSource(src, mesh, col=col)
        return st["mesh_source"]

    def _binned_for_walk(self, st: Dict[str, Any]):
        """The bins a matrix without raw values (built from an iterator)
        walks new trees over: its training bins, or, for an evaluation
        set, its bins when they share the training matrix's cuts (the
        trees' split bins index those). None: walk raw (or representative)
        values through K1, as for a loaded model, which has no training
        cuts."""
        dm = st["dm"]
        if dm.X is not None:
            return None
        if st["binned"] is not None:
            return st["binned"]
        train = [c["binned"].cuts for c in self._caches.values()
                 if c["is_train"] and c["binned"] is not None]
        if not train:
            return None
        binned = dm.binned(self.tree_param.max_bin, self.device)
        cuts = binned.cuts
        if not (np.array_equal(cuts.ptrs, train[0].ptrs)
                and np.array_equal(cuts.values, train[0].values)):
            raise ValueError(
                "this matrix was quantized from an iterator with other cuts "
                "than the training matrix; build it with "
                "QuantileDMatrix(..., ref=<the training matrix>)")
        st["binned"] = self._collapse_paged_if_fits(binned)
        return st["binned"]

    def _walk_trees(self, st: Dict[str, Any], lo: int, hi: int
                    ) -> torch.Tensor:
        """Margin contribution [n, G] of trees [lo, hi), each at its weight,
        on the cached matrix: over its bins when it keeps no raw values
        (and has the training cuts), else through the packed walk (kernel
        K1 on the card)."""
        if self._is_vertical_federated():
            return self._vertical_margin_delta(st["dm"], lo, hi)
        binned = self._binned_for_walk(st)
        if binned is not None:
            return self.gbm.margin_delta_binned(binned, lo, hi, self.device)
        X = self._raw_on_device(st)
        zero = torch.zeros(self.n_groups, dtype=torch.float32,
                           device=self.device)
        if is_vector_leaf(self.gbm.trees):
            return margin_raw(stack_trees(
                self.gbm.trees[lo:hi], self.gbm.tree_info[lo:hi],
                self.n_groups, self.device), X, zero)
        w = self.gbm.tree_weights()
        pf = PackedForest.from_trees(self.gbm.trees[lo:hi],
                                     self.gbm.tree_info[lo:hi], self.n_groups,
                                     None if w is None else w[lo:hi])
        return pf.margin(X, zero)

    def _vertical_margin_delta(self, dm: DMatrix, lo: int, hi: int,
                               idx: Optional[Sequence[int]] = None,
                               weights: Optional[np.ndarray] = None
                               ) -> torch.Tensor:
        """The margin [n, G] of trees [lo, hi), each at its weight (or of
        the trees ``idx`` at ``weights``: dart's dropped ones), on this
        party's block of features by the decision-bit protocol (the JAX
        package's ``_vertical_margin_delta``): the block's offset is the
        grower's, or, for a loaded model, the sum of the lower ranks'
        widths."""
        comm = collective.get_communicator()
        g = getattr(self.gbm, "_grower", None)
        if g is not None and getattr(g, "f_offset", None) is not None:
            offset = g.f_offset
        else:
            widths = comm.allgather_objects(int(dm.num_col()))
            offset = int(sum(widths[:comm.get_rank()]))
        if idx is None:
            idx = range(lo, hi)
            w = self.gbm.tree_weights()
            weights = None if w is None else w[lo:hi]
        out = federated_vertical_margin(
            [self.gbm.trees[i] for i in idx],
            [self.gbm.tree_info[i] for i in idx], self.n_groups,
            np.asarray(dm.values(), np.float32), offset, comm,
            tree_weights=weights)
        return torch.from_numpy(out).to(self.device)

    def _cached_margin(self, dm: DMatrix, is_train: bool = False
                       ) -> torch.Tensor:
        """The margin of every tree so far, brought up to date by walking
        only the trees the cache has not seen (dart: recomputed when the
        forest changed, ``Dart.compute_margin``)."""
        st = self._state_of(dm, is_train)
        total = self.gbm.version()
        if not self.gbm.supports_margin_cache:
            st["margin"] = self.gbm.compute_margin(st, self._walk_trees)
        elif st["n_trees"] < total:
            st["margin"] = st["margin"] + self._walk_trees(
                st, st["n_trees"], total)
        st["n_trees"] = total
        return st["margin"]

    # ---------------------------------------------------------------- training
    def update(self, dtrain: DMatrix, iteration: int,
               fobj: Optional[Callable] = None) -> None:
        """One boosting round (reference ``XGBoosterUpdateOneIter``);
        ``fobj(margin, dtrain)`` -> (grad, hess): a custom objective."""
        if dtrain.info.labels is None and fobj is None \
                and not self._is_vertical_federated():
            raise ValueError("training needs labels: DMatrix(X, label=y)")
        self._configure(dtrain)
        if self.tree_param.process_type == "update":
            self._update_existing_trees(dtrain, fobj)
            return
        st = self._state_of(dtrain, is_train=True)
        if self.gbm.supports_margin_cache:
            margin = self._cached_margin(dtrain, is_train=True)
        else:
            margin = self.gbm.training_margin(st, self._walk_trees)
        with self._monitor.section("GetGradient") as sec:
            gpair = self._gradient(margin, st, dtrain, iteration, fobj)
            sec.sync_on(gpair)
        if observer.enabled():
            observer.observe("gpair", gpair, iteration)
        self._boost_round(st, margin, gpair, iteration, refresh=True)
        if observer.enabled():
            observer.observe("margin", st["margin"], iteration)
        if obs_memory.enabled():
            self._mem_round(st)

    def _mem_round(self, st: Dict[str, Any]) -> None:
        """The memory monitor's round boundary (callers test
        ``obs_memory.enabled()``, so the default path stays free): book
        the margin cache (the CPU's accounting), sample the watermark and
        close the round's window."""
        obs_memory.watch_device(self.device)
        if self.ctx.mesh is not None:
            for d in self.ctx.mesh.devices:
                obs_memory.watch_device(d)
        margin = st.get("margin")
        if margin is not None:
            obs_memory.book("carry/margin",
                            margin.numel() * margin.element_size())
        obs_memory.sample("round")
        obs_memory.note_round()

    def update_batch(self, dtrain: DMatrix,
                     iterations: Sequence[int]) -> bool:
        """Run the rounds ``iterations`` as one batch, the JAX package's
        ``update_batch``: True when this configuration batches (the one
        its fused round program takes, :meth:`_batchable`), the model
        then equal to as many ``update`` calls bit for bit; False, with
        nothing run, for ``process_type="update"``, for a continuation's
        first round (the cache has not walked the loaded trees yet) and
        for a configuration the JAX package runs round by round. A batch
        is its rounds run one by one: it does the same work, so ``train``
        does not batch (a CUDA graph of the round is ROADMAP A.4(c)). A
        round whose gradient diverges raises, and none of the batch's
        trees is kept, as in the JAX package."""
        self._configure(dtrain)
        if self.tree_param.process_type == "update":
            return False
        st = self._state_of(dtrain, is_train=True)
        if st["n_trees"] < self.gbm.version() or not self._batchable(st):
            return False
        gbm = self.gbm
        kept = (len(gbm.trees), len(gbm.tree_info),
                len(gbm.iteration_indptr), st["margin"], st["n_trees"])
        try:
            for it in iterations:
                self.update(dtrain, int(it))
        except NumericalDivergence:
            del gbm.trees[kept[0]:], gbm.tree_info[kept[1]:]
            del gbm.iteration_indptr[kept[2]:]
            st["margin"], st["n_trees"] = kept[3], kept[4]
            self._packed = {}
            raise
        return True

    def _batchable(self, st: Dict[str, Any]) -> bool:
        """The JAX package's ``_fused_binding`` test: a plain ``gbtree``
        (no dart, one tree a group and round, depthwise with no
        ``max_leaves``) growing scalar trees by ``hist`` from resident
        bins, an objective with the stock gradient and no leaf refresh,
        and scalar objective parameters. ``XTPU_SCAN_CLASSES=0`` takes
        the JAX package's multi-class binding away, so the answer is its
        answer there too."""
        gbm = self.gbm
        binned = st.get("binned")
        if (type(gbm) is not GBTree or gbm.tree_method != "hist"
                or gbm.num_parallel_tree != 1
                or gbm.multi_strategy != "one_output_per_tree"
                or self.tree_param.grow_policy != "depthwise"
                or self.tree_param.max_leaves > 0
                or self.obj.info.zero_hess
                or binned is None or binned.is_paged
                or (gbm.n_groups > 1 and os.environ.get(
                    "XTPU_SCAN_CLASSES", "1") == "0")):
            return False
        if type(self.obj).get_gradient is not Objective.get_gradient:
            return False        # ranking and survival: their own gradient
        return all(isinstance(v, (int, float, str, bool))
                   for k, v in self.obj.params.items() if k != "eval_metric")

    def _gradient(self, margin: torch.Tensor, st: Dict[str, Any],
                  dtrain: DMatrix, iteration: int,
                  fobj: Optional[Callable]) -> torch.Tensor:
        """The round's [n, K, 2] gradient: the objective's, or the custom
        ``fobj``'s on the margin as numpy (squeezed), reshaped to the
        margin's shape."""
        if fobj is None and self._is_vertical_federated():
            # margins are on every party, labels on the label rank: its
            # gradient reaches the others (reference ApplyWithLabels in
            # ObjFunction::GetGradient)
            g = collective.apply_with_labels(lambda: self.obj.get_gradient(
                margin, st["labels"], st["weights"], iteration,
                **self._obj_inputs(st)).cpu().numpy())
            return torch.from_numpy(np.asarray(g)).to(margin.device)
        if fobj is None:
            return self.obj.get_gradient(margin, st["labels"], st["weights"],
                                         iteration, **self._obj_inputs(st))
        grad, hess = fobj(margin.cpu().numpy().squeeze(), dtrain)
        gpair = torch.stack([self._as_margin(grad, margin),
                             self._as_margin(hess, margin)], dim=-1)
        return guard_gradient(gpair, "custom objective", iteration)

    @staticmethod
    def _as_margin(v: Any, margin: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            v, np.float32).reshape(margin.shape)).to(margin.device)

    def _boost_round(self, st: Dict[str, Any], margin: torch.Tensor,
                     gpair: torch.Tensor, iteration: int,
                     refresh: bool = False) -> None:
        """Grow round ``iteration``'s trees from ``gpair`` (its key
        ``fold_in(make_key(it), it)``) and move the cache's margin;
        ``refresh``: an adaptive-leaf objective's leaves are refreshed
        from ``margin`` and the labels (``update``'s rounds; ``boost``'s
        gradients are the caller's, as in the JAX package)."""
        key = xrandom.fold_in(self.ctx.make_key(iteration), iteration)
        adaptive = {}
        if refresh and self.obj.info.zero_hess:
            adaptive = dict(obj=self.obj, margin=margin,
                            labels=st["labels"], weights=st["weights"])
        with self._monitor.section("BoostOneIter") as sec:
            delta = self._grow_round(st, margin, gpair, key, adaptive)
            sec.sync_on(delta)
        with self._monitor.section("UpdateCache") as sec:
            if self.gbm.supports_margin_cache:
                st["margin"] = margin + delta
            else:
                st["margin"] = self.gbm.compute_margin(st, self._walk_trees)
            sec.sync_on(st["margin"])
        st["n_trees"] = self.gbm.version()
        self._packed = {}

    def _grow_round(self, st: Dict[str, Any], margin: torch.Tensor,
                    gpair: torch.Tensor, key, adaptive: Dict[str, Any]):
        """The round's trees from ``gpair`` -> the margin's delta (None
        for a booster without a margin cache, which recomputes it)."""
        src = self._grow_source(st)
        if self.ctx.mesh is not None:
            # the mesh's pad rows carry zero gradient (weight 0 in the JAX
            # package's padded state); row sampling draws over them too
            n_pad = (src.bins.shape[0] if isinstance(src, BinnedMatrix)
                     else src.n_pad)
            gpair = torch.cat([gpair, gpair.new_zeros(
                (n_pad - gpair.shape[0],) + tuple(gpair.shape[1:]))])
            adaptive["n_rows"] = st["n"]
        if self.gbm.supports_margin_cache:
            return self.gbm.do_boost(src, gpair, key, **adaptive)
        self.gbm.do_boost(src, gpair, key, state=st, **adaptive)
        return None

    def boost(self, dtrain: DMatrix, grad: Any, hess: Any) -> None:
        """One round from gradients the caller computed (reference
        ``Booster.boost``), each [n] or [n, K], at round
        ``num_boosted_rounds()``'s key."""
        self._configure(dtrain)
        st = self._state_of(dtrain, is_train=True)
        if self.gbm.supports_margin_cache:
            margin = self._cached_margin(dtrain, is_train=True)
        else:
            margin = st["margin"]
        gpair = torch.stack([self._as_margin(grad, margin),
                             self._as_margin(hess, margin)], dim=-1)
        self._boost_round(st, margin, gpair, self.num_boosted_rounds())

    def _update_existing_trees(self, dtrain: DMatrix,
                               fobj: Optional[Callable]) -> None:
        """``process_type="update"`` (reference ``src/gbm/gbtree.cc``): at
        the first call the model's trees move to a queue and the model
        starts empty, every cache back at its base margin; each call takes
        the next round's trees from the queue, runs the ``updater`` list
        (``refresh``, ``prune``, ``sync``) on each against the gradients
        of the margin of the rounds updated so far, and appends them."""
        if not hasattr(self, "_trees_to_update"):
            gbm = self.gbm
            self._trees_to_update = (list(gbm.trees), list(gbm.tree_info),
                                     list(gbm.iteration_indptr))
            gbm.trees, gbm.tree_info, gbm.iteration_indptr = [], [], [0]
            for c in self._caches.values():
                if c["margin"] is not None:
                    c["margin"], c["n_trees"] = c["base"], 0
        old_trees, old_info, old_indptr = self._trees_to_update
        if is_vector_leaf(old_trees):
            raise NotImplementedError(
                "process_type=update does not support multi_output_tree "
                "models")
        it = self.num_boosted_rounds()
        if it >= len(old_indptr) - 1:
            raise ValueError(
                "process_type=update: no more trees to update "
                f"(model has {len(old_indptr) - 1} iterations)")
        updaters = [u.strip() for u in str(self.learner_params.get(
            "updater", "refresh")).split(",") if u.strip()]
        for up in updaters:
            if up not in UPDATERS:
                raise ValueError(f"unknown updater '{up}' for "
                                 "process_type=update")
        st = self._state_of(dtrain, is_train=True)
        if self.gbm.supports_margin_cache:
            margin = self._cached_margin(dtrain, is_train=True)
        else:
            margin = self.gbm.compute_margin(st, self._walk_trees)
        gpair = self._gradient(margin, st, dtrain, it, fobj).cpu().numpy()
        X = np.asarray(dtrain.values(), np.float32)
        for t_idx in range(old_indptr[it], old_indptr[it + 1]):
            tree, k = old_trees[t_idx], old_info[t_idx]
            for up in updaters:
                if up == "refresh":
                    tree = refresh_tree(tree, X, gpair[:, k, :],
                                        self.tree_param,
                                        refresh_leaf=bool(
                                            self.tree_param.refresh_leaf))
                elif up == "prune":
                    tree = prune_tree(tree, self.tree_param)
                else:
                    tree = sync_trees([tree])[0]
            self.gbm.trees.append(tree)
            self.gbm.tree_info.append(k)
        self.gbm.iteration_indptr.append(len(self.gbm.trees))
        # a refreshed tree keeps its index with new leaves: the caches that
        # key on tree counts (dart's margin and round deltas) are stale
        for c in self._caches.values():
            c.pop("dart_margin", None)
            c.pop("dart_deltas", None)
        self._packed = {}

    def eval_set(self, evals: Sequence[Tuple[DMatrix, str]],
                 iteration: int = 0, feval: Optional[Callable] = None,
                 output_margin: bool = True) -> str:
        """The reference-format line ``[i]\\tname-metric:value...``.
        ``feval(preds, dmatrix)`` -> (name, value) or a list of them: a
        custom metric, given the margin (``output_margin``) or the
        transformed predictions, as numpy."""
        self._configure(None)
        vertical = self._is_vertical_federated()
        msg = f"[{iteration}]"
        for dm, name in evals:
            if dm.info.labels is None and not vertical:
                raise ValueError(f"eval set {name!r} has no labels")
            margin = self._cached_margin(dm)
            preds = _squeeze(self.obj.pred_transform(margin).cpu().numpy())
            for metric in self._eval_metrics:
                # vertical parties: the label rank's score (reference
                # ApplyWithLabels around Metric::Evaluate)
                score = self._with_labels(
                    lambda m=metric: float(m(preds, dm.info)))
                msg += f"\t{name}-{metric.full_name}:{score:.6f}"
            if feval is not None:
                def custom(dm=dm, margin=margin, preds=preds):
                    res = feval(_squeeze(margin.cpu().numpy())
                                if output_margin else preds, dm)
                    return [(str(k), float(v)) for k, v in
                            (res if isinstance(res, list) else [res])]

                for mname, val in self._with_labels(custom):
                    msg += f"\t{name}-{mname}:{val:.6f}"
        return msg

    def eval(self, data: DMatrix, name: str = "eval",
             iteration: int = 0) -> str:
        """The eval line of one matrix (reference ``Booster.eval``)."""
        return self.eval_set([(data, name)], iteration)

    # ------------------------------------------------------------- predict
    def _validate_features(self, data: DMatrix) -> None:
        nf = self.num_features()
        if nf and data.num_col() != nf:
            raise ValueError(
                f"feature count mismatch: model has {nf}, data has "
                f"{data.num_col()}")
        names = data.info.feature_names
        if self.feature_names and names and self.feature_names != names:
            missing = set(self.feature_names) - set(names)
            extra = set(names) - set(self.feature_names)
            raise ValueError(
                "feature_names mismatch between model and data"
                + (f"; missing from data: {sorted(missing)}" if missing
                   else "")
                + (f"; unexpected in data: {sorted(extra)}" if extra else ""))

    def packed_forest(self, iteration_range=None) -> Optional[PackedForest]:
        """The packed form of the selected rounds (packed once, cached);
        ``None`` when they hold no trees."""
        self._require_model()
        key = self.gbm._tree_range(iteration_range)
        if key[1] <= key[0]:
            return None
        pf = self._packed.get(key)
        if pf is None:
            with self._packed_lock:
                pf = self._packed.get(key)
                if pf is None:
                    pf = PackedForest.from_booster(self, iteration_range)
                    self._packed[key] = pf
        return pf

    def predict(self, data: DMatrix, output_margin: bool = False,
                pred_leaf: bool = False, pred_contribs: bool = False,
                approx_contribs: bool = False,
                pred_interactions: bool = False,
                iteration_range: Optional[Tuple[int, int]] = None,
                strict_shape: bool = False, training: bool = False,
                validate_features: bool = True) -> np.ndarray:
        """Predictions [n] (or [n, G]; ``strict_shape`` keeps [n, 1])
        through the packed walk on this Booster's device, or, for
        vector-leaf trees, through their torch walk
        (``boosting/predict.py margin_raw``); a linear model's X W + b;
        ``pred_leaf``: the leaf (compact BFS node id) each row reaches in
        each selected tree, int32 [n, T]; ``pred_contribs`` /
        ``pred_interactions`` (``approx_contribs``: Saabas's): feature
        contributions (:meth:`_predict_contribs`)."""
        self._require_model()
        if validate_features:
            self._validate_features(data)
        vertical = self._is_vertical_federated()
        if pred_contribs or pred_interactions:
            if is_vector_leaf(self.gbm.trees):
                raise NotImplementedError(
                    "SHAP contributions are not supported for "
                    "multi_output_tree models")
            if vertical:
                raise NotImplementedError(
                    "SHAP contributions are not available under vertical "
                    "federated column split (no party sees all features)")
            return self._predict_contribs(data, approx_contribs,
                                          pred_interactions, iteration_range,
                                          strict_shape)
        if vertical and pred_leaf:
            raise NotImplementedError(
                "pred_leaf is not available under vertical federated column "
                "split")
        dev = self.device
        if vertical:
            # every split is decided by one party: the decision-bit walk
            lo, hi = self.gbm._tree_range(iteration_range)
            margin = self._vertical_margin_delta(data, lo, hi)
            if data.info.base_margin is not None:
                margin = margin + torch.from_numpy(np.asarray(
                    data.info.base_margin, np.float32)).to(dev).reshape(
                        margin.shape[0], -1)
            else:
                margin = margin + torch.from_numpy(self._base_np()).to(dev)
            out = margin if output_margin else self.obj.pred_transform(margin)
            out = out.cpu().numpy()
            return out if strict_shape else _squeeze(out)
        X = torch.from_numpy(np.ascontiguousarray(data.values())).to(dev)
        if isinstance(self.gbm, GBLinear):
            if pred_leaf:
                return np.zeros((data.num_row(), 0), dtype=np.int32)
            base = torch.zeros(self.n_groups, dtype=torch.float32, device=dev)
            margin = self.gbm.predict_margin(X, base)
            if data.info.base_margin is not None:
                margin = margin + torch.from_numpy(np.asarray(
                    data.info.base_margin, np.float32)).to(dev).reshape(
                        margin.shape[0], -1)
            else:
                margin = margin + torch.from_numpy(self._base_np()).to(dev)
            out = margin if output_margin else self.obj.pred_transform(margin)
            out = out.cpu().numpy()
            return out if strict_shape else _squeeze(out)
        if pred_leaf:
            lo, hi = self.gbm._tree_range(iteration_range)
            if hi <= lo:
                return np.zeros((data.num_row(), 0), dtype=np.int32)
            forest = stack_trees(self.gbm.trees[lo:hi],
                                 self.gbm.tree_info[lo:hi], self.n_groups,
                                 dev)
            return leaf_positions(forest, X).cpu().numpy()
        if data.info.base_margin is not None:
            base = torch.zeros(self.n_groups, dtype=torch.float32, device=dev)
            rows = torch.from_numpy(np.asarray(
                data.info.base_margin, np.float32)).to(dev)
        else:
            base = torch.tensor(np.broadcast_to(self._base_np(),
                                                (self.n_groups,)), device=dev)
            rows = None
        lo, hi = self.gbm._tree_range(iteration_range)
        if hi <= lo:
            margin = base[None, :].expand(X.shape[0], -1).clone()
        elif is_vector_leaf(self.gbm.trees):
            margin = margin_raw(stack_trees(
                self.gbm.trees[lo:hi], self.gbm.tree_info[lo:hi],
                self.n_groups, dev), X, base)
        else:
            margin = self.packed_forest(iteration_range).margin(X, base)
        if rows is not None:
            margin = margin + rows.reshape(margin.shape[0], -1)
        out = margin if output_margin else self.obj.pred_transform(margin)
        out = out.cpu().numpy()
        return out if strict_shape else _squeeze(out)

    def _shap_pack(self, iteration_range) -> ShapPack:
        """The per-leaf path tables of the selected rounds (built once,
        cached beside the packed forests)."""
        key = ("shap",) + tuple(self.gbm._tree_range(iteration_range))
        pack = self._packed.get(key)
        if pack is None:
            trees, info, weights = self.gbm.forest_slice(iteration_range)
            pack = build_shap_pack(trees, info, weights, self.n_groups)
            self._packed[key] = pack
        return pack

    def _predict_contribs(self, data: DMatrix, approx: bool,
                          interactions: bool, iteration_range,
                          strict_shape: bool) -> np.ndarray:
        """SHAP / Saabas contributions [n, G, F + 1] or interactions
        [n, G, F + 1, F + 1] (the group axis squeezed at one group unless
        ``strict_shape``), f32, on this Booster's device: a linear model's
        x W and bias (interactions undefined), a forest's through
        ``ops/shap.py`` in float64. The bias column is the expected
        output plus the base score (a matrix's ``base_margin`` is not
        added, as in the JAX package)."""
        dev = self.device
        X = torch.from_numpy(np.ascontiguousarray(data.values(),
                                                  np.float32)).to(dev)
        n, F = X.shape
        base = self._base_np()
        if isinstance(self.gbm, GBLinear):
            if interactions:
                raise ValueError(
                    "pred_interactions is not defined for gblinear")
            out = torch.zeros((n, self.n_groups, F + 1), dtype=torch.float32,
                              device=dev)
            if self.gbm.W is not None:
                self.gbm._to(dev)
                out[:, :, :F] = torch.nan_to_num(X, nan=0.0)[:, None, :] \
                    * self.gbm.W.T[None, :, :]
                out[:, :, F] = (self.gbm.bias + torch.from_numpy(base).to(
                    dev))[None, :]
            else:
                out[:, :, F] = torch.from_numpy(base).to(dev)[None, :]
        elif interactions and approx:
            raise NotImplementedError(
                "approx_contribs with pred_interactions is not supported; "
                "use exact interactions")
        else:
            lo, hi = self.gbm._tree_range(iteration_range)
            if hi <= lo:            # no trees: the base score alone
                width = (F + 1,) * (2 if interactions else 1)
                out = torch.zeros((n, self.n_groups) + width,
                                  dtype=torch.float64, device=dev)
                out[(slice(None), slice(None)) + (F,) * len(width)] = \
                    torch.from_numpy(base.astype(np.float64)).to(dev)
            else:
                pack = self._shap_pack(iteration_range)
                fn = (shap_ops.interactions if interactions else
                      shap_ops.saabas if approx else shap_ops.contribs)
                out = fn(pack, X, base)
        out = out.cpu().numpy()
        if not strict_shape and self.n_groups == 1:
            out = out[:, 0]
        return out.astype(np.float32)

    def inplace_predict(self, data: Any, iteration_range=None,
                        predict_type: str = "value",
                        missing: float = np.nan, base_margin: Any = None,
                        strict_shape: bool = False) -> np.ndarray:
        """``predict`` straight from an array (any input ``DMatrix``
        takes); ``predict_type`` ``"margin"`` for the raw margin."""
        dm = DMatrix(data, missing=missing, base_margin=base_margin)
        return self.predict(dm, output_margin=(predict_type == "margin"),
                            iteration_range=iteration_range,
                            strict_shape=strict_shape)

    # ------------------------------------------------------------- snapshots
    def make_snapshot(self, dtrain: Optional[DMatrix] = None,
                      fingerprint: Optional[Dict[str, Any]] = None,
                      round_: Optional[int] = None):
        """The training state (``utils/checkpoint.py``, the JAX package's
        ``make_snapshot``): the model, the round counter, the training
        margin [n, K] f32 as the cache holds it, a stateful booster's
        ``RandomState`` (dart's drops) and the eval history."""
        from .utils.checkpoint import TrainingSnapshot

        margin = None
        st = self._caches.get(id(dtrain)) if dtrain is not None else None
        if st is not None and st["is_train"] and st["margin"] is not None:
            margin = st["margin"].detach().cpu().numpy().astype(np.float32)
        extra: Dict[str, Any] = {}
        brng = getattr(self.gbm, "_rng", None)
        if brng is not None:
            alg, keys, pos, has_gauss, cached = brng.get_state()
            extra["booster_rng"] = {
                "alg": str(alg), "keys": np.asarray(keys, np.int64),
                "pos": int(pos), "has_gauss": int(has_gauss),
                "cached": float(cached)}
        tl = self.training_log
        if tl is not None and (len(tl) or tl.records):
            extra["training_log"] = tl.to_obj()
        return TrainingSnapshot(
            round=int(round_ if round_ is not None
                      else self.num_boosted_rounds()),
            model=bytes(self.save_raw("ubj")), margin=margin,
            fingerprint=dict(fingerprint or {}),
            rng={"seed": int(self.ctx.seed),
                 "seed_per_iteration": bool(self.ctx.seed_per_iteration)},
            extra=extra)

    def _prime_resume(self, dtrain: DMatrix, snap) -> None:
        """Install a snapshot's state (the JAX package's
        ``_prime_resume``): the booster's ``RandomState``, the eval
        history, and its margin as the training cache's, so that the next
        ``update`` goes on from the interrupted state's bits. Without a
        margin the cache walks the trees, as a continuation does."""
        self._configure(dtrain)
        st = self._state_of(dtrain, is_train=True)
        rng = snap.extra.get("booster_rng") if snap.extra else None
        if rng is not None and hasattr(self.gbm, "_rng"):
            brng = self.gbm._rng or np.random.RandomState()
            brng.set_state((rng["alg"],
                            np.asarray(rng["keys"]).astype(np.uint32),
                            int(rng["pos"]), int(rng["has_gauss"]),
                            float(rng["cached"])))
            self.gbm._rng = brng
        tl = snap.extra.get("training_log") if snap.extra else None
        if tl is not None:
            self.training_log = TrainingLog.from_obj(tl)
        if snap.margin is None:
            return
        m = np.asarray(snap.margin, np.float32)
        st["margin"] = torch.from_numpy(
            m.reshape(m.shape[0], -1).copy()).to(self.device)
        st["n_trees"] = self.gbm.version()
        hook = getattr(self.gbm, "on_resume", None)
        if hook is not None:
            hook(st)

    def __getstate__(self):
        return {"raw": bytes(self.save_raw("json")),
                "device": self.ctx.device}

    def __setstate__(self, state):
        self.__init__({"device": state["device"]},
                      model_file=state["raw"])

    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, _: Any) -> "Booster":
        out = Booster({"device": self.ctx.device},
                      model_file=self.save_raw("json"))
        out.set_param({k: v for k, v in self.learner_params.items()
                       if _jsonable(v)})
        return out

    def copy(self) -> "Booster":
        """A copy of the model on the same device (reference
        ``Booster.copy``)."""
        return self.__copy__()

    # ------------------------------------------------------------------ config
    def save_config(self) -> str:
        """The training configuration as a JSON string (reference
        ``XGBoosterSaveJsonConfig``): the learner's parameters and the
        tree parameters."""
        return json.dumps({
            "version": [2, 0, 0],
            "learner": {
                "learner_train_param": {
                    k: v for k, v in self.learner_params.items()
                    if _jsonable(v)},
                "gradient_booster": {
                    "name": self.learner_params.get("booster", "gbtree"),
                    "tree_train_param": self.tree_param.to_json(),
                },
            },
        })

    def load_config(self, config: str) -> None:
        """Set the parameters of a :meth:`save_config` string."""
        learner = json.loads(config).get("learner", {})
        self.set_param(learner.get("learner_train_param", {}))
        self.set_param(learner.get("gradient_booster", {}).get(
            "tree_train_param", {}))

    # ------------------------------------------------------------------ dumps
    def get_dump(self, fmap: str = "", with_stats: bool = False,
                 dump_format: str = "text") -> List[str]:
        """One dump a tree, ``text``, ``json`` or ``dot`` (reference
        ``XGBoosterDumpModelEx``); ``fmap`` is ignored, as in the JAX
        package."""
        self._require_model()
        out = []
        for tree in self.gbm.trees:
            if dump_format == "json":
                out.append(json.dumps(dump.dump_json(
                    tree, self.feature_names, with_stats)))
            elif dump_format == "dot":
                out.append(dump.dump_dot(tree, self.feature_names,
                                         with_stats))
            else:
                out.append(dump.dump_text(tree, self.feature_names,
                                          with_stats))
        return out

    def dump_model(self, fout: str, fmap: str = "", with_stats: bool = False,
                   dump_format: str = "text") -> None:
        dumps = self.get_dump(fmap, with_stats, dump_format)
        with open(fout, "w") as fh:
            if dump_format == "json":
                fh.write("[\n" + ",\n".join(dumps) + "\n]")
            else:
                for i, d in enumerate(dumps):
                    fh.write(f"booster[{i}]:\n{d}")

    def trees_to_dataframe(self, fmap: str = ""):
        self._require_model()
        return dump.trees_to_dataframe(self.gbm.trees, self.feature_names)

    def get_score(self, fmap: str = "", importance_type: str = "weight"
                  ) -> Dict[str, float]:
        """Feature importances: ``weight``, ``gain``, ``total_gain``,
        ``cover`` or ``total_cover`` (``dump.feature_scores``)."""
        self._require_model()
        if isinstance(self.gbm, GBLinear):
            names = self.feature_names
            return {(names[f] if names and f < len(names) else f"f{f}"):
                    float(v)
                    for f, v in enumerate(self.gbm.feature_scores())
                    if v != 0.0}
        return dump.feature_scores(self.gbm.trees, importance_type,
                                   self.feature_names)

    def get_fscore(self, fmap: str = "") -> Dict[str, float]:
        """Split counts a feature (``get_score`` by ``weight``)."""
        return self.get_score(fmap, importance_type="weight")

    def inspect(self) -> Dict[str, Any]:
        """The structural report of ``dump.model_inspect``."""
        self._require_model()
        return dump.model_inspect(self)

    def get_split_value_histogram(self, feature: str, fmap: str = "",
                                  bins: Optional[int] = None,
                                  as_pandas: bool = True):
        """Histogram of the thresholds the splits on ``feature`` use, read
        from the text dump (reference ``get_split_value_histogram``)."""
        import re

        regexp = re.compile(r"\[{0}<([\d.Ee+-]+)\]".format(
            re.escape(feature)))
        values: List[float] = []
        for d in self.get_dump(fmap=fmap):
            values.extend(float(x) for x in re.findall(regexp, d))
        n_unique = len(np.unique(values))
        nbins = max(min(n_unique, bins) if bins is not None else n_unique, 1)
        counts, edges = np.histogram(values, bins=nbins)
        out = np.column_stack((edges[1:], counts))
        out = out[out[:, 1] > 0]
        if out.size == 0:
            names = self.feature_names or [
                f"f{i}" for i in range(self.num_features())]
            types = self.feature_types or []
            i = names.index(feature) if feature in names else len(types)
            if i < len(types) and types[i] == "c":
                raise ValueError("Split value histogram doesn't support "
                                 "categorical split.")
        if as_pandas:
            try:
                from pandas import DataFrame
            except ImportError:
                return out
            return DataFrame(out, columns=["SplitValue", "Count"])
        return out

    # ------------------------------------------------------------------ IO
    def save_raw(self, raw_format: str = "ubj") -> bytearray:
        obj = self._model_to_json()
        if raw_format == "json":
            return bytearray(json.dumps(obj).encode())
        return bytearray(dumps_ubjson(obj))

    def save_model(self, fname: str) -> None:
        with open(fname, "wb") as fh:
            fh.write(self.save_raw("ubj" if str(fname).endswith(".ubj")
                                   else "json"))

    @staticmethod
    def _reject_legacy_binary(head: bytes) -> None:
        if head.lstrip(b"\x00").startswith(b"binf") or head.startswith(
                b"bs64"):
            raise ValueError(
                "this is a legacy binary ('binf') XGBoost model; the "
                "deprecated pre-JSON format is not supported — re-save it "
                "as JSON/UBJSON with reference XGBoost >= 1.6 "
                "(booster.save_model('model.json')) and load that instead")

    def load_model(self, fname: Union[str, bytes, bytearray]) -> None:
        if isinstance(fname, (bytes, bytearray)):
            raw = bytes(fname)
            self._reject_legacy_binary(raw[:16])
            # a UBJSON object also begins with the byte '{' — sniff JSON
            # first, fall back to the binary codec
            try:
                obj = json.loads(raw.decode())
            except (UnicodeDecodeError, ValueError):
                obj = loads_ubjson(raw)
        else:
            with open(fname, "rb") as fh:
                raw = fh.read()
            self._reject_legacy_binary(raw[:16])
            obj = (loads_ubjson(raw) if str(fname).endswith(".ubj")
                   else json.loads(raw.decode()))
        self._model_from_json(obj)

    def _model_to_json(self) -> dict:
        self._require_model()
        return {
            "version": list(self._version),
            "learner": {
                "attributes": dict(self.attributes_),
                "feature_names": self.feature_names or [],
                "feature_types": self.feature_types or [],
                "learner_model_param": {
                    "base_score": self._base_np().tolist(),
                    "num_class": int(self.learner_params.get("num_class", 0)),
                    "num_target": self.n_groups,
                    "num_feature": self.num_features(),
                },
                "objective": self.obj.to_json(),
                "gradient_booster": self.gbm.to_json(),
            },
            "config": {
                "tree_param": self.tree_param.to_json(),
                "learner_params": {k: v for k, v in
                                   self.learner_params.items()
                                   if _jsonable(v)},
            },
        }

    def _model_from_json(self, obj: dict) -> None:
        if is_reference_model(obj):
            obj = reference_to_native_json(obj)
        learner = obj["learner"]
        self._version = list(obj.get("version", self._version))
        cfg = obj.get("config", {})
        self.tree_param = TrainParam.from_dict(cfg.get("tree_param", {}))
        self.learner_params.update(cfg.get("learner_params", {}))
        if self.learner_params.get("data_split_mode", "row") == "col":
            # the split mode describes the training data, not the model
            self.learner_params["data_split_mode"] = "row"
        self._seed_from_params()
        self.attributes_ = dict(learner.get("attributes", {}))
        self.feature_names = learner.get("feature_names") or None
        self.feature_types = learner.get("feature_types") or None
        lmp = learner.get("learner_model_param", {})
        self._num_features = int(lmp.get("num_feature", 0) or 0)
        self.base_margin_ = np.asarray(lmp.get("base_score", [0.0]),
                                       dtype=np.float32).reshape(-1)
        obj_cfg = learner.get("objective", {})
        name = obj_cfg.get("name", self.learner_params.get(
            "objective", "reg:squarederror"))
        self.learner_params["objective"] = name
        self.obj = get_objective(name, {k: v for k, v in obj_cfg.items()
                                        if k != "name"})
        n_groups = max(1, int(lmp.get("num_target", 1)))
        gb = learner.get("gradient_booster", {})
        booster = gb.get("name", "gbtree") if gb else "gbtree"
        if booster not in ("gbtree", "dart", "gblinear"):
            raise ValueError(f"unknown booster: {booster}")
        self.learner_params["booster"] = booster
        gbm = {"dart": Dart, "gblinear": GBLinear}.get(booster,
                                                        GBTree)(n_groups)
        if gb:
            gbm.from_json(gb)
        self.gbm = gbm
        if isinstance(gbm, GBLinear):
            self._configure_linear()
        em = self.learner_params.get("eval_metric")
        if em:
            names = em if isinstance(em, (list, tuple)) else [em]
            self._eval_metrics = [get_metric(n) for n in names]
        else:
            self._eval_metrics = []
        self._configured = False
        self._caches = {}
        self._packed = {}


def train(params: Dict[str, Any], dtrain: DMatrix,
          num_boost_round: int = 10, *,
          evals: Sequence[Tuple[DMatrix, str]] = (),
          obj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          maximize: Optional[bool] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int, None] = True,
          xgb_model: Optional[Union[str, bytes, Booster]] = None,
          callbacks: Optional[Sequence] = None,
          custom_metric: Optional[Callable] = None,
          checkpoint: Optional[Any] = None) -> Booster:
    """Train loop (reference ``python-package/xgboost/training.py``; the
    JAX package's ``train``): ``num_boost_round`` rounds of
    ``Booster.update``, each followed by an evaluation of ``evals`` into
    the callbacks' history ({data: {metric: [scores]}}, scores as the
    6-digit eval line gives them), which ``evals_result`` receives.
    ``verbose_eval`` prints the history's last scores every so many
    rounds (``EvaluationMonitor``, when the global verbosity is above 0);
    ``early_stopping_rounds`` stops when the last metric on the last eval
    set has not improved for that many rounds (``EarlyStopping``, which
    records ``best_iteration`` and ``best_score`` on the booster);
    ``callbacks``: more ``callback.TrainingCallback`` objects, run in
    order before those two. ``obj(margin, dtrain)`` -> (grad, hess): a
    custom objective; ``custom_metric`` (or, when it is None, ``feval``)
    ``(margin, dmatrix)`` -> (name, value): a custom metric beside the
    booster's, given the raw margin, as the JAX package gives it.

    ``checkpoint``: a ``utils.checkpoint.CheckpointConfig``: a training
    snapshot every ``every_n_rounds`` rounds and at the end, and, with
    ``resume``, the newest valid snapshot of this matrix taken up at the
    start (the JAX package's ``train(checkpoint=)``). A resumed run
    counts ``num_boost_round`` as the total, so that the same command
    run again after a crash ends at the straight run's model, byte for
    byte."""
    callbacks = list(callbacks) if callbacks else []
    if verbose_eval and get_config()["verbosity"] > 0:
        period = 1 if verbose_eval is True else int(verbose_eval)
        callbacks.append(EvaluationMonitor(period=period))
    if early_stopping_rounds is not None:
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize, save_best=False))
    container = CallbackContainer(
        callbacks, metric=custom_metric if custom_metric is not None
        else feval)
    ck = resumed = None
    if checkpoint is not None:
        from .utils.checkpoint import CheckpointManager

        ck = CheckpointManager(checkpoint)
        ck.ensure_fingerprint(dtrain)
        if xgb_model is None:
            resumed = ck.find_resume(dtrain)
    if resumed is not None:
        bst = Booster(params, model_file=resumed.model)
    elif isinstance(xgb_model, Booster):
        bst = xgb_model
        bst.set_param(params)
    elif xgb_model is not None:
        bst = Booster(params, model_file=xgb_model)
    else:
        bst = Booster(params)
    if resumed is not None:
        bst._prime_resume(dtrain, resumed)
        if bst.training_log is not None:
            # evals_result and early stopping's patience go on from the
            # snapshot's history
            container.history = bst.training_log
    bst.training_log = container.history
    bst = container.before_training(bst)
    start = bst.num_boosted_rounds()
    end = (max(start, num_boost_round) if resumed is not None
           else start + num_boost_round)
    try:
        for i in range(start, end):
            # round-aware communicators (fault schedules keyed on rounds)
            collective.notify_round(i)
            if container.before_iteration(bst, i):
                break
            bst.update(dtrain, i, fobj=obj)
            stop = container.after_iteration(bst, i, list(evals))
            if ck is not None:
                ck.maybe_save(bst, dtrain, i + 1,
                              force=stop or i + 1 == end)
            if stop:
                break
    except BaseException:
        # the background writer is joined, and a second failure there
        # does not hide the first
        if ck is not None:
            ck.close()
        raise
    if ck is not None:
        ck.close(raise_errors=True)
    bst = container.after_training(bst)
    bst._monitor.maybe_print()   # one table a run (reference: destructor)
    if evals_result is not None:
        evals_result.update(container.history)
    return bst
