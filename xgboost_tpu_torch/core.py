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
"""

from __future__ import annotations

import dataclasses
import json
import threading
import warnings
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from . import dump
from .boosting.dart import Dart
from .boosting.gbtree import GBTree
from .boosting.predict import leaf_positions, stack_trees
from .callback import CallbackContainer, EarlyStopping, EvaluationMonitor
from .config import get_config
from .context import Context
from .data.dmatrix import DMatrix
from .interop import is_reference_model, reference_to_native_json
from .metric import get_metric
from .objective import get_objective
from .objective.base import guard_gradient
from .serve.packed import PackedForest
from .tree.param import TrainParam
from .tree.updaters import UPDATERS, prune_tree, refresh_tree, sync_trees
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
        self.gbm: Optional[GBTree] = None
        self.base_margin_: Optional[np.ndarray] = None
        self._num_features = 0
        self._version: List[int] = [0, 1, 0]
        self._configured = False
        self._caches: Dict[int, Dict[str, Any]] = {}
        self._eval_metrics: List = []
        self._packed: Dict[Tuple[int, int], PackedForest] = {}
        self._packed_lock = threading.Lock()
        if params:
            self.set_param(params)
        self.device = self.ctx.torch_device()   # raises without CUDA
        if model_file is not None:
            self.load_model(model_file)

    # ------------------------------------------------------------------ params
    def set_param(self, params: Union[Dict[str, Any], str],
                  value: Optional[Any] = None) -> None:
        if isinstance(params, str):
            params = {params: value}
        params = dict(params)
        for k in _DEVICE_KEYS:
            if k in params:
                self.ctx = dataclasses.replace(self.ctx,
                                               device=str(params.pop(k)))
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
            if self.gbm is not None:
                self.gbm.tree_param = self.tree_param
                self.gbm._grower = None
                if isinstance(self.gbm, Dart):
                    self.gbm.configure(self.learner_params, self.ctx.seed)
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
        tm = self.learner_params.get("tree_method", "auto")
        if tm not in _HIST_TREE_METHODS:
            raise NotImplementedError(
                f"tree_method={tm!r} is not in the PyTorch port yet "
                "(ROADMAP A.5.8); use 'hist'")
        booster = self.learner_params.get("booster", "gbtree")
        if booster not in ("gbtree", "dart"):
            raise NotImplementedError(
                f"booster {booster!r} is not in the PyTorch port yet "
                "(ROADMAP A.5.9)")
        if self.learner_params.get("data_split_mode", "row") != "row":
            raise NotImplementedError(
                "column-split training is not in the PyTorch port yet "
                "(ROADMAP A.8)")
        if self.learner_params.get("multi_strategy",
                                   "one_output_per_tree") != \
                "one_output_per_tree":
            raise NotImplementedError(
                "multi_strategy='multi_output_tree' is not in the PyTorch "
                "port yet (ROADMAP A.5.7)")
        obj_name = self.learner_params.get("objective", "reg:squarederror")
        if self.obj is None or self.obj.name != obj_name:
            self.obj = get_objective(obj_name, self._obj_params())
        n_groups = max(1, self.obj.n_targets())
        if dtrain is not None and not self._num_features:
            self._num_features = dtrain.num_col()
        if self.gbm is None:
            cls = Dart if booster == "dart" else GBTree
            self.gbm = cls(
                n_groups, num_parallel_tree=int(self.learner_params.get(
                    "num_parallel_tree", 1)))
        if isinstance(self.gbm, Dart):
            self.gbm.configure(self.learner_params, self.ctx.seed)
        self.gbm.tree_param = self.tree_param
        self.gbm.hist_method = str(self.learner_params.get("hist_method",
                                                           "auto"))
        if self.base_margin_ is None:
            bs = self.learner_params.get("base_score")
            if bs is not None:
                margin = self.obj.prob_to_margin(np.asarray([float(bs)]))
                self.base_margin_ = np.full(
                    n_groups, float(np.asarray(margin).reshape(-1)[0]),
                    np.float32)
            elif dtrain is not None and dtrain.info.labels is not None:
                st = self._state_of(dtrain, is_train=True)
                self.base_margin_ = self.obj.init_estimation(
                    st["labels"], st["weights"]).reshape(-1)
            else:
                self.base_margin_ = np.zeros(n_groups, np.float32)
        if not self._eval_metrics and not bool(self.learner_params.get(
                "disable_default_eval_metric", False)):
            self._eval_metrics = [get_metric(self.obj.default_metric)]
        if dtrain is not None and self.feature_names is None:
            self.feature_names = dtrain.info.feature_names
            self.feature_types = dtrain.info.feature_types
        self._configured = True

    # ----------------------------------------------------------- margin caches
    def _state_of(self, dm: DMatrix, is_train: bool) -> Dict[str, Any]:
        """The cache entry of one DMatrix: its device tensors, its base
        margin ``base`` [n, G] and a margin covering the first
        ``n_trees`` trees (both None until the base margin is known)."""
        st = self._caches.get(id(dm))
        if st is None or st["dm"] is not dm:
            dev = self.device
            info = dm.info
            st = {"dm": dm, "margin": None, "n_trees": 0, "binned": None,
                  "X": None, "is_train": False,
                  "labels": None if info.labels is None else
                  torch.from_numpy(info.labels).to(dev),
                  "weights": None if info.weights is None else
                  torch.from_numpy(info.weights).to(dev)}
            self._caches[id(dm)] = st
        if is_train and not st["is_train"]:
            st["binned"] = self._collapse_paged_if_fits(
                dm.binned(self.tree_param.max_bin, self.device))
            st["is_train"] = True
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

    def _collapse_paged_if_fits(self, binned):
        """A paged matrix that fits the page-cache budget, as a resident
        ``BinnedMatrix`` on this Booster's device (``PagedBinnedMatrix.
        resident_binned``; ``XTPU_PAGED_COLLAPSE=0`` keeps it paged);
        anything else as it is."""
        if not binned.is_paged:
            return binned
        res = binned.resident_binned(self.device)
        return binned if res is None else res

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
        binned = self._binned_for_walk(st)
        if binned is not None:
            return self.gbm.margin_delta_binned(binned, lo, hi, self.device)
        if st["X"] is None:
            st["X"] = torch.from_numpy(np.ascontiguousarray(
                st["dm"].values())).to(self.device)
        w = self.gbm.tree_weights()
        pf = PackedForest.from_trees(self.gbm.trees[lo:hi],
                                     self.gbm.tree_info[lo:hi], self.n_groups,
                                     None if w is None else w[lo:hi])
        zero = torch.zeros(self.n_groups, dtype=torch.float32,
                           device=self.device)
        return pf.margin(st["X"], zero)

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
        if dtrain.info.labels is None and fobj is None:
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
        gpair = self._gradient(margin, st, dtrain, iteration, fobj)
        self._boost_round(st, margin, gpair, iteration)

    def _gradient(self, margin: torch.Tensor, st: Dict[str, Any],
                  dtrain: DMatrix, iteration: int,
                  fobj: Optional[Callable]) -> torch.Tensor:
        """The round's [n, K, 2] gradient: the objective's, or the custom
        ``fobj``'s on the margin as numpy (squeezed), reshaped to the
        margin's shape."""
        if fobj is None:
            # ranking objectives also take the matrix's query offsets
            groups = ({"group_ptr": dtrain.info.group_ptr}
                      if self.obj.takes_groups else {})
            return self.obj.get_gradient(margin, st["labels"], st["weights"],
                                         iteration, **groups)
        grad, hess = fobj(margin.cpu().numpy().squeeze(), dtrain)
        gpair = torch.stack([self._as_margin(grad, margin),
                             self._as_margin(hess, margin)], dim=-1)
        return guard_gradient(gpair, "custom objective", iteration)

    @staticmethod
    def _as_margin(v: Any, margin: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            v, np.float32).reshape(margin.shape)).to(margin.device)

    def _boost_round(self, st: Dict[str, Any], margin: torch.Tensor,
                     gpair: torch.Tensor, iteration: int) -> None:
        """Grow round ``iteration``'s trees from ``gpair`` (its key
        ``fold_in(make_key(it), it)``) and move the cache's margin."""
        key = xrandom.fold_in(self.ctx.make_key(iteration), iteration)
        if self.gbm.supports_margin_cache:
            st["margin"] = margin + self.gbm.do_boost(st["binned"], gpair,
                                                      key)
        else:
            self.gbm.do_boost(st["binned"], gpair, key, state=st)
            st["margin"] = self.gbm.compute_margin(st, self._walk_trees)
        st["n_trees"] = self.gbm.version()
        self._packed = {}

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
        msg = f"[{iteration}]"
        for dm, name in evals:
            if dm.info.labels is None:
                raise ValueError(f"eval set {name!r} has no labels")
            margin = self._cached_margin(dm)
            preds = _squeeze(self.obj.pred_transform(margin).cpu().numpy())
            for metric in self._eval_metrics:
                msg += f"\t{name}-{metric.full_name}:{metric(preds, dm.info):.6f}"
            if feval is not None:
                res = feval(_squeeze(margin.cpu().numpy()) if output_margin
                            else preds, dm)
                for mname, val in (res if isinstance(res, list) else [res]):
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
                pred_leaf: bool = False,
                iteration_range: Optional[Tuple[int, int]] = None,
                strict_shape: bool = False,
                validate_features: bool = True) -> np.ndarray:
        """Predictions [n] (or [n, G]) through the packed walk on this
        Booster's device; ``pred_leaf``: the leaf (compact BFS node id)
        each row reaches in each selected tree, int32 [n, T]."""
        self._require_model()
        if validate_features:
            self._validate_features(data)
        dev = self.device
        X = torch.from_numpy(np.ascontiguousarray(data.values())).to(dev)
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
        pf = self.packed_forest(iteration_range)
        if pf is None:
            margin = base[None, :].expand(X.shape[0], -1).clone()
        else:
            margin = pf.margin(X, base)
        if rows is not None:
            margin = margin + rows.reshape(margin.shape[0], -1)
        out = margin if output_margin else self.obj.pred_transform(margin)
        out = out.cpu().numpy()
        return out if strict_shape else _squeeze(out)

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
        if booster not in ("gbtree", "dart"):
            raise NotImplementedError(
                f"booster {booster!r} is not in the PyTorch port yet "
                "(gbtree and dart only; ROADMAP A.5.9)")
        self.learner_params["booster"] = booster
        gbm = (Dart if booster == "dart" else GBTree)(n_groups)
        if gb:
            gbm.from_json(gb)
        self.gbm = gbm
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
          custom_metric: Optional[Callable] = None) -> Booster:
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
    booster's, given the raw margin, as the JAX package gives it."""
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
    if isinstance(xgb_model, Booster):
        bst = xgb_model
        bst.set_param(params)
    elif xgb_model is not None:
        bst = Booster(params, model_file=xgb_model)
    else:
        bst = Booster(params)
    bst = container.before_training(bst)
    start = bst.num_boosted_rounds()
    for i in range(start, start + num_boost_round):
        if container.before_iteration(bst, i):
            break
        bst.update(dtrain, i, fobj=obj)
        if container.after_iteration(bst, i, list(evals)):
            break
    bst = container.after_training(bst)
    if evals_result is not None:
        evals_result.update(container.history)
    return bst
