"""Booster and ``train``: the main training path, prediction and model IO.

Training is the JAX package's ``core.py`` general round loop on one
device: ``Booster.update`` computes the gradient from a margin cache,
``GBTree.do_boost`` grows the round's tree (histograms through kernels
K2, K3, K4), and the cache moves by the tree's per-row delta. ``train`` runs
the rounds and evaluates ``evals`` after each one. ``predict`` and the
eval sets other than the training matrix go through the packed walk
(``serve/packed.py`` + ``ops/walk.py``, kernel K1). Everything runs on
the card unless the Booster was made with ``{"device": "cpu"}``.

``save_raw`` writes the model JSON the JAX package writes
(``_model_to_json``), ``config`` block included, so a model trained
here loads into ``xgboost_tpu`` and a model loaded here saves back to the
bytes it was read from.
"""

from __future__ import annotations

import collections
import json
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .boosting.gbtree import GBTree
from .config import get_config
from .context import Context
from .data.dmatrix import DMatrix
from .interop import is_reference_model, reference_to_native_json
from .metric import get_metric
from .objective import get_objective
from .serve.packed import PackedForest
from .tree.param import TrainParam
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
                self.ctx = Context(device=str(params.pop(k)))
        if "eval_metric" in params:
            em = params.pop("eval_metric")
            names = em if isinstance(em, (list, tuple)) else [em]
            self.learner_params["eval_metric"] = list(names)
            self._eval_metrics = [get_metric(n) for n in names]
        for k in list(params):
            if k in _LEARNER_KEYS:
                self.learner_params[k] = params.pop(k)
        for k in self.tree_param.update_allow_unknown(params):
            warnings.warn(f"Unknown parameter: {k}", stacklevel=2)
        if self._configured and self.obj is not None:
            self.obj = get_objective(
                self.learner_params.get("objective", self.obj.name),
                self._obj_params())
            if self.gbm is not None:
                self.gbm.tree_param = self.tree_param
                self.gbm._grower = None
        self._packed = {}

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
        if booster != "gbtree":
            raise NotImplementedError(
                f"booster {booster!r} is not in the PyTorch port yet "
                "(ROADMAP A.5.9)")
        if int(self.learner_params.get("num_class", 0) or 0) > 1:
            raise NotImplementedError(
                "multiclass training is not in the PyTorch port yet "
                "(ROADMAP A.5.1)")
        if self.learner_params.get("data_split_mode", "row") != "row":
            raise NotImplementedError(
                "column-split training is not in the PyTorch port yet "
                "(ROADMAP A.8)")
        obj_name = self.learner_params.get("objective", "reg:squarederror")
        if self.obj is None or self.obj.name != obj_name:
            self.obj = get_objective(obj_name, self._obj_params())
        if dtrain is not None and not self._num_features:
            self._num_features = dtrain.num_col()
        if self.gbm is None:
            self.gbm = GBTree(
                1, num_parallel_tree=int(self.learner_params.get(
                    "num_parallel_tree", 1)))
        self.gbm.tree_param = self.tree_param
        self.gbm.hist_method = str(self.learner_params.get("hist_method",
                                                           "auto"))
        if self.base_margin_ is None:
            bs = self.learner_params.get("base_score")
            if bs is not None:
                margin = self.obj.prob_to_margin(np.asarray([float(bs)]))
                self.base_margin_ = np.asarray(margin, np.float32).reshape(-1)
            elif dtrain is not None and dtrain.info.labels is not None:
                st = self._state_of(dtrain, is_train=True)
                self.base_margin_ = self.obj.init_estimation(
                    st["labels"], st["weights"]).reshape(-1)
            else:
                self.base_margin_ = np.zeros(1, np.float32)
        if not self._eval_metrics and not bool(self.learner_params.get(
                "disable_default_eval_metric", False)):
            self._eval_metrics = [get_metric(self.obj.default_metric)]
        if dtrain is not None and self.feature_names is None:
            self.feature_names = dtrain.info.feature_names
        self._configured = True

    # ----------------------------------------------------------- margin caches
    def _state_of(self, dm: DMatrix, is_train: bool) -> Dict[str, Any]:
        """The cache entry of one DMatrix: its device tensors and a margin
        covering the first ``n_trees`` trees (``margin`` is None until the
        base margin is known)."""
        st = self._caches.get(id(dm))
        if st is None or st["dm"] is not dm:
            dev = self.device
            info = dm.info
            st = {"dm": dm, "margin": None, "n_trees": 0, "binned": None,
                  "X": None,
                  "labels": None if info.labels is None else
                  torch.from_numpy(info.labels).to(dev),
                  "weights": None if info.weights is None else
                  torch.from_numpy(info.weights).to(dev)}
            self._caches[id(dm)] = st
        if is_train and st["binned"] is None:
            st["binned"] = dm.binned(self.tree_param.max_bin, self.device)
        if st["margin"] is None and self.base_margin_ is not None:
            n = dm.num_row()
            if dm.info.base_margin is not None:
                st["margin"] = torch.from_numpy(np.ascontiguousarray(
                    dm.info.base_margin, np.float32).reshape(n, -1)).to(
                        self.device)
            else:
                base = torch.from_numpy(self._base_np()).to(self.device)
                st["margin"] = base[None, :].expand(n, -1).contiguous()
        return st

    def _walk_trees(self, st: Dict[str, Any], lo: int, hi: int
                    ) -> torch.Tensor:
        """Margin contribution [n, G] of trees [lo, hi) on the cached
        matrix, through the packed walk (kernel K1 on the card)."""
        if st["X"] is None:
            st["X"] = torch.from_numpy(np.ascontiguousarray(
                st["dm"].values())).to(self.device)
        pf = PackedForest.from_trees(self.gbm.trees[lo:hi],
                                     self.gbm.tree_info[lo:hi], self.n_groups)
        zero = torch.zeros(self.n_groups, dtype=torch.float32,
                           device=self.device)
        return pf.margin(st["X"], zero)

    def _cached_margin(self, dm: DMatrix, is_train: bool = False
                       ) -> torch.Tensor:
        """The margin of every tree so far, brought up to date by walking
        only the trees the cache has not seen."""
        st = self._state_of(dm, is_train)
        total = self.gbm.version()
        if st["n_trees"] < total:
            st["margin"] = st["margin"] + self._walk_trees(
                st, st["n_trees"], total)
            st["n_trees"] = total
        return st["margin"]

    # ---------------------------------------------------------------- training
    def update(self, dtrain: DMatrix, iteration: int) -> None:
        """One boosting round (reference ``XGBoosterUpdateOneIter``)."""
        if dtrain.info.labels is None:
            raise ValueError("training needs labels: DMatrix(X, label=y)")
        self._configure(dtrain)
        st = self._state_of(dtrain, is_train=True)
        margin = self._cached_margin(dtrain, is_train=True)
        gpair = self.obj.get_gradient(margin, st["labels"], st["weights"],
                                      iteration)
        delta = self.gbm.do_boost(st["binned"], gpair)
        st["margin"] = margin + delta
        st["n_trees"] = self.gbm.version()
        self._packed = {}

    def eval_set(self, evals: Sequence[Tuple[DMatrix, str]],
                 iteration: int = 0) -> str:
        """The reference-format line ``[i]\\tname-metric:value...``."""
        self._configure(None)
        msg = f"[{iteration}]"
        for dm, name in evals:
            if dm.info.labels is None:
                raise ValueError(f"eval set {name!r} has no labels")
            margin = self._cached_margin(dm)
            preds = self.obj.pred_transform(margin).cpu().numpy()
            if preds.ndim == 2 and preds.shape[1] == 1:
                preds = preds[:, 0]
            for metric in self._eval_metrics:
                msg += f"\t{name}-{metric.full_name}:{metric(preds, dm.info):.6f}"
        return msg

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
                iteration_range: Optional[Tuple[int, int]] = None,
                strict_shape: bool = False,
                validate_features: bool = True) -> np.ndarray:
        """Predictions [n] (or [n, G]) through the packed walk on this
        Booster's device."""
        self._require_model()
        if validate_features:
            self._validate_features(data)
        dev = self.device
        X = torch.from_numpy(np.ascontiguousarray(data.values())).to(dev)
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
        if not strict_shape and out.ndim == 2 and out.shape[1] == 1:
            out = out[:, 0]
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
        if booster != "gbtree":
            raise NotImplementedError(
                f"booster {booster!r} is not in the PyTorch port yet "
                "(gbtree only; ROADMAP A.5.9)")
        self.learner_params["booster"] = booster
        gbm = GBTree(n_groups)
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
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int, None] = True,
          xgb_model: Optional[Union[str, bytes, Booster]] = None,
          early_stopping_rounds: Optional[int] = None,
          callbacks: Optional[Sequence] = None) -> Booster:
    """Train loop (reference ``python-package/xgboost/training.py``):
    ``num_boost_round`` rounds of ``Booster.update``, each followed by an
    evaluation of ``evals`` into ``evals_result`` ({data: {metric:
    [scores]}}, scores as the 6-digit eval line gives them), printed every
    ``verbose_eval`` rounds. Early stopping and callbacks wait with
    ROADMAP A.5.3."""
    if early_stopping_rounds is not None or callbacks:
        raise NotImplementedError(
            "early stopping and callbacks are not in the PyTorch port yet "
            "(ROADMAP A.5.3)")
    if isinstance(xgb_model, Booster):
        bst = xgb_model
        bst.set_param(params)
    elif xgb_model is not None:
        bst = Booster(params, model_file=xgb_model)
    else:
        bst = Booster(params)
    verbose = bool(verbose_eval) and get_config()["verbosity"] > 0
    period = 1 if verbose_eval is True else max(1, int(verbose_eval or 1))
    history: Dict[str, Dict[str, List[float]]] = collections.OrderedDict()
    start = bst.num_boosted_rounds()
    latest = None
    for i in range(start, start + num_boost_round):
        bst.update(dtrain, i)
        if not evals:
            continue
        for part in bst.eval_set(evals, i).split("\t")[1:]:
            key, val = part.split(":")
            data_name, metric_name = key.split("-", 1)
            history.setdefault(data_name, collections.OrderedDict()) \
                .setdefault(metric_name, []).append(float(val))
        line = f"[{i}]" + "".join(
            f"\t{d}-{m}:{log[-1]:.5f}" for d, ms in history.items()
            for m, log in ms.items())
        latest = line
        if verbose and i % period == 0:
            print(line, flush=True)
            latest = None
    if verbose and latest is not None:
        print(latest, flush=True)
    if evals_result is not None:
        evals_result.update(history)
    return bst
