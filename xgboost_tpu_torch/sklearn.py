"""scikit-learn estimator wrappers.

The port of the JAX package's ``sklearn.py`` (reference
``python-package/xgboost/sklearn.py``: ``XGBModel`` and ``XGBRegressor``
/ ``XGBClassifier`` / ``XGBRanker`` / ``XGBRF*``): estimator parameters
map one to one onto Booster parameters (``device`` too: the card unless
``device="cpu"``), ``fit`` drives ``train`` with eval sets, early
stopping and base margins, and predictions come from
``Booster.predict`` (the walk kernel K1 on the card). scikit-learn is
optional: without it the wrappers are plain classes that fit and
predict all the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .callback import TrainingCallback
from .core import Booster, train
from .data.dmatrix import DMatrix

try:  # soft dependency, like the reference's compat layer
    from sklearn.base import BaseEstimator as _SkBase

    _SKLEARN = True
except ImportError:
    _SkBase = object
    _SKLEARN = False


class XGBModel(_SkBase):
    """Base estimator (reference ``sklearn.py:XGBModel``)."""

    def __init__(self, *, max_depth: Optional[int] = None,
                 max_leaves: Optional[int] = None,
                 max_bin: Optional[int] = None,
                 grow_policy: Optional[str] = None,
                 learning_rate: Optional[float] = None,
                 n_estimators: Optional[int] = None,
                 verbosity: Optional[int] = None,
                 objective: Optional[Union[str, Callable]] = None,
                 booster: Optional[str] = None,
                 tree_method: Optional[str] = None,
                 n_jobs: Optional[int] = None,
                 gamma: Optional[float] = None,
                 min_child_weight: Optional[float] = None,
                 max_delta_step: Optional[float] = None,
                 subsample: Optional[float] = None,
                 sampling_method: Optional[str] = None,
                 colsample_bytree: Optional[float] = None,
                 colsample_bylevel: Optional[float] = None,
                 colsample_bynode: Optional[float] = None,
                 reg_alpha: Optional[float] = None,
                 reg_lambda: Optional[float] = None,
                 scale_pos_weight: Optional[float] = None,
                 base_score: Optional[float] = None,
                 random_state: Optional[int] = None,
                 missing: float = np.nan,
                 num_parallel_tree: Optional[int] = None,
                 monotone_constraints: Optional[Union[str, Dict]] = None,
                 interaction_constraints: Optional[Union[str, List]] = None,
                 importance_type: Optional[str] = None,
                 device: Optional[str] = None,
                 validate_parameters: Optional[bool] = None,
                 enable_categorical: bool = False,
                 max_cat_to_onehot: Optional[int] = None,
                 max_cat_threshold: Optional[int] = None,
                 eval_metric: Optional[Union[str, List, Callable]] = None,
                 early_stopping_rounds: Optional[int] = None,
                 callbacks: Optional[List[TrainingCallback]] = None,
                 **kwargs: Any) -> None:
        self.max_depth = max_depth
        self.max_leaves = max_leaves
        self.max_bin = max_bin
        self.grow_policy = grow_policy
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.verbosity = verbosity
        self.objective = objective
        self.booster = booster
        self.tree_method = tree_method
        self.n_jobs = n_jobs
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.max_delta_step = max_delta_step
        self.subsample = subsample
        self.sampling_method = sampling_method
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.colsample_bynode = colsample_bynode
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.base_score = base_score
        self.random_state = random_state
        self.missing = missing
        self.num_parallel_tree = num_parallel_tree
        self.monotone_constraints = monotone_constraints
        self.interaction_constraints = interaction_constraints
        self.importance_type = importance_type
        self.device = device
        self.validate_parameters = validate_parameters
        self.enable_categorical = enable_categorical
        self.max_cat_to_onehot = max_cat_to_onehot
        self.max_cat_threshold = max_cat_threshold
        self.eval_metric = eval_metric
        self.early_stopping_rounds = early_stopping_rounds
        self.callbacks = callbacks
        self.kwargs = kwargs
        self._Booster: Optional[Booster] = None

    # -- param plumbing -------------------------------------------------------
    _NON_BOOSTER = {"n_estimators", "missing", "enable_categorical",
                    "eval_metric", "early_stopping_rounds", "callbacks",
                    "kwargs", "importance_type"}

    def get_xgb_params(self) -> Dict[str, Any]:
        params = {}
        for k, v in self.__dict__.items():
            # trailing-underscore attributes are sklearn fitted state
            # (classes_, n_classes_, evals_result_), not booster params
            if k.startswith("_") or k.endswith("_") \
                    or k in self._NON_BOOSTER or v is None:
                continue
            if k == "objective" and callable(v):
                continue
            params[k] = v
        params.update(self.kwargs or {})
        return params

    def get_num_boosting_rounds(self) -> int:
        return self.n_estimators if self.n_estimators is not None else 100

    # sklearn's introspection rejects **kwargs signatures, so implement the
    # estimator-param protocol directly (the reference overrides it too)
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_") and k != "kwargs"}
        params.update(self.kwargs or {})
        return params

    def set_params(self, **params: Any) -> "XGBModel":
        known = set(self.__dict__)
        for k, v in params.items():
            if k in known:
                setattr(self, k, v)
            else:
                self.kwargs = dict(self.kwargs or {})
                self.kwargs[k] = v
        return self

    # -- fit ------------------------------------------------------------------
    def _make_dmatrix(self, X, y=None, sample_weight=None, base_margin=None,
                      group=None, qid=None) -> DMatrix:
        return DMatrix(X, label=y, weight=sample_weight,
                       base_margin=base_margin, missing=self.missing,
                       group=group, qid=qid,
                       enable_categorical=self.enable_categorical)

    def _eval_dmatrices(self, eval_set, sample_weight_eval_set,
                        base_margin_eval_set, **kw):
        evals = []
        if eval_set:
            for i, (Xe, ye) in enumerate(eval_set):
                w = (sample_weight_eval_set[i]
                     if sample_weight_eval_set else None)
                bm = (base_margin_eval_set[i]
                      if base_margin_eval_set else None)
                evals.append((self._make_dmatrix(Xe, ye, w, bm),
                              f"validation_{i}"))
        return evals

    def fit(self, X, y, *, sample_weight=None, base_margin=None,
            eval_set: Optional[Sequence[Tuple]] = None,
            sample_weight_eval_set=None, base_margin_eval_set=None,
            verbose: Union[bool, int] = True,
            xgb_model: Optional[Union[str, Booster]] = None,
            feature_weights=None) -> "XGBModel":
        dtrain = self._make_dmatrix(X, y, sample_weight, base_margin)
        evals = self._eval_dmatrices(eval_set, sample_weight_eval_set,
                                     base_margin_eval_set)
        params = self.get_xgb_params()
        if callable(self.objective):
            obj = _sklearn_objective(self.objective)
            params.pop("objective", None)
        else:
            obj = None
        metric, feval = self._metric_args()
        if metric is not None:
            params["eval_metric"] = metric
        self.evals_result_: Dict = {}
        self._Booster = train(
            params, dtrain, self.get_num_boosting_rounds(), evals=evals,
            obj=obj, custom_metric=feval,
            early_stopping_rounds=self.early_stopping_rounds,
            evals_result=self.evals_result_, verbose_eval=verbose,
            xgb_model=xgb_model,
            callbacks=list(self.callbacks) if self.callbacks else None)
        return self

    def _metric_args(self):
        em = self.eval_metric
        if em is None:
            return None, None
        if callable(em):
            return None, _sklearn_metric(em)
        return em, None

    # -- predict --------------------------------------------------------------
    def get_booster(self) -> Booster:
        if self._Booster is None:
            raise ValueError("need to call fit or load_model first")
        return self._Booster

    def _predict(self, X, output_margin=False, base_margin=None,
                 iteration_range=None):
        dm = DMatrix(X, base_margin=base_margin, missing=self.missing,
                     enable_categorical=self.enable_categorical)
        if iteration_range is None and self.early_stopping_rounds is not None \
                and self.get_booster().attr("best_iteration") is not None:
            iteration_range = (0, self.get_booster().best_iteration + 1)
        return self.get_booster().predict(
            dm, output_margin=output_margin, iteration_range=iteration_range)

    def predict(self, X, *, output_margin=False, base_margin=None,
                iteration_range=None):
        return self._predict(X, output_margin, base_margin, iteration_range)

    def apply(self, X, iteration_range=None):
        dm = DMatrix(X, missing=self.missing,
                     enable_categorical=self.enable_categorical)
        return self.get_booster().predict(dm, pred_leaf=True,
                                          iteration_range=iteration_range)

    # -- introspection --------------------------------------------------------
    @property
    def feature_importances_(self) -> np.ndarray:
        b = self.get_booster()
        itype = self.importance_type or (
            "weight" if (self.booster == "gblinear") else "gain")
        scores = b.get_score(importance_type=itype)
        n = b.num_features() or (max(
            int(k[1:]) for k in scores) + 1 if scores else 0)
        out = np.zeros(n, dtype=np.float32)
        names = b.feature_names or [f"f{i}" for i in range(n)]
        for i, name in enumerate(names):
            out[i] = scores.get(name, 0.0)
        total = out.sum()
        return out / total if total > 0 else out

    @property
    def best_iteration(self) -> int:
        return self.get_booster().best_iteration

    @property
    def best_score(self) -> float:
        return self.get_booster().best_score

    def evals_result(self) -> Dict:
        return self.evals_result_

    @property
    def n_features_in_(self) -> int:
        return self.get_booster().num_features()

    @property
    def feature_names_in_(self) -> np.ndarray:
        names = self.get_booster().feature_names
        if names is None:
            raise AttributeError(
                "`feature_names_in_` is defined only when fitted on a frame "
                "with column names")
        return np.asarray(names, dtype=object)

    def __sklearn_is_fitted__(self) -> bool:
        return getattr(self, "_Booster", None) is not None

    @property
    def coef_(self) -> np.ndarray:
        """Linear-booster coefficients (reference sklearn.py ``coef_``:
        defined for ``booster='gblinear'`` only)."""
        if self.booster != "gblinear":
            raise AttributeError(
                f"coef_ is not defined for booster={self.booster!r}")
        W = self.get_booster().gbm.W.cpu().numpy()
        return W[:, 0] if W.shape[1] == 1 else W.T

    @property
    def intercept_(self) -> np.ndarray:
        if self.booster != "gblinear":
            raise AttributeError(
                f"intercept_ is not defined for booster={self.booster!r}")
        return self.get_booster().gbm.bias.cpu().numpy()

    def save_model(self, fname: str) -> None:
        self.get_booster().save_model(fname)

    def load_model(self, fname: str) -> None:
        self._Booster = Booster({"device": self.device} if self.device
                                else None, model_file=fname)

    def __sklearn_tags__(self):  # the sklearn >= 1.6 protocol
        tags = super().__sklearn_tags__()
        tags.non_deterministic = False
        return tags


def _sklearn_objective(func: Callable):
    """Adapt sklearn-style obj(y_true, y_pred) -> (grad, hess)."""

    def obj(preds: np.ndarray, dmatrix: DMatrix):
        return func(dmatrix.get_label(), preds)

    return obj


def _sklearn_metric(func: Callable):
    def feval(preds: np.ndarray, dmatrix: DMatrix):
        return func.__name__, float(func(dmatrix.get_label(), preds))

    return feval


class XGBRegressor(XGBModel):
    def __init__(self, *, objective: str = "reg:squarederror",
                 **kwargs: Any) -> None:
        super().__init__(objective=objective, **kwargs)


class XGBClassifier(XGBModel):
    def __init__(self, *, objective: str = "binary:logistic",
                 **kwargs: Any) -> None:
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, **kwargs: Any) -> "XGBClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.n_classes_ = len(self.classes_)
        yenc = np.searchsorted(self.classes_, y).astype(np.float32)
        if self.n_classes_ > 2:
            if not (isinstance(self.objective, str)
                    and self.objective.startswith("multi:")):
                self.objective = "multi:softprob"
            self.kwargs = dict(self.kwargs or {})
            self.kwargs["num_class"] = self.n_classes_
        super().fit(X, yenc, **kwargs)
        return self

    def predict_proba(self, X, *, base_margin=None, iteration_range=None):
        raw = self._predict(X, False, base_margin, iteration_range)
        if raw.ndim == 1:  # binary: p(positive)
            return np.stack([1.0 - raw, raw], axis=1)
        return raw

    def predict(self, X, *, output_margin=False, base_margin=None,
                iteration_range=None):
        raw = self._predict(X, output_margin, base_margin, iteration_range)
        if output_margin:
            return raw
        if raw.ndim == 1:
            idx = (raw > 0.5).astype(np.int64)
        else:
            idx = raw.argmax(axis=1)
        return self.classes_[idx]

    def score(self, X, y, sample_weight=None) -> float:
        preds = self.predict(X)
        return float(np.average(preds == np.asarray(y), weights=sample_weight))


class XGBRanker(XGBModel):
    def __init__(self, *, objective: str = "rank:ndcg", **kwargs: Any) -> None:
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, *, group=None, qid=None, sample_weight=None,
            base_margin=None, eval_set=None, eval_group=None, eval_qid=None,
            sample_weight_eval_set=None, verbose=False,
            xgb_model=None) -> "XGBRanker":
        if group is None and qid is None:
            raise ValueError("XGBRanker.fit requires group= or qid=")
        dtrain = self._make_dmatrix(X, y, sample_weight, base_margin,
                                    group=group, qid=qid)
        evals = []
        if eval_set:
            for i, (Xe, ye) in enumerate(eval_set):
                g = eval_group[i] if eval_group else None
                q = eval_qid[i] if eval_qid else None
                evals.append((self._make_dmatrix(Xe, ye, group=g, qid=q),
                              f"validation_{i}"))
        params = self.get_xgb_params()
        metric, feval = self._metric_args()
        if metric is not None:
            params["eval_metric"] = metric
        self.evals_result_ = {}
        self._Booster = train(
            params, dtrain, self.get_num_boosting_rounds(), evals=evals,
            custom_metric=feval,
            early_stopping_rounds=self.early_stopping_rounds,
            evals_result=self.evals_result_, verbose_eval=verbose,
            xgb_model=xgb_model)
        return self


class XGBRFRegressor(XGBRegressor):
    """Random-forest-style (one boosting round of many parallel trees)."""

    def __init__(self, *, learning_rate: float = 1.0, subsample: float = 0.8,
                 colsample_bynode: float = 0.8, reg_lambda: float = 1e-5,
                 num_parallel_tree: int = 100, **kwargs: Any) -> None:
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda,
                         num_parallel_tree=num_parallel_tree, **kwargs)

    def get_num_boosting_rounds(self) -> int:
        return 1


class XGBRFClassifier(XGBClassifier):
    def __init__(self, *, learning_rate: float = 1.0, subsample: float = 0.8,
                 colsample_bynode: float = 0.8, reg_lambda: float = 1e-5,
                 num_parallel_tree: int = 100, **kwargs: Any) -> None:
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda,
                         num_parallel_tree=num_parallel_tree, **kwargs)

    def get_num_boosting_rounds(self) -> int:
        return 1
