"""Cross-validation (the JAX package's ``training.py``; reference
``python-package/xgboost/training.py:cv``): folds made by ``mknfold``
from ``np.random.RandomState(seed)`` (plain, stratified, or the
caller's index pairs), each with its own Booster, rounds driven through
``callback.CallbackContainer`` and the folds' eval lines aggregated
into a mean / std history. ``train`` lives in ``core.py`` and is
re-exported here."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .callback import (CallbackContainer, EarlyStopping, EvaluationMonitor,
                       TrainingCallback)
from .core import Booster, train  # noqa: F401  (re-export train)
from .data.dmatrix import DMatrix
from .utils.checkpoint import (CheckpointConfig,  # noqa: F401  (re-export:
                               TrainingSnapshot)  # train(checkpoint=...))


class CVPack:
    """One fold: its train / test DMatrix pair and its Booster."""

    def __init__(self, dtrain: DMatrix, dtest: DMatrix, params) -> None:
        self.dtrain = dtrain
        self.dtest = dtest
        self.watchlist = [(dtrain, "train"), (dtest, "test")]
        self.bst = Booster(params)

    def update(self, iteration: int, fobj) -> None:
        self.bst.update(self.dtrain, iteration, fobj=fobj)

    def eval(self, iteration: int, feval) -> str:
        return self.bst.eval_set(self.watchlist, iteration, feval=feval)


class _PackedBooster:
    """The folds' boosters as one model to the callbacks."""

    def __init__(self, cvfolds: List[CVPack]) -> None:
        self.cvfolds = cvfolds

    def update(self, iteration: int, obj) -> None:
        for fold in self.cvfolds:
            fold.update(iteration, obj)

    def eval_set(self, evals, iteration: int, feval=None) -> List[str]:
        return [f.eval(iteration, feval) for f in self.cvfolds]

    def set_attr(self, **kwargs) -> None:
        for f in self.cvfolds:
            f.bst.set_attr(**kwargs)

    def attr(self, key: str):
        return self.cvfolds[0].bst.attr(key)

    def set_param(self, params, value=None) -> None:
        for f in self.cvfolds:
            f.bst.set_param(params, value)

    def num_boosted_rounds(self) -> int:
        return self.cvfolds[0].bst.num_boosted_rounds()

    @property
    def best_iteration(self) -> int:
        return int(self.attr("best_iteration"))

    @property
    def best_score(self) -> float:
        return float(self.attr("best_score"))


def mknfold(dall: DMatrix, nfold: int, params, seed: int,
            stratified: bool, shuffle: bool,
            folds=None) -> List[CVPack]:
    """The folds (reference ``mknfold``): plain, stratified over the
    labels, or the caller's (train index, test index) pairs; the same
    shuffles from ``np.random.RandomState(seed)`` as the JAX package, so
    the folds hold the same rows."""
    n = dall.num_row()
    rng = np.random.RandomState(seed)
    if folds is not None:
        splits = list(folds)
    elif stratified:
        y = np.asarray(dall.info.labels).reshape(-1)
        order = np.argsort(y, kind="stable")
        if shuffle:
            # shuffled within each label's rows, then dealt round-robin
            for cls in np.unique(y):
                grp = order[y[order] == cls]
                rng.shuffle(grp)
        assign = np.empty(n, dtype=np.int64)
        assign[order] = np.arange(n) % nfold
        splits = [(np.nonzero(assign != k)[0], np.nonzero(assign == k)[0])
                  for k in range(nfold)]
    else:
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        parts = np.array_split(idx, nfold)
        splits = [(np.concatenate(parts[:k] + parts[k + 1:]), parts[k])
                  for k in range(nfold)]
    return [CVPack(dall.slice(tr), dall.slice(te), params)
            for tr, te in splits]


def _aggregate(results: List[str]) -> Dict[str, tuple]:
    """The folds' eval lines -> {data-metric: (mean, std)}, in order."""
    collected: Dict[str, List[float]] = {}
    for msg in results:
        for part in msg.split("\t")[1:]:
            key, val = part.rsplit(":", 1)
            collected.setdefault(key, []).append(float(val))
    return {k: (float(np.mean(v)), float(np.std(v)))
            for k, v in collected.items()}


def cv(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
       *, nfold: int = 3, stratified: bool = False, folds=None,
       metrics: Sequence[str] = (), obj: Optional[Callable] = None,
       custom_metric: Optional[Callable] = None,
       maximize: Optional[bool] = None,
       early_stopping_rounds: Optional[int] = None,
       as_pandas: bool = True, verbose_eval: Union[bool, int, None] = None,
       show_stdv: bool = True, seed: int = 0, shuffle: bool = True,
       callbacks: Optional[Sequence[TrainingCallback]] = None):
    """K-fold cross-validation -> the per-round history
    ``{"<data>-<metric>-mean": [...], "...-std": [...]}``, a DataFrame
    when pandas is present and ``as_pandas``; early stopping on the last
    metric of the test folds' means cuts it at the best round."""
    params = dict(params)
    if metrics:
        params["eval_metric"] = list(metrics)
    booster = _PackedBooster(mknfold(dtrain, nfold, params, seed,
                                     stratified, shuffle, folds))
    callbacks = list(callbacks) if callbacks else []
    if verbose_eval:
        period = 1 if verbose_eval is True else int(verbose_eval)
        callbacks.append(EvaluationMonitor(period=period))
    if early_stopping_rounds is not None:
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize))
    container = CallbackContainer(callbacks, metric=custom_metric)

    history: Dict[str, List[float]] = {}
    container.before_training(booster)
    for i in range(num_boost_round):
        if container.before_iteration(booster, i):
            break
        booster.update(i, obj)
        agg = _aggregate(booster.eval_set(None, i, custom_metric))
        for key, (mean, std) in agg.items():
            history.setdefault(f"{key}-mean", []).append(mean)
            history.setdefault(f"{key}-std", []).append(std)
            data_name, metric_name = key.split("-", 1)
            container.history.setdefault(data_name, {}).setdefault(
                metric_name, []).append(mean)
        if any(cb.after_iteration(booster, i, container.history)
               for cb in container.callbacks):
            best = booster.best_iteration
            history = {k: v[: best + 1] for k, v in history.items()}
            break
    container.after_training(booster)
    for fold in booster.cvfolds:  # one timing table a fold, verbosity >= 3
        fold.bst._monitor.maybe_print()
    if as_pandas:
        try:
            import pandas as pd

            return pd.DataFrame.from_dict(history)
        except ImportError:
            pass
    return history
