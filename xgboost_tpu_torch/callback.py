"""Training callbacks (the JAX package's ``callback.py``; reference
``python-package/xgboost/callback.py``).

``train`` drives a :class:`CallbackContainer`: before each round every
callback's ``before_iteration`` may stop training; after it the eval
sets are scored into the container's ``history`` (a ``TrainingLog``,
{data: {metric: [scores]}}, each score parsed from the 6-digit eval
line, which a training snapshot carries across a resume) and every
callback's ``after_iteration`` may stop it. The stock callbacks:
:class:`EvaluationMonitor` (prints the last scores), :class:`EarlyStopping`
(patience on the last metric of the last eval set, ``best_iteration`` /
``best_score`` / ``rounds_since_improvement`` kept as booster attributes,
so that a run resumed from a saved model stops where the straight run
stops; ``save_best`` slices the model to the best round),
:class:`LearningRateScheduler`, :class:`AbortAtRound` and
:class:`TrainingCheckPoint`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Union

from .obs.training_log import TrainingLog

EvalsLog = Dict[str, Dict[str, List[float]]]


class TrainingCallback:
    def before_training(self, model):
        return model

    def after_training(self, model):
        return model

    def before_iteration(self, model, epoch: int, evals_log: EvalsLog) -> bool:
        return False

    def after_iteration(self, model, epoch: int, evals_log: EvalsLog) -> bool:
        """Return True to stop training."""
        return False


def _parse_eval_str(msg: str):
    out = []
    for part in msg.split("\t")[1:]:
        key, val = part.split(":")
        data_name, metric_name = key.split("-", 1)
        out.append((data_name, metric_name, float(val)))
    return out


class CallbackContainer:
    """``metric``: a custom metric, ``metric(margin, dmatrix)`` -> (name,
    value) or a list of them, scored beside the booster's metrics."""

    def __init__(self, callbacks: Sequence[TrainingCallback],
                 metric: Optional[Callable] = None) -> None:
        self.callbacks = list(callbacks)
        self.metric = metric
        # the booster's TrainingLog: a training snapshot carries it
        self.history: EvalsLog = TrainingLog()

    def before_training(self, model):
        for cb in self.callbacks:
            model = cb.before_training(model)
        return model

    def after_training(self, model):
        for cb in self.callbacks:
            model = cb.after_training(model)
        return model

    def before_iteration(self, model, epoch: int) -> bool:
        return any(cb.before_iteration(model, epoch, self.history)
                   for cb in self.callbacks)

    def after_iteration(self, model, epoch: int, evals) -> bool:
        if evals:
            for data_name, metric_name, score in _parse_eval_str(
                    model.eval_set(evals, epoch, feval=self.metric)):
                self.history.log_eval(data_name, metric_name, score)
        return any(cb.after_iteration(model, epoch, self.history)
                   for cb in self.callbacks)


class EvaluationMonitor(TrainingCallback):
    """Print the eval line every ``period`` rounds, and the last one."""

    def __init__(self, rank: int = 0, period: int = 1) -> None:
        self.rank = rank
        self.period = max(1, period)
        self._latest: Optional[str] = None

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        msg = f"[{epoch}]"
        for data, metrics in evals_log.items():
            for name, log in metrics.items():
                msg += f"\t{data}-{name}:{log[-1]:.5f}"
        if (epoch % self.period) == 0:
            print(msg, flush=True)
            self._latest = None
        else:
            self._latest = msg
        return False

    def after_training(self, model):
        if self._latest is not None:
            print(self._latest, flush=True)
        return model


# metrics where larger is better (reference callback.py maximize table)
_MAXIMIZE_METRICS = ("auc", "aucpr", "pre", "map", "ndcg",
                     "interval-regression-accuracy")


class EarlyStopping(TrainingCallback):
    def __init__(self, rounds: int, metric_name: Optional[str] = None,
                 data_name: Optional[str] = None,
                 maximize: Optional[bool] = None, save_best: bool = False,
                 min_delta: float = 0.0) -> None:
        self.rounds = rounds
        self.metric_name = metric_name
        self.data_name = data_name
        self.maximize = maximize
        self.save_best = save_best
        self.min_delta = min_delta
        self.best_scores: List[float] = []
        self.current_rounds = 0

    def before_training(self, model):
        self.starting_round = model.num_boosted_rounds()
        if self.starting_round > 0 and not self.best_scores:
            # a continued run picks the patience window back up from the
            # booster's attributes, so that it stops where the straight
            # run would have
            bs = model.attr("best_score")
            if bs is not None:
                self.best_scores = [float(bs)]
                since = model.attr("rounds_since_improvement")
                self.current_rounds = int(since) if since is not None else 0
        return model

    def _is_better(self, new: float, best: float) -> bool:
        if self.maximize:
            return new - self.min_delta > best
        return new + self.min_delta < best

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            raise ValueError("Must have at least 1 validation dataset for "
                             "early stopping.")
        data_name = self.data_name or list(evals_log.keys())[-1]
        metric_name = self.metric_name or list(evals_log[data_name].keys())[-1]
        score = evals_log[data_name][metric_name][-1]
        if self.maximize is None:
            self.maximize = any(metric_name.startswith(m)
                                for m in _MAXIMIZE_METRICS)
        if not self.best_scores or self._is_better(score,
                                                   self.best_scores[-1]):
            self.best_scores.append(score)
            model.set_attr(best_score=str(score), best_iteration=str(epoch))
            self.current_rounds = 0
        else:
            self.current_rounds += 1
        model.set_attr(rounds_since_improvement=str(self.current_rounds))
        return self.current_rounds >= self.rounds

    def after_training(self, model):
        if self.save_best and model.attr("best_iteration") is not None:
            best = int(model.attr("best_iteration"))
            model = model[: best + 1]
        return model


class LearningRateScheduler(TrainingCallback):
    """Set ``learning_rate`` before each round: ``learning_rates(epoch)``,
    or the epoch's entry of a sequence."""

    def __init__(self, learning_rates: Union[Callable[[int], float],
                                             Sequence[float]]) -> None:
        if callable(learning_rates):
            self.fn = learning_rates
        else:
            rates = list(learning_rates)
            self.fn = lambda epoch: rates[epoch]

    def before_iteration(self, model, epoch, evals_log) -> bool:
        model.set_param("learning_rate", self.fn(epoch))
        return False


class AbortAtRound(TrainingCallback):
    """Raise ``exc`` (by default a RuntimeError) just before boosting
    round ``round_``: a fixed crash point for tests of resumed runs."""

    def __init__(self, round_: int, exc: Union[BaseException,
                                               Callable[[], BaseException],
                                               None] = None) -> None:
        self.round_ = int(round_)
        self._exc = exc

    def before_iteration(self, model, epoch: int, evals_log) -> bool:
        if epoch >= self.round_:
            exc = self._exc() if callable(self._exc) else self._exc
            raise exc if exc is not None else RuntimeError(
                f"AbortAtRound: aborted before round {epoch}")
        return False


class TrainingCheckPoint(TrainingCallback):
    """The model saved every ``interval`` rounds as
    ``<directory>/<name>_<round>.json`` (or ``.pkl``), each file written
    whole under a temporary name and renamed; ``keep=N`` deletes all but
    the newest N."""

    def __init__(self, directory: str, name: str = "model",
                 as_pickle: bool = False, interval: int = 100,
                 keep: Optional[int] = None) -> None:
        self.dir = directory
        self.name = name
        self.as_pickle = as_pickle
        self.interval = max(1, interval)
        self.keep = keep
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1 or None, got {keep}")
        self._epoch = 0
        self._written: List[str] = []

    def _write(self, model, path: str) -> None:
        if self.as_pickle:
            import pickle

            raw = pickle.dumps(model)
        else:
            raw = bytes(model.save_raw("json"))
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(raw)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if self._epoch == self.interval:
            path = os.path.join(
                self.dir,
                f"{self.name}_{epoch}." + ("pkl" if self.as_pickle
                                           else "json"))
            self._epoch = 0
            self._write(model, path)
            self._written.append(path)
            while self.keep is not None and len(self._written) > self.keep:
                stale = self._written.pop(0)
                try:
                    os.remove(stale)
                except OSError:
                    pass
        self._epoch += 1
        return False
