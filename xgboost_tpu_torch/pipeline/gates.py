"""Drift gates — the promote/reject decision on a candidate model.

A :class:`GateRule` bounds one metric two ways: RELATIVE (the candidate
may regress at most ``max_regression`` against the live baseline's
recorded score — the drift signal) and ABSOLUTE (``min_value`` /
``max_value`` floors that hold even when there is no baseline yet).
Orientation defaults from the metric registry (``Metric.maximize``), so
``auc`` rules read "may drop by at most", ``logloss`` rules "may rise
by at most" without the caller spelling it out.

Scores are computed on the pipeline's FIXED holdout set: candidate and
baseline numbers stay comparable across epochs (the post-promotion
canary window is the complementary signal on FRESH data —
``driver._canary``). A failing rule raises the typed
:class:`~.errors.DriftGateFailed` with both numbers in the payload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .errors import DriftGateFailed


@dataclass
class GateRule:
    """One metric bound. ``max_regression`` is measured in the metric's
    own units, always as "how much WORSE than baseline is tolerated"."""

    metric: str
    max_regression: Optional[float] = None
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    higher_is_better: Optional[bool] = None

    def maximize(self) -> bool:
        if self.higher_is_better is not None:
            return bool(self.higher_is_better)
        from ..metric import get_metric

        return bool(get_metric(self.metric).maximize)

    def check(self, candidate: float, baseline: Optional[float],
              epoch: Optional[int] = None) -> None:
        hi = self.maximize()
        if self.min_value is not None and candidate < self.min_value:
            raise DriftGateFailed(
                f"{self.metric}={candidate:.6g} is below the absolute "
                f"floor {self.min_value:g} (epoch {epoch})",
                metric=self.metric, candidate=candidate, epoch=epoch)
        if self.max_value is not None and candidate > self.max_value:
            raise DriftGateFailed(
                f"{self.metric}={candidate:.6g} is above the absolute "
                f"ceiling {self.max_value:g} (epoch {epoch})",
                metric=self.metric, candidate=candidate, epoch=epoch)
        if self.max_regression is None or baseline is None:
            return
        regression = (baseline - candidate) if hi else (candidate - baseline)
        if regression > self.max_regression:
            direction = "dropped" if hi else "rose"
            raise DriftGateFailed(
                f"{self.metric} {direction} {regression:.6g} vs the live "
                f"baseline ({candidate:.6g} vs {baseline:.6g}; allowed "
                f"{self.max_regression:g}) — candidate rejected, previous "
                f"version keeps serving (epoch {epoch})",
                metric=self.metric, candidate=candidate,
                baseline=baseline, epoch=epoch)


def parse_gate(spec: str) -> GateRule:
    """CLI form: ``metric[:max_regression[:min_value[:max_value]]]`` with
    empty fields skipped — e.g. ``auc:0.01``, ``logloss:0.05::``,
    ``auc::0.7`` (absolute floor only)."""
    parts = spec.split(":")
    num = [float(p) if p != "" else None for p in parts[1:4]]
    num += [None] * (3 - len(num))
    return GateRule(metric=parts[0], max_regression=num[0],
                    min_value=num[1], max_value=num[2])


class DriftGates:
    """An ordered rule set evaluated against one holdout DMatrix."""

    def __init__(self, rules: Sequence[GateRule]) -> None:
        self.rules = list(rules)

    def metrics(self) -> Sequence[str]:
        return [r.metric for r in self.rules]

    def evaluate(self, bst, dm) -> Dict[str, float]:
        """Score ``bst`` on ``dm`` for every gated metric."""
        from ..metric import get_metric

        if not self.rules:
            return {}
        preds = np.asarray(bst.predict(dm))
        return {r.metric: float(get_metric(r.metric)(preds, dm.info))
                for r in self.rules}

    def check(self, candidate: Dict[str, float],
              baseline: Optional[Dict[str, float]],
              epoch: Optional[int] = None) -> None:
        """Raise :class:`DriftGateFailed` on the first violated rule."""
        for r in self.rules:
            r.check(candidate[r.metric],
                    (baseline or {}).get(r.metric), epoch)

    @staticmethod
    def explain(baseline_bst, candidate_bst, dm=None,
                top: int = 5) -> Optional[dict]:
        """Model-diff forensic for a gate decision: attribute the metric
        delta between the live baseline and the candidate to the
        features/trees that moved (``obs.insight.model_diff``). Returns
        None when there is no baseline to diff against. Never raises —
        an explanation must not turn a clean rejection into a crash."""
        if baseline_bst is None or candidate_bst is None:
            return None
        from ..obs.insight import model_diff

        try:
            return model_diff(baseline_bst, candidate_bst, dm=dm, top=top)
        except Exception:           # forensics are best-effort by design
            return None
