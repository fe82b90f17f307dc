"""The training log: the eval history of a run, kept across resumes.

The port of the JAX package's ``obs/insight.py TrainingLog`` (the rest
of that module, the model report and the round telemetry, is ROADMAP
A.10): an ``evals_result``-shaped mapping {data: {metric: [scores]}}
plus ``records``, the JAX package's round telemetry, which a snapshot
carries through (the port writes none yet). The callback container's
``history`` is a :class:`TrainingLog`, so ``EarlyStopping`` and
``evals_result`` read it as a dict, and a training snapshot carries it
(:meth:`to_obj`, ``utils/checkpoint.py``) in the JAX package's layout.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional


class TrainingLog(collections.OrderedDict):
    """{data: {metric: [scores]}} and ``records`` (module docstring)."""

    def __init__(self, records: Optional[List[Dict[str, Any]]] = None
                 ) -> None:
        super().__init__()
        self.records: List[Dict[str, Any]] = list(records or [])

    def log_eval(self, data_name: str, metric_name: str,
                 value: float) -> None:
        """Append one eval score (the ``evals_result`` write path)."""
        self.setdefault(data_name, collections.OrderedDict()).setdefault(
            metric_name, []).append(float(value))

    def to_obj(self) -> Dict[str, Any]:
        return {"history": {d: {m: list(v) for m, v in metrics.items()}
                            for d, metrics in self.items()},
                "records": [dict(r) for r in self.records]}

    @classmethod
    def from_obj(cls, obj: Optional[Dict[str, Any]]) -> "TrainingLog":
        log = cls(records=(obj or {}).get("records"))
        for d, metrics in ((obj or {}).get("history") or {}).items():
            for m, vals in metrics.items():
                log.setdefault(d, collections.OrderedDict())[m] = \
                    [float(v) for v in vals]
        return log
