"""Typed pipeline errors: every failure the loop survives has its own
type, with the context a handler needs (nothing is signalled through
log strings)."""

from __future__ import annotations

from typing import Any, Dict, Optional


class PipelineError(RuntimeError):
    """Base class for continuous-pipeline failures."""


class PageCorrupt(PipelineError):
    """A page-log record failed CRC/parse validation. ``PageLog.count()``
    treats the first corrupt record as the end of the durable prefix, so
    a torn tail write is re-ingested, never half-read."""


class DriftGateFailed(PipelineError):
    """A candidate model failed a promotion gate: the metric either
    regressed past the rule's ``max_regression`` against the live
    baseline, or missed an absolute floor/ceiling. The previous version
    keeps serving; the decision is recorded in the manifest so replay
    does not re-litigate it."""

    def __init__(self, message: str, *, metric: Optional[str] = None,
                 candidate: Optional[float] = None,
                 baseline: Optional[float] = None,
                 epoch: Optional[int] = None,
                 report: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(message)
        self.metric = metric
        self.candidate = candidate
        self.baseline = baseline
        self.epoch = epoch
        #: the model-diff forensic (``obs.insight.model_diff``):
        #: which features/trees moved between the live baseline and the
        #: rejected candidate — the "why" behind the metric delta
        self.report = report


class PromotionRejected(PipelineError):
    """A gate-passing candidate could not be promoted safely — the
    written artifact failed read-back verification (CRC mismatch,
    unloadable model), i.e. the bytes that WOULD have been served are
    not the bytes that were trained. The previous version keeps
    serving; re-running the epoch regenerates the identical artifact
    (byte-exact replay) and retries the promotion."""

    def __init__(self, message: str, *, version: Optional[int] = None,
                 epoch: Optional[int] = None,
                 path: Optional[str] = None,
                 report: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(message)
        self.version = version
        self.epoch = epoch
        self.path = path
        #: the model-diff forensic when a candidate existed at
        #: rejection time (None when the failure precedes a candidate,
        #: e.g. an unserveable active artifact found during reconcile)
        self.report = report


class CanaryRolledBack(PipelineError):
    """A promoted model regressed in its post-promotion canary window
    and was automatically rolled back. Not raised — recorded on the
    step report (rollback IS the designed recovery, not a failure of
    the pipeline), but typed so callers can pattern-match it."""

    def __init__(self, message: str, *, version: Optional[int] = None,
                 restored_version: Optional[int] = None,
                 metric: Optional[str] = None,
                 candidate: Optional[float] = None,
                 baseline: Optional[float] = None,
                 epoch: Optional[int] = None) -> None:
        super().__init__(message)
        self.version = version
        self.restored_version = restored_version
        self.metric = metric
        self.candidate = candidate
        self.baseline = baseline
        self.epoch = epoch


class KilledByChaos(BaseException):
    """Raised by the chaos harness at an injected kill point. Derives
    from ``BaseException`` — like a real SIGKILL it must NOT be caught
    by any ``except Exception`` recovery path inside the pipeline; only
    the test harness (or the process boundary) sees it."""

    def __init__(self, stage: str, epoch: int,
                 detail: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(f"chaos kill at stage {stage!r}, epoch {epoch}")
        self.stage = stage
        self.epoch = epoch
        self.detail = detail or {}
