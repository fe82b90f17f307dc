"""The continuous train -> serve loop (the port of the JAX package's
``pipeline/``).

Fresh rows enter a durable page log; each page becomes one training
epoch that continues the live boosting lineage on the card; candidates
pass drift gates before they are promoted into a serving registry (a
``serve.Server`` or a ``FleetRouter``), with a canary that rolls back.
Every stage is crash-safe and byte-exact on replay, and the page log's
pages and the manifest are the JAX package's bytes and JSON. ``python
-m xgboost_tpu_torch pipeline --help`` for the CLI.
"""

from .chaos import PipelineFaultPlan
from .driver import Pipeline, PipelineConfig
from .errors import (CanaryRolledBack, DriftGateFailed, KilledByChaos,
                     PageCorrupt, PipelineError, PromotionRejected)
from .gates import DriftGates, GateRule, parse_gate
from .manifest import PromotionManifest
from .pagelog import PageLog

__all__ = [
    "Pipeline", "PipelineConfig", "PageLog", "PromotionManifest",
    "DriftGates", "GateRule", "parse_gate", "PipelineFaultPlan",
    "PipelineError", "PageCorrupt", "DriftGateFailed",
    "PromotionRejected", "CanaryRolledBack", "KilledByChaos",
]
