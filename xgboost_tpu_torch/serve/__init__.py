"""Inference serving on the card: a multi-model registry, a micro-batcher
and a bucketed dispatch pipeline over the packed walk; device TreeSHAP
(``Server.contribs``); fleet mode (``FleetRouter``: N replicas behind
consistent-hash placement); the in-process ``ServeClient``; and the
jsonl and HTTP front ends (``python -m xgboost_tpu_torch serve ...``,
``serve/frontend.py``)."""

from .batcher import MicroBatcher, PredictRequest
from .buckets import BucketLadder, RecompileCounter
from .client import ServeClient
from .errors import (DeadlineExceeded, ModelLoadError, ServeError,
                     ServerClosed, ServerOverloaded, UnknownModel)
from .fleet import FleetConfig, FleetRouter
from .metrics import LatencyHistogram, ServeMetrics
from .packed import PackedForest, PackError
from .registry import ModelRegistry, ServedModel
from .server import ServeConfig, Server

__all__ = ["BucketLadder", "DeadlineExceeded", "FleetConfig", "FleetRouter",
           "LatencyHistogram", "MicroBatcher", "ModelLoadError",
           "ModelRegistry", "PackError", "PackedForest", "PredictRequest",
           "RecompileCounter", "ServeClient", "ServeConfig", "ServeError",
           "ServeMetrics", "ServedModel", "Server", "ServerClosed",
           "ServerOverloaded", "UnknownModel"]
