"""In-process inference serving on the card: a multi-model registry, a
micro-batcher and a bucketed dispatch pipeline over the packed walk."""

from .batcher import MicroBatcher, PredictRequest
from .buckets import BucketLadder
from .errors import (DeadlineExceeded, ModelLoadError, ServeError,
                     ServerClosed, ServerOverloaded, UnknownModel)
from .metrics import ServeMetrics
from .packed import PackedForest, PackError
from .registry import ModelRegistry, ServedModel
from .server import ServeConfig, Server

__all__ = ["BucketLadder", "DeadlineExceeded", "MicroBatcher",
           "ModelLoadError", "ModelRegistry", "PackError", "PackedForest",
           "PredictRequest", "ServeConfig", "ServeError", "ServeMetrics",
           "ServedModel", "Server", "ServerClosed", "ServerOverloaded",
           "UnknownModel"]
