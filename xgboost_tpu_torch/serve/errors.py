"""Typed serving errors.

The robustness contract of the serving subsystem is that overload and
timeout conditions surface as TYPED exceptions a frontend can map to
protocol errors (HTTP 429/504, a jsonl ``{"error": ...}`` record), never
as an OOM or a silently dropped request. Reference analogue: the
reference CLI/C API signal failure through ``XGBoostError`` codes; a
serving layer needs the finer partition below.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of every serving-layer failure."""


class ServerOverloaded(ServeError):
    """Request shed at admission: the bounded request queue is full.

    Raised synchronously by ``submit`` (load-shedding happens before the
    request consumes queue memory), so callers can retry with backoff.
    In-flight and already-queued requests are unaffected.
    """


class DeadlineExceeded(ServeError):
    """The request's deadline elapsed before its batch was dispatched.

    Delivered through the request's future. Expired requests are dropped
    at batch-formation time and never occupy device compute.
    """


class ServerClosed(ServeError):
    """The server is shut down (or draining) and accepts no new work."""


class UnknownModel(ServeError, KeyError):
    """No served model under the requested name."""


class ModelLoadError(ServeError):
    """The model source could not be loaded (corrupted/truncated bytes, a
    file that parses as neither native nor reference xgboost, a booster
    that fails to configure).

    Raised by ``ModelRegistry.load``/``prepare`` BEFORE anything is
    published: a failed ``load`` leaves the registry unchanged and a
    failed hot-``swap`` keeps the previous version live — in-flight and
    subsequent requests keep serving the old model.
    """
