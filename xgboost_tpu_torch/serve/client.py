"""In-process serving client.

The port of the JAX package's ``serve/client.py``: the thin typed handle
tests and embedding applications use to talk to a
:class:`~.server.Server` (or a :class:`~.fleet.FleetRouter`) without
going through a wire protocol: it pins a default model/output/timeout and
exposes sync (``predict``), async (``submit`` -> Future) and batch
(``predict_many``) calls. Concurrent submits from any number of
threads coalesce in the server's micro-batcher — that is the whole
point of submitting before waiting.

Load-shed handling: a :class:`ServerOverloaded` raised at admission is
a TRANSIENT condition (the queue was momentarily full), so the client
retries it under a :class:`~..parallel.resilience.RetryPolicy` —
bounded attempts, exponential backoff with deterministic (seeded)
jitter, and the request's absolute deadline
(computed once at the FIRST attempt) honored across every retry sleep,
so a retried request never waits past the deadline the caller asked
for.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import Future
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..parallel.resilience import RetryPolicy
from .errors import DeadlineExceeded, ServerOverloaded


class ServeClient:
    def __init__(self, server, model: Optional[str] = None, *,
                 output: str = "value",
                 timeout_ms: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 retry_seed: int = 0) -> None:
        self.server = server
        self.model = model
        self.output = output
        self.timeout_ms = timeout_ms
        # retry=None keeps the historical fail-fast behavior; tests that
        # assert on shed counts construct clients without a policy
        self.retry = retry
        self._rng = random.Random(retry_seed)

    def _kw(self, output: Optional[str], timeout_ms) -> Dict[str, object]:
        kw: Dict[str, object] = {"output": output or self.output}
        if timeout_ms is not None:
            kw["timeout_ms"] = timeout_ms
        elif self.timeout_ms is not None:
            kw["timeout_ms"] = self.timeout_ms
        return kw

    def _deadline(self, kw: Dict[str, object]) -> Optional[float]:
        t_ms = kw.get("timeout_ms")
        return (time.perf_counter() + float(t_ms) / 1e3
                if t_ms is not None else None)

    def _with_retry(self, call, kw: Dict[str, object]):
        """Run ``call()`` retrying ServerOverloaded per the policy. The
        deadline is absolute — fixed before attempt 0 — so backoff sleeps
        spend the caller's budget, never extend it."""
        if self.retry is None:
            return call()
        deadline = self._deadline(kw)
        attempt = 0
        while True:
            try:
                return call()
            except ServerOverloaded:
                if attempt >= self.retry.max_retries:
                    raise
                d = self.retry.delay(attempt, self._rng)
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= d:
                        raise DeadlineExceeded(
                            f"deadline exhausted after {attempt + 1} "
                            "shed attempt(s); server still overloaded"
                        ) from None
                time.sleep(d)
                attempt += 1

    def submit(self, X, *, model: Optional[str] = None,
               output: Optional[str] = None,
               timeout_ms: Optional[float] = None) -> Future:
        kw = self._kw(output, timeout_ms)
        return self._with_retry(
            lambda: self.server.submit(X, model or self.model, **kw), kw)

    def predict(self, X, *, model: Optional[str] = None,
                output: Optional[str] = None,
                timeout_ms: Optional[float] = None) -> np.ndarray:
        return self.submit(X, model=model, output=output,
                           timeout_ms=timeout_ms).result()

    def contribs(self, X, *, model: Optional[str] = None,
                 timeout_ms: Optional[float] = None) -> np.ndarray:
        """Per-feature SHAP attributions (device TreeSHAP) — the typed
        twin of ``POST /v1/model/<name>/contribs``."""
        kw = self._kw(None, timeout_ms)
        kw.pop("output", None)
        return self._with_retry(
            lambda: self.server.contribs(X, model or self.model, **kw), kw)

    def predict_many(self, batches: Iterable, *,
                     model: Optional[str] = None,
                     output: Optional[str] = None,
                     timeout_ms: Optional[float] = None) -> List[np.ndarray]:
        """Submit every batch BEFORE waiting on any result, so they can
        coalesce into shared device dispatches."""
        futures = [self.submit(X, model=model, output=output,
                               timeout_ms=timeout_ms) for X in batches]
        return [f.result() for f in futures]

    def metrics(self) -> Dict[str, object]:
        return self.server.metrics_snapshot()
