"""Micro-batching request queue: coalesce, bound, expire, drain.

Single-request dispatch leaves the card idle between tiny walks; the
micro-batcher coalesces concurrent predict requests into device batches
under a ``max_batch`` / ``max_delay`` policy (the standard serving
trade: the first request in an empty queue waits at most ``max_delay``
for company; a full batch dispatches immediately). One worker thread
owns batch formation and dispatch — the device serializes executions
anyway, and a single consumer makes FIFO fairness and drain semantics
trivial to reason about.

Robustness contract (tests/test_torch_serve.py):

- **Backpressure**: admission is bounded by queued ROWS (the unit that
  costs memory); past the cap ``submit`` raises ``ServerOverloaded``
  synchronously instead of growing the queue toward OOM.
- **Deadlines**: an expired request is failed with ``DeadlineExceeded``
  at batch-formation time and never reaches the device.
- **Drain**: ``close(drain=True)`` stops intake, serves everything
  already queued, then stops the worker — no request is ever dropped
  without its future resolving.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np

from .errors import DeadlineExceeded, ServerClosed, ServerOverloaded


class PredictRequest:
    __slots__ = ("X", "model", "output", "future", "t_submit", "deadline")

    def __init__(self, X: np.ndarray, model: str, output: str,
                 deadline: Optional[float]) -> None:
        self.X = X
        self.model = model          # resolved model NAME (routing key)
        self.output = output        # "value" | "margin"
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline    # perf_counter timestamp or None

    @property
    def rows(self) -> int:
        return self.X.shape[0]


class MicroBatcher:
    def __init__(self, *, max_batch: int, max_delay_s: float,
                 max_queue_rows: int,
                 dispatch: Callable[[str, List[PredictRequest]], None],
                 on_expire: Optional[Callable[[int], None]] = None) -> None:
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue_rows = int(max_queue_rows)
        self._dispatch = dispatch
        self._on_expire = on_expire  # deadline-drop accounting
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queued_rows = 0
        self._closed = False      # no new submits
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="xtt-serve-batcher")
        self._worker.start()

    # ------------------------------------------------------------ admission
    def submit(self, req: PredictRequest) -> Future:
        with self._cond:
            if self._closed:
                raise ServerClosed("server is closed to new requests")
            # an oversize request (rows > cap) is still admitted when the
            # queue is empty — otherwise it could never be served
            if self._queue and \
                    self._queued_rows + req.rows > self.max_queue_rows:
                raise ServerOverloaded(
                    f"queue full: {self._queued_rows} rows queued, "
                    f"cap {self.max_queue_rows} (request: {req.rows} rows)")
            self._queue.append(req)
            self._queued_rows += req.rows
            self._cond.notify_all()
        return req.future

    def queue_depth_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    # ------------------------------------------------------------- shutdown
    def close(self, drain: bool = True) -> None:
        """Stop intake; with ``drain`` serve the backlog first, otherwise
        fail every queued request with ServerClosed. Idempotent."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._queued_rows -= req.rows
                    req.future.set_exception(
                        ServerClosed("server closed before dispatch"))
            self._cond.notify_all()
        self._worker.join(timeout=600.0)

    # --------------------------------------------------------------- worker
    def _expire_locked(self, now: float) -> None:
        """Fail queued requests whose deadline has passed (head sweep —
        the queue is FIFO, but deadlines are arbitrary, so scan all)."""
        if not any(r.deadline is not None and r.deadline < now
                   for r in self._queue):
            return
        keep, dropped = deque(), 0
        for r in self._queue:
            if r.deadline is not None and r.deadline < now:
                self._queued_rows -= r.rows
                dropped += 1
                r.future.set_exception(DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{(now - r.t_submit) * 1e3:.1f}ms in queue"))
            else:
                keep.append(r)
        self._queue = keep
        if dropped and self._on_expire is not None:
            self._on_expire(dropped)

    def _next_wakeup_locked(self, now: float) -> Optional[float]:
        """Seconds until the nearest queued deadline (bounded poll so an
        expiring request fails promptly even when nothing else happens)."""
        deadlines = [r.deadline for r in self._queue
                     if r.deadline is not None]
        if not deadlines:
            return None
        return max(min(deadlines) - now, 0.0)

    def _form_batch_locked(self) -> List[PredictRequest]:
        """Take the head-of-line request's model key and coalesce up to
        ``max_batch`` rows of same-model requests, waiting at most
        ``max_delay`` from the head's arrival. Returns [] when the queue
        emptied (everything expired)."""
        while True:
            now = time.perf_counter()
            self._expire_locked(now)
            if not self._queue:
                return []
            head = self._queue[0]
            t_close = head.t_submit + self.max_delay_s
            rows = sum(r.rows for r in self._queue
                       if r.model == head.model)
            if rows >= self.max_batch or now >= t_close or self._closed:
                break
            timeout = t_close - now
            wake = self._next_wakeup_locked(now)
            if wake is not None:
                timeout = min(timeout, wake)
            self._cond.wait(timeout)
        batch, rest, total = [], deque(), 0
        for r in self._queue:
            if r.model == self._queue[0].model and (
                    total < self.max_batch or not batch):
                batch.append(r)
                total += r.rows
            else:
                rest.append(r)
        self._queue = rest
        self._queued_rows -= total
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                batch = self._form_batch_locked()
            if batch:
                try:
                    self._dispatch(batch[0].model, batch)
                except Exception as exc:  # fail the futures, keep the worker
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(exc)
