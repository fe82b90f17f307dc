"""The ``Monitor`` (reference ``common::Monitor``,
``src/common/timer.h:16,46``): wall-clock accumulators by label, whose
table prints at verbosity >= 3, as the reference prints its per-class
timing tables under ``--verbosity=3``.

The port of the JAX package's ``obs/monitor.py`` (``utils/timer.py``
and ``logging_utils.py`` re-export it). CUDA work is asynchronous, so a
plain ``start`` / ``stop`` bracket times the host's launches, not the
device's work. ``Monitor(sync=True)`` times the device instead: hand a
section a tensor to wait on, and its clock stops only when the current
stream of that tensor's device has run its work::

    mon = Monitor("Booster", sync=True)
    with mon.section("BoostOneIter") as sec:
        delta = gbm.do_boost(...)
        sec.sync_on(delta)      # stop() waits for delta's device

With ``sync=False`` (the default) the tensor is ignored and the bracket
costs nothing more. A section also records an :mod:`~.trace` span of
the same name (``Booster.BoostOneIter``) when tracing is on.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from . import trace as _trace


class Timer:
    __slots__ = ("elapsed", "count", "_start")

    def __init__(self) -> None:
        self.elapsed = 0.0
        self.count = 0
        self._start = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        self.elapsed += time.perf_counter() - self._start
        self.count += 1


def _block(x) -> None:
    """Wait for the current stream of each CUDA device holding a tensor
    of ``x``; CPU tensors are ready."""
    devs: set = set()
    _trace._cuda_devices(x, devs)
    if devs:
        import torch

        for d in devs:
            torch.cuda.current_stream(d).synchronize()


class Monitor:
    """Label -> :class:`Timer`, with a context-manager shorthand."""

    def __init__(self, name: str = "", sync: bool = False) -> None:
        self.name = name
        self.sync = sync
        self.timers: Dict[str, Timer] = {}

    # -- brackets -------------------------------------------------------------
    def start(self, label: str) -> None:
        self.timers.setdefault(label, Timer()).start()

    def stop(self, label: str, sync_on=None) -> None:
        if self.sync and sync_on is not None:
            _block(sync_on)
        self.timers[label].stop()

    class _Section:
        __slots__ = ("mon", "label", "_sentinel", "_span")

        def __init__(self, mon: "Monitor", label: str) -> None:
            self.mon = mon
            self.label = label
            self._sentinel = None

        def sync_on(self, x) -> None:
            """Under ``Monitor(sync=True)``, wait for ``x``'s device before
            the section's clock stops; a no-op otherwise."""
            self._sentinel = x

        def __enter__(self) -> "Monitor._Section":
            tr = _trace.tracer()
            if tr is not None:
                self._span = tr.span(f"{self.mon.name}.{self.label}"
                                     if self.mon.name else self.label,
                                     "monitor")
                self._span.__enter__()
            else:
                self._span = None
            self.mon.start(self.label)
            return self

        def __exit__(self, *exc):
            self.mon.stop(self.label, sync_on=self._sentinel)
            if self._span is not None:
                self._span.__exit__(*exc)
            self._sentinel = None
            return False

    def section(self, label: str) -> "_Section":
        return Monitor._Section(self, label)

    def timed(self, label: str) -> "_Section":
        """:meth:`section` under its older name."""
        return self.section(label)

    @property
    def totals(self) -> Dict[str, float]:
        return {k: t.elapsed for k, t in self.timers.items()}

    @property
    def counts(self) -> Dict[str, int]:
        return {k: t.count for k, t in self.timers.items()}

    # -- reporting ------------------------------------------------------------
    def report(self) -> str:
        lines = [f"======== Monitor ({self.name}) ========"]
        for label, t in sorted(self.timers.items()):
            lines.append(f"{label}: {t.elapsed * 1e3:.3f}ms, "
                         f"{t.count} calls @ "
                         f"{t.elapsed / max(t.count, 1) * 1e6:.1f}us")
        return "\n".join(lines)

    def maybe_print(self, verbosity: Optional[int] = None) -> None:
        """Print the table when verbosity >= 3 (the reference prints it
        from the Monitor's destructor under the same condition);
        ``verbosity=None`` reads the global config."""
        if verbosity is None:
            from ..config import get_config

            verbosity = get_config().get("verbosity", 1)
        if verbosity >= 3 and self.timers:
            print(self.report())


def annotate(label: str):
    """A named range on the profiler's timeline (the reference's NVTX
    ranges, ``src/common/timer.h:52`` under ``USE_NVTX``): a
    ``torch.profiler.record_function``, usable as a context manager."""
    import torch

    return torch.profiler.record_function(label)


class profile:
    """A ``torch.profiler`` capture around a block, CPU and CUDA
    activity, written as a Chrome trace to ``<log_dir>/trace.json``:
    ``with profile("/tmp/trace"): bst = train(...)``."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir,
                                                    "trace.json"))
        return False
