"""Chaos harness: deterministic fault injection at every stage boundary.

A :class:`PipelineFaultPlan` arms exactly one kill (stage x epoch
[x round]) plus optional corruptions; the driver calls
:meth:`PipelineFaultPlan.fire` at each boundary and the plan raises
:class:`~.errors.KilledByChaos` (a ``BaseException`` — nothing inside
the pipeline may swallow it, exactly like a real SIGKILL) when the
armed point is reached. Because the plan fires at most once per
object, the test pattern is: run with a plan until it kills, then run
a FRESH pipeline over the same workdir with no plan and assert the
recovery contract (tests/test_torch_pipeline.py).

Stages, in loop order:

    post_ingest    page appended to the training matrix
    mid_epoch      inside the boosting loop (needs ``kill_round``)
    post_train     epoch trained, before gate evaluation
    post_gate      gates passed, before the artifact write
    post_artifact  artifact durable, BEFORE the manifest commit
    post_manifest  manifest committed, BEFORE the serve swap (mid-swap)
    post_promote   serve swapped, before the canary window

``corrupt_newest_snapshot`` truncates the newest training snapshot at
kill time (recovery must fall back to an older valid one);
``corrupt_artifact_version`` truncates a promoted model file the
moment it lands (read-back verification must reject the promotion);
``flaky_ingest_p`` makes page-log reads fail transiently with that
probability (the retry path must absorb them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .errors import KilledByChaos


def _truncate_half(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(size // 2, 1))


@dataclass
class PipelineFaultPlan:
    """One armed kill + optional corruptions (see module docstring)."""

    kill_stage: Optional[str] = None
    kill_epoch: int = 0
    kill_round: Optional[int] = None      # mid_epoch: global round to die at
    corrupt_newest_snapshot: bool = False
    corrupt_artifact_version: Optional[int] = None
    flaky_ingest_p: float = 0.0
    seed: int = 0

    _fired: bool = field(default=False, repr=False)
    _rng: Optional[np.random.RandomState] = field(default=None, repr=False)

    def fire(self, stage: str, epoch: int, pipeline=None) -> None:
        """Called by the driver at each stage boundary."""
        if self._fired or self.kill_stage != stage \
                or epoch != self.kill_epoch:
            return
        self._fired = True
        if self.corrupt_newest_snapshot and pipeline is not None:
            self._corrupt_newest_snapshot(pipeline)
        err = KilledByChaos(stage, epoch)
        err.bundle = self._write_black_box(stage, epoch, pipeline, err)
        raise err

    def _write_black_box(self, stage: str, epoch: int, pipeline,
                         err) -> Optional[str]:
        """Every kill leaves a readable postmortem: the bundle is written
        HERE, at the kill instant, because :class:`KilledByChaos` is a
        ``BaseException`` the harness catches — it never reaches the
        process excepthook the armed black box watches. Returns the
        bundle path (also attached to the exception as ``.bundle``), or
        ``None`` when neither the pipeline nor the global box exists."""
        box = getattr(pipeline, "blackbox", None)
        if box is None:
            from ..obs import flight

            box = flight.armed()
        if box is None:
            return None
        return box.write(f"chaos-kill:{stage}", exc=err,
                         extra={"stage": stage, "epoch": epoch,
                                "kill_round": self.kill_round})

    def _corrupt_newest_snapshot(self, pipeline) -> None:
        """Truncate the newest snapshot DATA file while keeping its
        sidecar — the exact artifact a kill mid-fsync leaves behind,
        which the resume scan must skip (CRC mismatch), not trust."""
        from ..utils.checkpoint import list_snapshots

        newest = None
        try:
            names = {fn.split("_")[0] for fn in os.listdir(pipeline._ckdir)
                     if fn.endswith(".ubj")}
        except OSError:
            return
        for name in names:
            for r, path in list_snapshots(pipeline._ckdir, name):
                if newest is None or r > newest[0]:
                    newest = (r, path)
        if newest is not None:
            _truncate_half(newest[1])

    def ingest_fault(self, index: int) -> None:
        """PageLog ``read_fault`` hook: deterministic (seeded) transient
        read failures, absorbed by the ``_retry_io`` backoff."""
        if self.flaky_ingest_p <= 0.0:
            return
        if self._rng is None:
            self._rng = np.random.RandomState(self.seed)
        if self._rng.random_sample() < self.flaky_ingest_p:
            raise OSError(f"chaos: transient read failure on page {index}")

    def maybe_corrupt_artifact(self, version: int, path: str) -> None:
        """Called right after a promoted artifact lands on disk."""
        if self.corrupt_artifact_version == version \
                and os.path.exists(path):
            _truncate_half(path)
