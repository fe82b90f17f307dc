"""The continuous train -> evaluate -> promote loop (the port of the JAX
package's ``pipeline/driver.py``).

One :class:`Pipeline` owns a workdir with four durable pieces::

    workdir/pages/        append-only page log  (source of truth)
    workdir/checkpoints/  per-epoch training snapshots (an optimization)
    workdir/models/       promoted artifacts, one per version, + CRC
    workdir/manifest.json promotion decisions   (the commit point)

Epoch ``e`` absorbs page ``e`` into the live training matrix, continues
boosting the lineage to ``(e + 1) * rounds_per_epoch`` TOTAL rounds,
evaluates the candidate on the fixed holdout against the drift gates,
and — on pass — writes a versioned artifact, commits the promotion to
the manifest, hot-swaps it into the serve registry and runs a canary
comparison on the freshest page. Training is MONOTONE: the lineage
advances every epoch regardless of the gate outcome (gates control
what is SERVED, never what is learned), which keeps every epoch a
deterministic function of the page-log prefix.

Crash safety: every byte of state the loop needs lives behind the
tmp + fsync + ``os.replace`` discipline, so a ``kill -9`` at ANY point
resumes cleanly — mid-epoch from the newest valid snapshot, post-gate
by deterministically re-training the byte-identical candidate,
post-commit by reconciling the serve registry from the manifest
(:meth:`Pipeline._sync_server` is idempotent). When snapshots are
missing or corrupt the loop falls back to full byte-exact replay from
the page log (:meth:`Pipeline._replay_model`).

The loop trains, scores and predicts on ``params["device"]`` (the card
unless it says ``"cpu"``): the epochs' rounds through the histogram
kernels, the gates' holdout predict, the canary's two predicts and the
eval walk through K1, and a ``Server`` that promotions hot-swap answers
through K1 too. Each stage runs in a trace span (``pipeline/ingest``,
``pipeline/train``, ``pipeline/gates``, ``pipeline/artifact``,
``pipeline/swap``, ``pipeline/canary``).
"""

from __future__ import annotations

import os
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..context import resolve_device
from ..obs import trace as _trace
from ..obs.metrics import Family, Sample, get_registry
from ..utils.checkpoint import (CheckpointConfig, _atomic_write, _crc_path,
                                dmatrix_fingerprint, latest_valid_snapshot)
from .chaos import PipelineFaultPlan
from .errors import CanaryRolledBack, DriftGateFailed, PipelineError, \
    PromotionRejected
from .gates import DriftGates, GateRule
from .manifest import PromotionManifest
from .pagelog import PageLog


@dataclass
class PipelineConfig:
    """Knobs for one continuous pipeline (defaults favor small tests)."""

    workdir: str
    params: Dict[str, Any] = field(default_factory=dict)
    rounds_per_epoch: int = 10
    model_name: str = "model"
    gates: Sequence[GateRule] = ()
    canary_metric: Optional[str] = None        # default: first gate metric
    canary_max_regression: Optional[float] = None  # None disables the canary
    checkpoint_every: int = 5                  # rounds between snapshots
    checkpoint_keep: int = 3                   # snapshots kept per epoch
    keep_epoch_snapshots: int = 2              # finished epochs kept on disk


class Pipeline:
    """Self-healing continuous train->serve loop over one workdir.

    ``holdout`` is the FIXED evaluation set the drift gates score on
    (``(X, y)`` tuple or a DMatrix); required when ``config.gates`` is
    non-empty. ``server`` is an optional :class:`~..serve.Server` that
    promotions hot-swap into. ``chaos`` arms a
    :class:`~.chaos.PipelineFaultPlan` for the fault-injection tests.
    """

    def __init__(self, config: PipelineConfig, server=None,
                 holdout=None,
                 chaos: Optional[PipelineFaultPlan] = None) -> None:
        self.config = config
        self.server = server
        self.chaos = chaos
        os.makedirs(config.workdir, exist_ok=True)
        self.log = PageLog(os.path.join(config.workdir, "pages"))
        if chaos is not None and chaos.flaky_ingest_p > 0.0:
            self.log.read_fault = chaos.ingest_fault
        self.manifest = PromotionManifest.load(config.workdir)
        self._ckdir = os.path.join(config.workdir, "checkpoints")
        self._models_dir = os.path.join(config.workdir, "models")
        os.makedirs(self._ckdir, exist_ok=True)
        os.makedirs(self._models_dir, exist_ok=True)
        self.gates = DriftGates(list(config.gates))
        self._holdout = self._as_dmatrix(holdout)
        if self.gates.rules and self._holdout is None:
            raise ValueError("drift gates need a fixed holdout set; pass "
                             "holdout=(X, y) (or a DMatrix) to Pipeline")
        self._max_bin = int(config.params.get("max_bin", 256))
        self._device = resolve_device(str(config.params.get("device",
                                                            "cuda")))
        self._dm = None          # live training matrix (pages 0.._next_page-1)
        self._next_page = 0      # first page NOT yet absorbed into _dm
        self._last_promotion_ms: Optional[float] = None
        # crash forensics: any chaos kill (or caller-routed failure)
        # leaves a CRC-sidecar postmortem bundle under the workdir —
        # construction is free, I/O happens only on write
        from ..obs.flight import BlackBox

        self.blackbox = BlackBox(os.path.join(config.workdir, "blackbox"))
        get_registry().register(Pipeline._collect_obs, owner=self)

    def _collect_obs(self) -> List[Family]:
        """Registry collector: the :meth:`status` gauges as Prometheus
        series, so one scrape of serve's ``/metrics`` covers the loop."""
        st = self.status()
        gauges = [("xtpu_pipeline_pages", "durable pages in the log",
                   st["pages"]),
                  ("xtpu_pipeline_absorbed_pages",
                   "pages absorbed into the live matrix",
                   st["absorbed_pages"]),
                  ("xtpu_pipeline_decided_epoch",
                   "newest epoch with a committed decision",
                   st["decided_epoch"]),
                  ("xtpu_pipeline_active_version",
                   "manifest's active model version (-1 when none)",
                   st["active_version"] if st["active_version"] is not None
                   else -1),
                  ("xtpu_pipeline_rounds_behind",
                   "rounds the served model trails the page log",
                   st["rounds_behind"])]
        fams = [Family(n, "gauge", h, [Sample(v)]) for n, h, v in gauges]
        fams.append(Family("xtpu_pipeline_promotions_total", "counter",
                           "committed promotions over the workdir lifetime",
                           [Sample(st["promotions"])]))
        fams.append(Family("xtpu_pipeline_rollbacks_total", "counter",
                           "versions rolled back by canary/serve failures",
                           [Sample(len(st["rolled_back"]))]))
        return fams

    @staticmethod
    def _as_dmatrix(data):
        from ..data.dmatrix import DMatrix

        if data is None or isinstance(data, DMatrix):
            return data
        X, y = data
        return DMatrix(X, label=y)

    def _fire(self, stage: str, epoch: int) -> None:
        if self.chaos is not None:
            self.chaos.fire(stage, epoch, pipeline=self)

    # -- ingest --------------------------------------------------------------
    def step(self, X, y, weight=None) -> List[Dict[str, Any]]:
        """Durably ingest one page of labeled rows and drive the loop to
        a decision for it (plus any backlog). Returns the decision
        report entries produced (see :meth:`run_pending`)."""
        self.log.append(X, y, weight)
        return self.run_pending()

    def _absorb(self, e: int) -> None:
        page = self.log.read(e)
        if page["y"] is None:
            raise PipelineError(
                f"page {e} carries no labels; training pages must be "
                "ingested with y")
        if self._dm is None:
            # pin the quantization cuts on page 0 BEFORE any append: every
            # later page bins against these exact cuts, in the live run and
            # in replay alike — the heart of byte-exact determinism
            self._dm = self._first_page(page)
        else:
            self._dm.append(page["X"], label=page["y"], weight=page["w"])
        self._fire("post_ingest", e)

    def _first_page(self, page):
        """Page 0 as the lineage's matrix, its cuts sketched and its bins
        built on the device now, so that every append bins against them
        (``DMatrix.append``) and grows the device bins in place."""
        from ..data.dmatrix import DMatrix

        dm = DMatrix(page["X"], label=page["y"], weight=page["w"])
        dm.binned(self._max_bin, self._device)
        return dm

    # -- the loop ------------------------------------------------------------
    def run_pending(self) -> List[Dict[str, Any]]:
        """Absorb every durable page and decide every undecided epoch,
        then reconcile the serve registry with the manifest. Safe to
        call on a fresh :class:`Pipeline` over an existing workdir —
        this IS the crash-recovery path; there is no separate one."""
        report: List[Dict[str, Any]] = []
        total = self.log.count()
        while self._next_page < total:
            e = self._next_page
            with _trace.span("pipeline/ingest"):
                self._absorb(e)
            self._next_page += 1
            if e <= self.manifest.decided_epoch:
                continue          # already committed; absorb-only replay
            with _trace.span("pipeline/train"):
                bst = self._train_epoch(e)
            with _trace.span("pipeline/decide"):
                report.append(self._decide(e, bst))
            self._gc_snapshots(e)
        with _trace.span("pipeline/sync_server"):
            self._sync_server()
        return report

    # -- training ------------------------------------------------------------
    def _train_epoch(self, e: int):
        """Continue the lineage to ``(e + 1) * k`` total rounds on the
        matrix holding pages ``0..e``. Resumes a mid-epoch snapshot when
        one matches the matrix fingerprint; otherwise continues fresh
        from the previous epoch's final model bytes."""
        from .. import train

        k = self.config.rounds_per_epoch
        name = f"ep{e:04d}"
        ckcfg = CheckpointConfig(
            directory=self._ckdir, every_n_rounds=self.config.checkpoint_every,
            keep=self.config.checkpoint_keep, name=name,
            extra={"epoch": e, "pages": e + 1})
        callbacks = self._mid_epoch_chaos(e)
        fp = dmatrix_fingerprint(self._dm)
        found = latest_valid_snapshot(self._ckdir, name, fingerprint=fp)
        if found is not None:
            # auto-resume inside the epoch: TOTAL-round semantics
            return train(self.config.params, self._dm, (e + 1) * k,
                         checkpoint=ckcfg, callbacks=callbacks,
                         verbose_eval=False)
        prev = self._final_booster(e - 1)
        if prev is None:
            return train(self.config.params, self._dm, k,
                         checkpoint=ckcfg, callbacks=callbacks,
                         verbose_eval=False)
        # xgb_model continuation: k ADDITIONAL rounds on top of e * k
        return train(self.config.params, self._dm, k, xgb_model=prev,
                     checkpoint=ckcfg, callbacks=callbacks,
                     verbose_eval=False)

    def _mid_epoch_chaos(self, e: int):
        plan = self.chaos
        if plan is None or plan._fired or plan.kill_stage != "mid_epoch" \
                or plan.kill_epoch != e or plan.kill_round is None:
            return None
        from ..callback import AbortAtRound

        def _kill():
            # fire() raises KilledByChaos (and applies any armed snapshot
            # corruption); it propagates out of the boosting loop through
            # train()'s cleanup path, flushing snapshots like a real kill
            plan.fire("mid_epoch", e, pipeline=self)

        return [AbortAtRound(plan.kill_round, _kill)]

    def _booster_from_bytes(self, raw: bytes):
        """Rebuild a Booster from model bytes. BOTH continuation paths go
        through bytes (never a live object) so dart RNG streams and all
        derived state restart identically in live runs and replays."""
        from .. import Booster

        bst = Booster(self.config.params)
        bst.load_model(bytearray(raw))
        bst.set_param(self.config.params)
        return bst

    def _final_booster(self, e: int):
        """The lineage model after epoch ``e`` (None for ``e < 0``):
        the epoch's FINAL snapshot when it survives on disk, else a full
        deterministic replay from the page log — snapshots are an
        optimization, the log is the source of truth."""
        if e < 0:
            return None
        target = (e + 1) * self.config.rounds_per_epoch
        found = latest_valid_snapshot(self._ckdir, f"ep{e:04d}")
        if found is not None and found[0].round == target:
            return self._booster_from_bytes(found[0].model)
        return self._replay_model(e)

    def _replay_model(self, e: int):
        """Byte-exact replay of the lineage through epoch ``e`` from the
        page log alone: rebuild the matrix page by page (cuts pinned on
        page 0, exactly like the live run) and re-train each epoch from
        the previous epoch's serialized bytes."""
        from .. import train

        k = self.config.rounds_per_epoch
        bst = None
        dm = None
        for j in range(e + 1):
            page = self.log.read(j)
            if dm is None:
                dm = self._first_page(page)
            else:
                dm.append(page["X"], label=page["y"], weight=page["w"])
            if bst is not None:
                bst = self._booster_from_bytes(bytes(bst.save_raw("ubj")))
                bst = train(self.config.params, dm, k, xgb_model=bst,
                            verbose_eval=False)
            else:
                bst = train(self.config.params, dm, k, verbose_eval=False)
        return bst

    # -- decision ------------------------------------------------------------
    def _artifact_path(self, version: int) -> str:
        return os.path.join(self._models_dir, f"v{version:06d}.ubj")

    def _read_artifact(self, path: str) -> bytes:
        """CRC-verified artifact read; raises :class:`PromotionRejected`
        when the bytes on disk are not the bytes that were promoted."""
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
            with open(_crc_path(path)) as fh:
                want_crc, want_len = fh.read().split()
        except (OSError, ValueError) as err:
            raise PromotionRejected(
                f"promoted artifact {path} is unreadable ({err})",
                path=path) from err
        if len(raw) != int(want_len) or zlib.crc32(raw) != int(want_crc, 16):
            raise PromotionRejected(
                f"promoted artifact {path} failed CRC validation "
                "(truncated or corrupted write)", path=path)
        return raw

    def _diff_report(self, bst) -> Optional[Dict[str, Any]]:
        """xtpuinsight forensic for a rejection: diff the candidate
        against the live baseline artifact on the fixed holdout. None
        when no baseline is active; never raises (forensics are
        best-effort, a broken explanation must not mask the decision)."""
        active = self.manifest.active
        if active is None or bst is None:
            return None
        try:
            base = self._booster_from_bytes(
                self._read_artifact(active["path"]))
        except Exception:
            return None
        return self.gates.explain(base, bst, dm=self._holdout)

    def _inspect_summary(self, bst) -> Optional[Dict[str, Any]]:
        """Compact ``Booster.inspect()`` snapshot for the manifest entry:
        shape totals plus the top-5 normalized total_gain features. A
        deterministic function of the model bytes, so live runs and
        replays commit byte-identical manifests; never raises."""
        from ..obs import insight as _insight

        try:
            full = _insight.model_inspect(bst)
            gain = _insight._normalized_importance(bst, "total_gain")
        except Exception:
            return None
        out: Dict[str, Any] = {
            "num_trees": full["num_trees"],
            "num_features": full["num_features"],
            "top_gain": dict(sorted(gain.items(),
                                    key=lambda kv: (-kv[1], kv[0]))[:5])}
        shape = full.get("tree_shape")
        if shape:
            out["nodes_total"] = shape["nodes_total"]
            out["leaves_total"] = shape["leaves_total"]
        return out

    def _decide(self, e: int, bst) -> Dict[str, Any]:
        """Gate -> artifact -> manifest commit -> serve swap -> canary.
        Everything before :meth:`PromotionManifest.record_promotion` is
        re-done deterministically after a crash; everything after it is
        idempotent reconciliation."""
        self._fire("post_train", e)
        k = self.config.rounds_per_epoch
        active = self.manifest.active
        baseline = active["scores"] if active else None
        try:
            with _trace.span("pipeline/gates"):
                scores = self.gates.evaluate(bst, self._holdout) \
                    if self._holdout is not None else {}
                self.gates.check(scores, baseline, e)
        except DriftGateFailed as err:
            diff = self._diff_report(bst)
            err.report = diff
            self.manifest.record_rejection(e, str(err), scores, diff=diff)
            return {"epoch": e, "action": "rejected", "reason": str(err),
                    "scores": scores, "diff": diff, "error": err}
        self._fire("post_gate", e)
        with _trace.span("pipeline/artifact"):
            version = self._commit_artifact(e, bst, scores)
        self._fire("post_manifest", e)

        t0 = time.perf_counter()
        with _trace.span("pipeline/swap"):
            self._sync_server()
        self._last_promotion_ms = (time.perf_counter() - t0) * 1e3
        self._fire("post_promote", e)

        entry: Dict[str, Any] = {
            "epoch": e, "action": "promoted", "version": version,
            "rounds": (e + 1) * k, "scores": scores,
            "promotion_ms": self._last_promotion_ms}
        with _trace.span("pipeline/canary"):
            canary = self._canary(e, version, bst)
        if canary is not None:
            entry["canary"] = canary
            if canary.get("rolled_back"):
                entry["action"] = "rolled_back"
        return entry

    def _commit_artifact(self, e: int, bst, scores: Dict[str, float]
                         ) -> int:
        """Write the candidate's artifact, verify that it reads back, and
        commit its promotion with its gate ``scores`` -> its version."""
        k = self.config.rounds_per_epoch
        version = self.manifest.last_version + 1
        path = self._artifact_path(version)
        raw = bytes(bst.save_raw("ubj"))
        _atomic_write(path, raw)
        _atomic_write(_crc_path(path),
                      f"{zlib.crc32(raw):08x} {len(raw)}\n".encode())
        if self.chaos is not None:
            self.chaos.maybe_corrupt_artifact(version, path)
        self._fire("post_artifact", e)

        # read-back verification BEFORE the commit: the manifest must
        # never point at bytes that cannot serve. On failure the epoch
        # stays undecided — recovery re-trains the byte-identical
        # candidate and retries with the same version number.
        try:
            checked = self._read_artifact(path)
        except PromotionRejected as err:
            raise PromotionRejected(
                f"promoted artifact v{version} failed read-back "
                f"verification: {err} — previous version keeps serving; "
                "recovery will regenerate it", version=version, epoch=e,
                path=path, report=self._diff_report(bst)) from err
        try:
            self._booster_from_bytes(checked)
        except Exception as err:
            raise PromotionRejected(
                f"promoted artifact v{version} failed read-back load: "
                f"{err} — previous version keeps serving; recovery will "
                "regenerate it", version=version, epoch=e,
                path=path, report=self._diff_report(bst)) from err

        self.manifest.record_promotion(e, version, path,
                                       rounds=(e + 1) * k, scores=scores,
                                       inspect=self._inspect_summary(bst))
        return version

    # -- serve reconciliation ------------------------------------------------
    def _sync_server(self) -> None:
        """Idempotent: make the registry serve the manifest's active
        version. Covers the normal promotion swap AND recovery from a
        crash between commit and swap. A corrupt active artifact demotes
        it (previous version keeps serving) and raises the typed error."""
        if self.server is None:
            return
        active = self.manifest.active
        if active is None:
            return
        name = self.config.model_name
        from ..serve.registry import ModelLoadError, UnknownModel

        if hasattr(self.server, "served_versions"):
            # fleet target: reconcile against the SET of versions live
            # across replicas — a mixed set (interrupted fan-out) must
            # re-fan even if some replica already serves the active
            # version, so the whole fleet converges
            versions = self.server.served_versions(name)
            served_version = (versions.pop() if len(versions) == 1
                              else None if not versions else -1)
        else:
            try:
                served_version = self.server.registry.get(name).version
            except UnknownModel:
                served_version = None
        if served_version == active["version"]:
            return
        try:
            raw = self._read_artifact(active["path"])
            if served_version is None:
                self.server.load_model(name, bytearray(raw),
                                       version=active["version"])
            else:
                self.server.swap_model(name, bytearray(raw),
                                       version=active["version"])
        except (PromotionRejected, ModelLoadError) as err:
            self.manifest.record_rollback(
                active["epoch"], active["version"],
                f"unserveable active artifact: {err}")
            raise PromotionRejected(
                f"active artifact v{active['version']} could not be "
                f"served ({err}); rolled back — previous version stays "
                "live", version=active["version"], epoch=active["epoch"],
                path=active["path"]) from err

    # -- canary --------------------------------------------------------------
    def _canary(self, e: int, version: int, bst) -> Optional[Dict[str, Any]]:
        """Post-promotion check on FRESH data (the newest page): compare
        the just-promoted candidate against the previous promotion. A
        regression past ``canary_max_regression`` rolls the serve
        registry AND the manifest back — recorded on the report, not
        raised (rollback is the designed recovery)."""
        cfg = self.config
        if cfg.canary_max_regression is None:
            return None
        metric_name = cfg.canary_metric or (
            self.gates.rules[0].metric if self.gates.rules else None)
        if metric_name is None:
            return None
        rolled_back = set(self.manifest.state.get("rolled_back", []))
        prev_entry = None
        for en in self.manifest.history():
            if en["version"] < version and en["version"] not in rolled_back:
                prev_entry = en
        if prev_entry is None:
            return None                       # first promotion: no baseline
        from ..data.dmatrix import DMatrix
        from ..metric import get_metric

        page = self.log.read(e)
        window = DMatrix(page["X"], label=page["y"], weight=page["w"])
        metric = get_metric(metric_name)
        cand = float(metric(np.asarray(bst.predict(window)), window.info))
        prev_bst = self._booster_from_bytes(
            self._read_artifact(prev_entry["path"]))
        base = float(metric(np.asarray(prev_bst.predict(window)),
                            window.info))
        hi = bool(metric.maximize)
        regression = (base - cand) if hi else (cand - base)
        out = {"metric": metric_name, "candidate": cand, "baseline": base,
               "regression": regression, "rolled_back": False}
        if regression <= cfg.canary_max_regression:
            return out
        reason = (f"canary: {metric_name} regressed {regression:.6g} on "
                  f"the fresh window ({cand:.6g} vs {base:.6g}; allowed "
                  f"{cfg.canary_max_regression:g})")
        if self.server is not None:
            self.server.rollback_model(self.config.model_name)
        self.manifest.record_rollback(e, version, reason)
        out["rolled_back"] = True
        out["restored_version"] = prev_entry["version"]
        out["error"] = CanaryRolledBack(
            reason, version=version, restored_version=prev_entry["version"],
            metric=metric_name, candidate=cand, baseline=base, epoch=e)
        return out

    # -- housekeeping --------------------------------------------------------
    def _gc_snapshots(self, e: int) -> None:
        """Drop snapshot files for epochs old enough that recovery would
        replay them from the page log anyway."""
        cut = e - self.config.keep_epoch_snapshots
        if cut < 0:
            return
        pat = re.compile(r"ep(\d{4})_\d{8}\.ubj(\.crc)?$")
        try:
            names = os.listdir(self._ckdir)
        except OSError:
            return
        for fn in names:
            m = pat.match(fn)
            if m and int(m.group(1)) <= cut:
                try:
                    os.remove(os.path.join(self._ckdir, fn))
                except OSError:
                    pass

    def status(self) -> Dict[str, Any]:
        """Loop telemetry (the CLI's ``command=status``, the registry
        collector)."""
        active = self.manifest.active
        pages = self.log.count()
        k = self.config.rounds_per_epoch
        active_rounds = int(active["rounds"]) if active else 0
        return {
            "pages": pages,
            "absorbed_pages": self._next_page,
            "decided_epoch": self.manifest.decided_epoch,
            "active_version": active["version"] if active else None,
            "active_rounds": active_rounds,
            "rounds_behind": pages * k - active_rounds,
            "last_promotion_ms": self._last_promotion_ms,
            "promotions": len(self.manifest.history()),
            "rolled_back": list(self.manifest.state.get("rolled_back", [])),
        }
