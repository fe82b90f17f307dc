"""Versioned promotion manifest — the exactly-once commit point.

One JSON file (``manifest.json``) owns every promotion decision. It is
only ever rewritten whole with the tmp + fsync + ``os.replace``
discipline, so readers see either the old state or the new state,
never a torn mix — the single ``os.replace`` IS the commit.

The exactly-once argument: a version number is
consumed and an epoch marked decided in the SAME commit that records
the promotion. Every pipeline action before that commit (training,
gate evaluation, artifact write) is a deterministic function of the
durable page log, so a crash anywhere before the commit makes the
recovering run redo the work and arrive at the byte-identical artifact
before committing once; a crash anywhere after the commit makes the
recovering run see ``decided_epoch`` and skip straight to reconciling
the serve registry (``driver._sync_server``). No double-promotion, no
lost promotion, no version reuse.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..utils.checkpoint import _atomic_write

MANIFEST_FORMAT = "xgboost_tpu.pipeline.manifest"
MANIFEST_VERSION = 1


class PromotionManifest:
    """Durable promote/reject/rollback record for one pipeline workdir."""

    FILENAME = "manifest.json"

    def __init__(self, directory: str,
                 state: Optional[Dict[str, Any]] = None) -> None:
        self.directory = directory
        self.path = os.path.join(directory, self.FILENAME)
        self.state: Dict[str, Any] = state or {
            "format": MANIFEST_FORMAT, "version": MANIFEST_VERSION,
            "active": None,        # the promotion entry currently served
            "decided_epoch": -1,   # epochs <= this have a committed decision
            "last_version": 0,     # high-water mark; never reused
            "rolled_back": [],     # demoted versions (never re-served)
            "history": [],         # every promotion entry, in order
            "events": [],          # append-only audit trail
        }

    # -- load/commit ---------------------------------------------------------
    @classmethod
    def load(cls, directory: str) -> "PromotionManifest":
        path = os.path.join(directory, cls.FILENAME)
        try:
            with open(path) as fh:
                state = json.load(fh)
        except FileNotFoundError:
            return cls(directory)
        if state.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"{path} is not a pipeline manifest")
        return cls(directory, state)

    def commit(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _atomic_write(self.path,
                      json.dumps(self.state, indent=1).encode())

    # -- views ---------------------------------------------------------------
    @property
    def active(self) -> Optional[Dict[str, Any]]:
        return self.state["active"]

    @property
    def decided_epoch(self) -> int:
        return int(self.state["decided_epoch"])

    @property
    def last_version(self) -> int:
        return int(self.state["last_version"])

    def history(self) -> List[Dict[str, Any]]:
        return list(self.state["history"])

    def events(self) -> List[Dict[str, Any]]:
        return list(self.state["events"])

    # -- transitions (each one is a single durable commit) -------------------
    def record_promotion(self, epoch: int, version: int, path: str,
                         rounds: int,
                         scores: Optional[Dict[str, float]] = None,
                         inspect: Optional[Dict[str, Any]] = None) -> None:
        entry = {"version": int(version), "epoch": int(epoch),
                 "path": path, "rounds": int(rounds),
                 "scores": dict(scores or {})}
        if inspect is not None:
            # the per-epoch model report (a deterministic function
            # of the artifact bytes, so live runs and replays commit the
            # byte-identical manifest)
            entry["inspect"] = inspect
        st = self.state
        st["active"] = entry
        st["decided_epoch"] = max(self.decided_epoch, int(epoch))
        st["last_version"] = max(self.last_version, int(version))
        st["history"].append(entry)
        st["events"].append({"type": "promoted", **entry})
        self.commit()

    def record_rejection(self, epoch: int, reason: str,
                         scores: Optional[Dict[str, float]] = None,
                         diff: Optional[Dict[str, Any]] = None) -> None:
        st = self.state
        event = {"type": "rejected", "epoch": int(epoch),
                 "reason": reason, "scores": dict(scores or {})}
        if diff is not None:
            # the model-diff forensic behind the rejection: which features
            # drifted between the live baseline and the failed candidate
            event["diff"] = diff
        st["decided_epoch"] = max(self.decided_epoch, int(epoch))
        st["events"].append(event)
        self.commit()

    def record_rollback(self, epoch: int, version: int,
                        reason: str) -> None:
        """Demote ``version``; the newest earlier promotion that was not
        itself rolled back becomes active again. The epoch stays decided
        (promoted-then-rolled-back IS its committed outcome) and the
        demoted version number is burned — the next candidate takes a
        fresh one."""
        st = self.state
        rb = set(st.get("rolled_back", []))
        rb.add(int(version))
        st["rolled_back"] = sorted(rb)
        prev = None
        for entry in st["history"]:
            if entry["version"] < int(version) \
                    and entry["version"] not in rb:
                prev = entry
        st["active"] = prev
        st["decided_epoch"] = max(self.decided_epoch, int(epoch))
        st["events"].append({
            "type": "rolled_back", "epoch": int(epoch),
            "version": int(version),
            "restored_version": prev["version"] if prev else None,
            "reason": reason})
        self.commit()
