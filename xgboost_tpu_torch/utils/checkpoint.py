"""Full-state training snapshots: atomic write, CRC check, auto-resume.

The port of the JAX package's ``utils/checkpoint.py`` (reference rabit
``CheckPoint`` / ``LoadCheckPoint``), in the same file format, so that a
snapshot either package writes loads in the other. A
:class:`TrainingSnapshot` holds what the round loop consumes:

- the booster's ``save_raw('ubj')`` (trees, attributes with the early
  stopping state, objective and configuration);
- the round counter: every key of the tree growers is a function of
  ``(seed, iteration)``, so the counter and the saved seed are their
  state;
- the training margin [n, K] f32: a resume that walked the trees again
  would add the leaf values in another order than training added them,
  and the models would part by an ulp; with the captured bits a run
  killed at round k and resumed saves the straight run's bytes;
- ``extra``: a stateful booster's ``RandomState`` (dart's drops) and the
  eval history (``obs/training_log.py TrainingLog``), so that
  ``evals_result`` and early stopping's patience go on where they were;
- a fingerprint of the training matrix (shape, label and weight CRCs,
  and its append chain), so that a snapshot is never resumed against
  other data.

Snapshots are UBJSON files written atomically (a temporary file, fsync,
``os.replace``) with a CRC32 sidecar; the resume scan walks from the
newest to the oldest and skips a corrupt or truncated snapshot with a
warning. :class:`CheckpointManager` is the train loop's side: boundary
alignment, ``keep=N`` pruning and an optional background writer.
"""

from __future__ import annotations

import os
import re
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..logging_utils import logger

SNAPSHOT_FORMAT = "xgboost_tpu.snapshot"
SNAPSHOT_VERSION = 1


class SnapshotError(RuntimeError):
    """Checkpoint subsystem failure (configuration / protocol level)."""


class SnapshotCorrupt(SnapshotError):
    """A snapshot file failed CRC/parse validation (truncated write, bit
    rot). The resume scan treats these as absent and falls back."""


@dataclass
class CheckpointConfig:
    """``xgb.train(..., checkpoint=CheckpointConfig(dir))`` configuration.

    ``resume='auto'`` scans ``directory`` for the newest VALID snapshot at
    train() entry and continues from it.
    When a run resumes, ``num_boost_round`` is interpreted as the TOTAL
    round target (re-running the identical command converges to the same
    model instead of overshooting by the already-boosted rounds).

    ``background=True`` moves snapshot serialization + IO to a writer
    thread so the round loop never stalls on disk (device->host margin
    capture stays synchronous — it is the consistency point).
    """

    directory: str
    every_n_rounds: int = 10
    keep: int = 3
    background: bool = False
    resume: Any = "auto"          # "auto" | True | False
    name: str = "snapshot"
    # caller-owned state merged into every snapshot's ``extra`` dict — the
    # pipeline driver rides its epoch/page bookkeeping on the same durable
    # artifact instead of inventing a second state file (docs/pipeline.md)
    extra: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.every_n_rounds < 1:
            raise ValueError("every_n_rounds must be >= 1, got "
                             f"{self.every_n_rounds}")
        if self.keep is not None and self.keep < 1:
            raise ValueError(f"keep must be >= 1 or None, got {self.keep}")


@dataclass
class TrainingSnapshot:
    """One recoverable training state (see module docstring)."""

    round: int
    model: bytes                            # Booster.save_raw("ubj")
    margin: Optional[np.ndarray] = None     # [n, K] f32 training margin
    fingerprint: Dict[str, Any] = field(default_factory=dict)
    rng: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_obj(self) -> dict:
        obj = {
            "format": SNAPSHOT_FORMAT,
            "version": SNAPSHOT_VERSION,
            "round": int(self.round),
            "model": np.frombuffer(bytes(self.model), np.uint8),
            "fingerprint": dict(self.fingerprint),
            "rng": dict(self.rng),
            "extra": dict(self.extra),
        }
        if self.margin is not None:
            m = np.ascontiguousarray(self.margin, np.float32)
            obj["margin"] = {"shape": list(m.shape), "data": m.reshape(-1)}
        else:
            obj["margin"] = None
        return obj

    @staticmethod
    def from_obj(obj: dict) -> "TrainingSnapshot":
        if not isinstance(obj, dict) \
                or obj.get("format") != SNAPSHOT_FORMAT:
            raise SnapshotCorrupt("not a xgboost_tpu training snapshot")
        if int(obj.get("version", -1)) > SNAPSHOT_VERSION:
            raise SnapshotError(
                f"snapshot version {obj['version']} is newer than this "
                f"build understands ({SNAPSHOT_VERSION})")
        margin = None
        m = obj.get("margin")
        if m is not None:
            margin = np.asarray(m["data"], np.float32).reshape(
                [int(s) for s in m["shape"]])
        model = obj["model"]
        model = (model.astype(np.uint8).tobytes()
                 if isinstance(model, np.ndarray)
                 else bytes(bytearray(int(b) & 0xFF for b in model)))
        return TrainingSnapshot(
            round=int(obj["round"]), model=model, margin=margin,
            fingerprint=dict(obj.get("fingerprint") or {}),
            rng=dict(obj.get("rng") or {}),
            extra=dict(obj.get("extra") or {}))


# ------------------------------------------------------------------- file IO

def _crc_path(path: str) -> str:
    return path + ".crc"


def _atomic_write(path: str, payload: bytes) -> None:
    """tmp + flush + fsync + ``os.replace``: a crash mid-write can never
    leave a truncated file under the final name."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def snapshot_path(directory: str, round_: int, name: str = "snapshot") -> str:
    return os.path.join(directory, f"{name}_{round_:08d}.ubj")


def write_snapshot(directory: str, snap: TrainingSnapshot,
                   name: str = "snapshot") -> str:
    """Serialize + atomically persist ``snap``; returns the path. The data
    file lands before its CRC sidecar, so a crash between the two leaves a
    snapshot the loader rejects (stale/missing sidecar) rather than one it
    trusts."""
    from .ubjson import dumps_ubjson

    os.makedirs(directory, exist_ok=True)
    payload = dumps_ubjson(snap.to_obj())
    path = snapshot_path(directory, snap.round, name)
    _atomic_write(path, payload)
    crc = zlib.crc32(payload)
    _atomic_write(_crc_path(path),
                  f"{crc:08x} {len(payload)}\n".encode())
    return path


def load_snapshot(path: str) -> TrainingSnapshot:
    """Load + validate one snapshot; raises :class:`SnapshotCorrupt` on any
    integrity failure (missing/mismatched sidecar, truncation, bad parse)."""
    from .ubjson import loads_ubjson

    try:
        with open(path, "rb") as fh:
            payload = fh.read()
    except OSError as e:
        raise SnapshotCorrupt(f"cannot read snapshot {path}: {e}") from e
    try:
        with open(_crc_path(path)) as fh:
            want_crc, want_len = fh.read().split()
    except (OSError, ValueError) as e:
        raise SnapshotCorrupt(
            f"snapshot {path} has no valid CRC sidecar "
            "(crash between data and sidecar write?)") from e
    if len(payload) != int(want_len) \
            or zlib.crc32(payload) != int(want_crc, 16):
        raise SnapshotCorrupt(
            f"snapshot {path} failed CRC validation (truncated or "
            "corrupted write)")
    try:
        return TrainingSnapshot.from_obj(loads_ubjson(payload))
    except SnapshotError:
        raise
    except Exception as e:
        raise SnapshotCorrupt(f"snapshot {path} failed to parse: {e}") from e


def list_snapshots(directory: str,
                   name: str = "snapshot") -> List[Tuple[int, str]]:
    """``(round, path)`` pairs present on disk, newest round first (validity
    not checked — see :func:`latest_valid_snapshot`)."""
    pat = re.compile(re.escape(name) + r"_(\d+)\.ubj$")
    out = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    for fn in entries:
        m = pat.match(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, fn)))
    out.sort(reverse=True)
    return out


def latest_valid_snapshot(
        directory: str, name: str = "snapshot",
        fingerprint: Optional[Dict[str, Any]] = None,
) -> Optional[Tuple[TrainingSnapshot, str]]:
    """Newest snapshot that loads cleanly (and matches ``fingerprint`` when
    given). Corrupt/truncated/mismatched candidates are SKIPPED with a
    warning — recovery falls back to the next-older state instead of dying
    on the artifact the crash itself mangled."""
    for round_, path in list_snapshots(directory, name):
        try:
            snap = load_snapshot(path)
        except SnapshotCorrupt as e:
            logger.warning("skipping invalid snapshot %s: %s", path, e)
            continue
        if fingerprint is not None and snap.fingerprint \
                and not fingerprints_match(snap.fingerprint, fingerprint):
            logger.warning(
                "skipping snapshot %s: DMatrix fingerprint mismatch "
                "(snapshot %s vs data %s) — it belongs to a different "
                "training set", path, snap.fingerprint, fingerprint)
            continue
        return snap, path
    return None


def prune_snapshots(directory: str, keep: int,
                    name: str = "snapshot") -> None:
    """Delete all but the newest ``keep`` COMPLETE snapshots (+ sidecars,
    stray tmps). Only snapshots whose CRC sidecar landed count toward
    ``keep``: a data file without its sidecar is either a write still in
    flight (always newer than every complete snapshot — the writer lands
    data before sidecar) or debris from a kill between the two writes.
    Counting such a file toward ``keep`` would push a complete, resumable
    snapshot into the delete range — exactly the state a mid-write crash
    needs to fall back to — so in-flight files are left alone and only
    debris OLDER than the newest complete snapshot is collected."""
    snaps = list_snapshots(directory, name)
    complete = [(r, p) for r, p in snaps if os.path.exists(_crc_path(p))]
    for _, path in complete[keep:]:
        for p in (path, _crc_path(path)):
            try:
                os.remove(p)
            except OSError:
                pass
    newest_complete = complete[0][0] if complete else None
    for r, path in snaps:
        if newest_complete is not None and r < newest_complete \
                and not os.path.exists(_crc_path(path)):
            try:
                os.remove(path)
            except OSError:
                pass
    try:
        for fn in os.listdir(directory):
            if fn.startswith(name + "_") and fn.endswith(".tmp"):
                os.remove(os.path.join(directory, fn))
    except OSError:
        pass


# --------------------------------------------------------------- fingerprint

def dmatrix_fingerprint(dm: Any) -> Dict[str, Any]:
    """Cheap identity of a training DMatrix: shape + CRC of labels/weights.
    Catches "resumed against the wrong data" without hashing the matrix
    itself (the label vector is ~n bytes; the bin matrix can be tens of
    GB)."""
    fp: Dict[str, Any] = {"n_rows": int(dm.num_row()),
                          "n_cols": int(dm.num_col())}
    info = getattr(dm, "info", None)
    for key, arr in (("labels", getattr(info, "labels", None)),
                     ("weights", getattr(info, "weights", None))):
        if arr is not None:
            a = np.ascontiguousarray(np.asarray(arr, np.float32))
            fp[f"{key}_crc"] = int(zlib.crc32(a.tobytes()))
    # append-evolution identity (DMatrix.append): the chained CRC over
    # every appended (features, labels) block pins WHICH ingest position
    # this matrix is at — labels_crc alone cannot distinguish two streams
    # whose labels agree but whose features differ
    chain = getattr(dm, "_append_chain", None)
    if chain is not None:
        fp["append_chain"] = int(chain)
        fp["n_appends"] = int(getattr(dm, "_n_appends", 0))
    return fp


def fingerprints_match(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    keys = set(a) & set(b)
    return bool(keys) and all(a[k] == b[k] for k in keys)


# ---------------------------------------------------------------- background

class SnapshotWriter:
    """Optional background writer: serialization + disk IO run on one worker
    thread; the round loop only pays the device->host margin pull. Write
    failures are logged, remembered, and re-raised at :meth:`flush` — a
    full disk must not kill training mid-round, but it must not stay
    silent either."""

    def __init__(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="xtpu-ckpt")
        self._pending: List[Any] = []
        self._lock = threading.Lock()
        self.last_error: Optional[BaseException] = None

    def submit(self, directory: str, snap: TrainingSnapshot, name: str,
               keep: Optional[int]) -> None:
        def work() -> None:
            try:
                write_snapshot(directory, snap, name)
                if keep is not None:
                    prune_snapshots(directory, keep, name)
            except BaseException as e:  # noqa: BLE001 - surfaced at flush
                with self._lock:
                    self.last_error = e
                logger.warning("background snapshot write failed: %s", e)

        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(self._ex.submit(work))

    def flush(self, raise_errors: bool = False) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        if raise_errors:
            with self._lock:
                err, self.last_error = self.last_error, None
            if err is not None:
                raise SnapshotError(
                    f"a background snapshot write failed: {err}") from err

    def close(self, raise_errors: bool = False) -> None:
        """Flush pending writes and JOIN the worker thread. Always safe to
        call on an exception path (``raise_errors=False`` keeps a
        secondary disk failure from masking the original error); the
        normal-exit path passes ``raise_errors=True`` so a silently-failed
        final snapshot surfaces instead of leaving stale state behind."""
        try:
            self.flush(raise_errors=raise_errors)
        finally:
            self._ex.shutdown(wait=True)


# ------------------------------------------------------------------- manager

class CheckpointManager:
    """Train-loop side of the checkpoint protocol (used by ``core.train``).

    Responsibilities: compute the data fingerprint once, find the resume
    snapshot, write boundary snapshots (sync or background), prune old
    ones. (The JAX package's agreement on one round across ranks waits
    with the distributed tier, ROADMAP A.8.)"""

    def __init__(self, config: CheckpointConfig) -> None:
        self.config = config
        self.fingerprint: Optional[Dict[str, Any]] = None
        self._writer = SnapshotWriter() if config.background else None
        self.resumed_from: Optional[int] = None
        os.makedirs(config.directory, exist_ok=True)

    def ensure_fingerprint(self, dtrain: Any) -> Dict[str, Any]:
        if self.fingerprint is None:
            self.fingerprint = dmatrix_fingerprint(dtrain)
        return self.fingerprint

    # -- resume --------------------------------------------------------------
    def find_resume(self, dtrain: Any) -> Optional[TrainingSnapshot]:
        cfg = self.config
        self.ensure_fingerprint(dtrain)
        if cfg.resume not in ("auto", True):
            return None
        found = latest_valid_snapshot(cfg.directory, cfg.name,
                                      fingerprint=self.fingerprint)
        if found is None or found[0].round <= 0:
            return None
        snap = found[0]
        self.resumed_from = snap.round
        logger.info("auto-resume: continuing from snapshot round %d (%s)",
                    snap.round, cfg.directory)
        return snap

    # -- save ----------------------------------------------------------------
    def rounds_to_boundary(self, rounds_done: int) -> int:
        every = self.config.every_n_rounds
        return every - (rounds_done % every)

    def maybe_save(self, bst: Any, dtrain: Any, rounds_done: int,
                   force: bool = False) -> bool:
        if not force and rounds_done % self.config.every_n_rounds != 0:
            return False
        snap = bst.make_snapshot(dtrain, fingerprint=self.fingerprint,
                                 round_=rounds_done)
        cfg = self.config
        if cfg.extra:
            snap.extra.update(cfg.extra)
        if self._writer is not None:
            self._writer.submit(cfg.directory, snap, cfg.name, cfg.keep)
        else:
            write_snapshot(cfg.directory, snap, cfg.name)
            if cfg.keep is not None:
                prune_snapshots(cfg.directory, cfg.keep, cfg.name)
        return True

    def close(self, raise_errors: bool = False) -> None:
        if self._writer is not None:
            self._writer.close(raise_errors=raise_errors)
