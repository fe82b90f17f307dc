"""Durable append-only page log — the pipeline's source of truth.

Fresh rows enter the system here FIRST; everything downstream (the
training matrix, snapshots, promoted artifacts) is a deterministic
function of this log, which is what makes ``kill -9`` anywhere in the
loop recoverable: replaying the same durable prefix reproduces the
same models byte-for-byte. A page is the JAX package's page, byte for
byte, so either package reads the other's log.

Each page is one UBJSON record (``page_NNNNNN.ubj``) written with the
checkpoint module's atomic discipline — tmp + fsync + ``os.replace``
for the data file, then a CRC32 sidecar. Data lands BEFORE sidecar, so
a crash between the two leaves a record :meth:`PageLog.count` refuses
to count (stale/missing sidecar) rather than one it trusts; the next
``append`` simply rewrites that slot. Reads retry transient failures
through the shared ``_retry_io`` backoff (flaky network filesystems
must not kill a long-lived loop) and raise a typed
:class:`~.errors.PageCorrupt` on integrity failure.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..utils.checkpoint import _atomic_write, _crc_path
from .errors import PageCorrupt

PAGE_FORMAT = "xgboost_tpu.page"
PAGE_VERSION = 1


def _page_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"page_{index:06d}.ubj")


class PageLog:
    """Append-only log of (X, y[, w]) row pages under ``directory``."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # chaos hook: called before every raw read; the fault plan wires
        # a transient-failure injector here (retried via _retry_io)
        self.read_fault: Optional[Callable[[int], None]] = None

    # -- write ---------------------------------------------------------------
    def append(self, X, y=None, weight=None) -> int:
        """Durably append one page; returns its index. The index is the
        current durable count, so an append that re-runs after a crash
        between data and sidecar write OVERWRITES the torn slot instead
        of leaving a gap."""
        from ..utils.ubjson import dumps_ubjson

        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2:
            raise ValueError(f"expected [rows, features], got {X.shape}")
        obj: Dict[str, object] = {
            "format": PAGE_FORMAT, "version": PAGE_VERSION,
            "n_rows": int(X.shape[0]), "n_cols": int(X.shape[1]),
            "X": X.reshape(-1),
            "y": (None if y is None
                  else np.ascontiguousarray(np.asarray(y, np.float32))),
            "w": (None if weight is None
                  else np.ascontiguousarray(np.asarray(weight, np.float32))),
        }
        payload = dumps_ubjson(obj)
        index = self.count()
        path = _page_path(self.directory, index)
        _atomic_write(path, payload)
        _atomic_write(_crc_path(path),
                      f"{zlib.crc32(payload):08x} {len(payload)}\n".encode())
        return index

    # -- read ----------------------------------------------------------------
    def count(self) -> int:
        """Length of the contiguous DURABLE prefix: pages 0..count-1 all
        have data + valid-looking sidecar on disk. A record past a gap
        (possible only through manual tampering — appends are
        sequential) is ignored, so every consumer sees one well-defined
        prefix of history."""
        pat = re.compile(r"page_(\d+)\.ubj$")
        present = set()
        try:
            for fn in os.listdir(self.directory):
                m = pat.match(fn)
                if m and os.path.exists(
                        _crc_path(os.path.join(self.directory, fn))):
                    present.add(int(m.group(1)))
        except OSError:
            return 0
        n = 0
        while n in present:
            n += 1
        return n

    def read(self, index: int) -> Dict[str, Optional[np.ndarray]]:
        """Load + CRC-validate one page -> ``{"X", "y", "w"}`` (y/w may be
        None). Transient read failures retry with backoff."""
        from ..data.dmatrix import _retry_io

        return _retry_io(lambda: self._read_once(index),
                         f"page log read [{index}]")

    def _read_once(self, index: int) -> Dict[str, Optional[np.ndarray]]:
        from ..utils.ubjson import loads_ubjson

        if self.read_fault is not None:
            self.read_fault(index)
        path = _page_path(self.directory, index)
        try:
            with open(path, "rb") as fh:
                payload = fh.read()
            with open(_crc_path(path)) as fh:
                want_crc, want_len = fh.read().split()
        except (OSError, ValueError) as e:
            raise PageCorrupt(
                f"page {index} is missing or has no valid sidecar "
                f"({e}); the durable prefix ends before it") from e
        if len(payload) != int(want_len) \
                or zlib.crc32(payload) != int(want_crc, 16):
            raise PageCorrupt(
                f"page {index} failed CRC validation (truncated or "
                "corrupted write); re-ingest it")
        try:
            obj = loads_ubjson(payload)
            if obj.get("format") != PAGE_FORMAT:
                raise ValueError("not a page record")
            X = np.asarray(obj["X"], np.float32).reshape(
                int(obj["n_rows"]), int(obj["n_cols"]))
            y = obj.get("y")
            w = obj.get("w")
            return {"X": X,
                    "y": None if y is None else np.asarray(y, np.float32),
                    "w": None if w is None else np.asarray(w, np.float32)}
        except PageCorrupt:
            raise
        except Exception as e:
            raise PageCorrupt(
                f"page {index} failed to parse: {e}") from e

    def pages(self) -> Iterator[Dict[str, Optional[np.ndarray]]]:
        for i in range(self.count()):
            yield self.read(i)
