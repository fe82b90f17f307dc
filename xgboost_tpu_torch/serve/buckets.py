"""Bucketed batch shapes and the recompile counter.

Every device batch is padded to one of a small fixed set of row counts,
so the set of batch shapes the walk sees is ``len(ladder)`` per model:
``Server.warmup`` captures each (model version, bucket) walk as a CUDA
graph once up front (``serve/registry.py``), and every later batch
replays one. The contribs route has a ladder of its own
(``ServeConfig.shap_ladder``), whose buckets are prepared once each.

:class:`RecompileCounter` makes the "zero recompiles after warmup"
guarantee testable, as the JAX package's does over its jitted programs'
trace caches: it reads the captures made (graphs on the card, prepared
buckets on the CPU) and the contribs buckets prepared, so a capture after
warmup shows as a counted recompile instead of an unexplained latency
spike.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


class BucketLadder:
    """A sorted set of batch row counts every device dispatch pads to."""

    def __init__(self, sizes: Iterable[int]) -> None:
        uniq = sorted({int(s) for s in sizes})
        if not uniq:
            raise ValueError("bucket ladder needs at least one size")
        if uniq[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {uniq[0]}")
        self.sizes: Tuple[int, ...] = tuple(uniq)

    @classmethod
    def pow2(cls, max_batch: int) -> "BucketLadder":
        """Powers of two from 1 up to ``max_batch`` (always included):
        padded compute is bounded by 2x the real rows."""
        sizes = []
        b = 1
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(int(max_batch))
        return cls(sizes)

    @property
    def max_batch(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n_rows: int) -> int:
        """Smallest bucket >= n_rows; the top bucket for anything larger
        (oversize requests are chunked by :meth:`chunks`)."""
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        for s in self.sizes:
            if s >= n_rows:
                return s
        return self.sizes[-1]

    def chunks(self, n_rows: int) -> List[int]:
        """Split an arbitrary request size into per-dispatch row counts:
        full top buckets plus one remainder chunk."""
        out, top = [], self.sizes[-1]
        while n_rows > top:
            out.append(top)
            n_rows -= top
        out.append(n_rows)
        return out

    def pad(self, X: np.ndarray, bucket: int) -> np.ndarray:
        """Pad rows of ``X`` up to ``bucket`` with zeros. They never reach a
        result: pad rows are sliced off on the host, and the walk is
        row-independent."""
        n = X.shape[0]
        if n == bucket:
            return X
        if n > bucket:
            raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
        return np.concatenate(
            [X, np.zeros((bucket - n,) + X.shape[1:], X.dtype)])


class RecompileCounter:
    """Counts the serving path's preparations (the JAX package's
    ``RecompileCounter`` over ``_cache_size()``): each registered source
    has ``cache_size()``, the preparations it has made, which never
    decrease; ``mark()`` snapshots their sum after warmup and
    ``since_mark()`` is the SLO number, recompiles after warmup."""

    def __init__(self, fns: Sequence = ()) -> None:
        self._fns: List = []
        self._mark = 0
        for f in fns:
            self.register(f)

    @classmethod
    def for_forest_predictor(cls, registry) -> "RecompileCounter":
        """Counter over a server's serving programs: the walk graphs of
        every (model version, bucket) and the contribs route's prepared
        buckets, both kept by its ``ModelRegistry``."""
        return cls([registry])

    def register(self, fn) -> None:
        if not hasattr(fn, "cache_size"):
            raise TypeError(f"{fn!r} counts no preparations (no "
                            "cache_size)")
        self._fns.append(fn)

    def compiles(self) -> int:
        """The captures made."""
        return sum(int(f.cache_size()) for f in self._fns)

    def mark(self) -> None:
        self._mark = self.compiles()

    def absorb(self, n: int) -> None:
        """Fold ``n`` expected captures into the baseline (a hot-swapped
        model's warmup captures are planned work, not an SLO
        violation)."""
        self._mark += int(n)

    def since_mark(self) -> int:
        return max(0, self.compiles() - self._mark)
