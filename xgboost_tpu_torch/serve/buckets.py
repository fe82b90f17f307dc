"""Bucketed batch shapes.

Every device batch is padded to one of a small fixed set of row counts,
so the set of batch shapes the walk sees is ``len(ladder)`` per model:
the shapes a future CUDA-graph capture per bucket would need, and the
shapes ``Server.warmup`` runs once up front.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

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
