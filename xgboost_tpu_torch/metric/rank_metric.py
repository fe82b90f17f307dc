"""Ranking metrics ``ndcg@k``, ``map@k``, ``pre@k`` and ``ams@k`` on the
host in float64 (the JAX package's ``metric/rank_metric.py``; reference
``src/metric/rank_metric.cc``).

Each is a mean over queries (weighted by a query's weight when the
matrix has one weight a query), computed over all queries at once: one
lexsort by (query, -score) and per-query sums with ``bincount``. A
matrix without query groups is one query. ``name@k`` keeps the top k of
each query (all when k is 0 or absent); a ``-`` after k is accepted and,
as in the JAX package, changes nothing.
"""

from __future__ import annotations

import numpy as np

from .base import Metric, global_mean, register


class _TopKMetric(Metric):
    default_k = 0  # 0 = all

    @property
    def k(self) -> int:
        if self.param is None or self.param in ("", "-"):
            return self.default_k
        return int(str(self.param).rstrip("-"))

    def _scores(self, y, y_s, q_s, rank, k_g, G, qidx, ptr):
        """Per-query scores [G] from the labels in score order (``y_s``,
        ``q_s``, ``rank``: label, query and rank within the query of each
        row sorted by query, then score descending); ``qidx`` / ``ptr``:
        each row's query and the queries' offsets, in row order."""
        raise NotImplementedError

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels, dtype=np.float64).reshape(-1)
        s = np.asarray(preds, dtype=np.float64).reshape(-1)
        if info.group_ptr is None:
            ptr = np.asarray([0, len(y)], dtype=np.int64)
        else:
            ptr = np.asarray(info.group_ptr, dtype=np.int64)
        sizes = np.diff(ptr)
        G = len(sizes)
        qidx = np.repeat(np.arange(G), sizes)
        order = np.lexsort((-s, qidx))      # stable: by query, then -score
        y_s, q_s = y[order], qidx[order]
        rank = np.arange(len(y)) - ptr[:-1][q_s]
        kp = self.k
        k_g = sizes.astype(np.int64) if kp <= 0 \
            else np.minimum(kp, sizes).astype(np.int64)
        scores = self._scores(y, y_s, q_s, rank, k_g, G, qidx, ptr)
        w = info.weights
        if w is not None and len(w) == G:
            wq = np.asarray(w, np.float64)
        else:
            wq = np.ones(G)             # one weight a row: no query weights
        ok = sizes > 0
        total = float(np.sum(scores[ok] * wq[ok]))
        wsum = float(np.sum(wq[ok]))
        return global_mean(total, wsum, info)


def _grouped_dcg(y_vals, q_s, rank, k_g, G):
    """Sum of gain / discount over each query's top k (gain 2^y - 1)."""
    in_k = rank < k_g[q_s]
    terms = np.where(in_k, (np.power(2.0, y_vals) - 1.0)
                     / np.log2(rank + 2.0), 0.0)
    return np.bincount(q_s, weights=terms, minlength=G)


@register("ndcg")
class NDCG(_TopKMetric):
    name = "ndcg"

    def _scores(self, y, y_s, q_s, rank, k_g, G, qidx, ptr):
        dcg = _grouped_dcg(y_s, q_s, rank, k_g, G)
        # the ideal order, (query, -label): the queries keep their rows, so
        # q_s and rank hold for it too
        order_y = np.lexsort((-y, qidx))
        ideal = _grouped_dcg(y[order_y], q_s, rank, k_g, G)
        # a query with no relevant document scores 1, as the reference's
        return np.where(ideal > 0, dcg / np.maximum(ideal, 1e-300), 1.0)


@register("map")
class MAP(_TopKMetric):
    name = "map"

    def _scores(self, y, y_s, q_s, rank, k_g, G, qidx, ptr):
        rel = (y_s > 0).astype(np.float64)
        if len(rel) == 0:
            return np.ones(G)
        cum = np.cumsum(rel)
        starts = ptr[:-1]
        base = np.where(starts > 0,
                        cum[np.minimum(np.maximum(starts, 1) - 1,
                                       len(cum) - 1)], 0.0)
        hits = cum - base[q_s]              # relevant so far in the query
        contrib = np.where((rel > 0) & (rank < k_g[q_s]),
                           hits / (rank + 1.0), 0.0)
        ap = np.bincount(q_s, weights=contrib, minlength=G)
        n_rel = np.bincount(q_s, weights=rel, minlength=G)
        # an empty query has k_g = 0: the denominator stays >= 1
        denom = np.maximum(np.minimum(np.maximum(n_rel, 1.0), k_g), 1.0)
        return np.where(n_rel > 0, ap / denom, 1.0)


@register("pre")
class PrecisionAt(_TopKMetric):
    name = "pre"

    def _scores(self, y, y_s, q_s, rank, k_g, G, qidx, ptr):
        hits = np.bincount(
            q_s, weights=np.where(rank < k_g[q_s], (y_s > 0) * 1.0, 0.0),
            minlength=G)
        return np.where(k_g > 0, hits / np.maximum(k_g, 1), 0.0)


@register("ams")
class AMS(Metric):
    """Approximate median significance over the top ``ratio`` of the rows
    by score (``ams@0.15``, the default; reference ``EvalAMS``)."""

    name = "ams"

    def __call__(self, preds, info) -> float:
        ratio = float(self.param) if self.param is not None else 0.15
        y = np.asarray(info.labels, dtype=np.float64).reshape(-1)
        p = np.asarray(preds, dtype=np.float64).reshape(-1)
        w = self.weights_of(info, len(y))
        order = np.argsort(-p, kind="stable")
        ntop = max(1, int(ratio * len(y)))
        sel = order[:ntop]
        s = float(np.sum(w[sel] * (y[sel] > 0.5)))
        b = float(np.sum(w[sel] * (y[sel] <= 0.5)))
        br = 10.0
        return float(np.sqrt(2.0 * ((s + b + br)
                                    * np.log(1.0 + s / (b + br)) - s)))
