"""``auc`` and ``aucpr`` on the host in float64 (the JAX package's
``metric/auc.py``; reference ``src/metric/auc.cc``).

Binary: the area under the ROC (or precision-recall) curve from one
stable sort by score, rows of equal score taken together (the trapezoid
over each run of ties), with row weights. Multiclass: one class against
the rest, each class's area weighted by its rows' weight. A matrix with
more than one query group: the mean of the queries' own areas, over the
queries that have two rows or more and both classes (``aucpr``: a
relevant row), unweighted, as the reference's ranking AUC. One process:
the JAX package's distributed tiers (the gather of every row, the merge
of local curves) wait with ROADMAP A.8.
"""

from __future__ import annotations

import numpy as np

from .base import Metric, global_mean, register


def _roc_curve_area(labels, preds, weights):
    """(unnormalised area, total positive weight * total negative)."""
    if len(labels) == 0:
        return 0.0, 0.0
    order = np.argsort(-preds, kind="stable")
    y, p, w = labels[order], preds[order], weights[order]
    pos_w = np.where(y > 0.5, w, 0.0)
    neg_w = np.where(y > 0.5, 0.0, w)
    cum_pos = np.cumsum(pos_w)
    cum_neg = np.cumsum(neg_w)
    total_pos, total_neg = cum_pos[-1], cum_neg[-1]
    if total_pos <= 0 or total_neg <= 0:
        return 0.0, 0.0
    # one trapezoid a distinct score
    boundary = np.concatenate([p[1:] != p[:-1], [True]])
    tp = cum_pos[boundary]
    fp = cum_neg[boundary]
    tp0 = np.concatenate([[0.0], tp[:-1]])
    fp0 = np.concatenate([[0.0], fp[:-1]])
    area = np.sum((fp - fp0) * (tp + tp0) / 2.0)
    return float(area), float(total_pos * total_neg)


def binary_roc_auc(labels: np.ndarray, preds: np.ndarray,
                   weights: np.ndarray) -> float:
    area, norm = _roc_curve_area(labels, preds, weights)
    return float(area / norm) if norm > 0 else float("nan")


def _pr_curve_area(labels, preds, weights):
    """(area scaled by the total positive weight, that weight)."""
    if len(labels) == 0:
        return 0.0, 0.0
    order = np.argsort(-preds, kind="stable")
    y, p, w = labels[order], preds[order], weights[order]
    pos_w = np.where(y > 0.5, w, 0.0)
    neg_w = np.where(y > 0.5, 0.0, w)
    cum_pos = np.cumsum(pos_w)
    cum_neg = np.cumsum(neg_w)
    total_pos = cum_pos[-1]
    if total_pos <= 0:
        return 0.0, 0.0
    boundary = np.concatenate([p[1:] != p[:-1], [True]])
    tp = cum_pos[boundary]
    fp = cum_neg[boundary]
    prec = tp / np.maximum(tp + fp, 1e-16)
    tp0 = np.concatenate([[0.0], tp[:-1]])
    return float(np.sum((tp - tp0) * prec)), float(total_pos)


def binary_pr_auc(labels: np.ndarray, preds: np.ndarray,
                  weights: np.ndarray) -> float:
    area, norm = _pr_curve_area(labels, preds, weights)
    return float(area / norm) if norm > 0 else float("nan")


def _grouped_auc(y: np.ndarray, p: np.ndarray, ptr: np.ndarray, kind: str):
    """(sum of the valid queries' areas, their count) over all queries at
    once: one lexsort by (query, -score) and per-query cumulative sums;
    the same areas as :func:`binary_roc_auc` / :func:`binary_pr_auc` with
    unit weights."""
    sizes = np.diff(ptr)
    G = len(sizes)
    n = len(y)
    qidx = np.repeat(np.arange(G), sizes)
    order = np.lexsort((-p, qidx))
    y_s, p_s, q_s = y[order], p[order], qidx[order]
    pos = (y_s > 0.5).astype(np.float64)
    cp, cn = np.cumsum(pos), np.cumsum(1.0 - pos)
    starts = np.asarray(ptr[:-1], np.int64)
    ends = np.asarray(ptr[1:], np.int64)
    base_p = np.where(starts > 0, cp[starts - 1], 0.0)
    base_n = np.where(starts > 0, cn[starts - 1], 0.0)
    tp_row = cp - base_p[q_s]
    fp_row = cn - base_n[q_s]
    nonempty = sizes > 0
    tot_p = np.zeros(G)
    tot_n = np.zeros(G)
    tot_p[nonempty] = tp_row[ends[nonempty] - 1]
    tot_n[nonempty] = fp_row[ends[nonempty] - 1]
    if n == 0:
        return 0.0, 0.0
    boundary = np.empty(n, bool)
    boundary[:-1] = (p_s[1:] != p_s[:-1]) | (q_s[1:] != q_s[:-1])
    boundary[-1] = True
    b_idx = np.nonzero(boundary)[0]
    b_q = q_s[b_idx]
    tp_b, fp_b = tp_row[b_idx], fp_row[b_idx]
    first_b = np.empty(len(b_idx), bool)
    first_b[0] = True
    first_b[1:] = b_q[1:] != b_q[:-1]
    tp0 = np.where(first_b, 0.0, np.concatenate([[0.0], tp_b[:-1]]))
    fp0 = np.where(first_b, 0.0, np.concatenate([[0.0], fp_b[:-1]]))
    if kind == "roc":
        terms = (fp_b - fp0) * (tp_b + tp0) / 2.0
        norm = tot_p * tot_n
        valid = (sizes >= 2) & (tot_p > 0) & (tot_n > 0)
    else:
        prec = tp_b / np.maximum(tp_b + fp_b, 1e-16)
        terms = (tp_b - tp0) * prec
        norm = tot_p
        valid = (sizes >= 2) & (tot_p > 0)
    area = np.bincount(b_q, weights=terms, minlength=G)
    auc_q = area[valid] / norm[valid]
    return float(np.sum(auc_q)), float(np.count_nonzero(valid))


class _AucBase(Metric):
    _fn = staticmethod(binary_roc_auc)
    _grouped_kind = "roc"

    def __call__(self, preds, info) -> float:
        y = np.asarray(info.labels, dtype=np.float64).reshape(-1)
        p = np.asarray(preds, dtype=np.float64)
        w = self.weights_of(info, len(y))
        ptr = getattr(info, "group_ptr", None)
        if ptr is not None and len(ptr) > 2:
            total, valid = _grouped_auc(
                y, p.reshape(-1), np.asarray(ptr, np.int64),
                self._grouped_kind)
            return global_mean(total, valid, info)
        if p.ndim == 2 and p.shape[1] > 1:
            # one class against the rest, weighted by the class's weight
            total, wsum = 0.0, 0.0
            for c in range(p.shape[1]):
                a = self._fn((y == c).astype(np.float64), p[:, c], w)
                cw = np.sum(w[y == c])
                if not np.isnan(a):
                    total += a * cw
                    wsum += cw
            return float(total / wsum) if wsum > 0 else float("nan")
        return self._fn(y, p.reshape(-1), w)


@register("auc")
class AUC(_AucBase):
    name = "auc"
    _fn = staticmethod(binary_roc_auc)


@register("aucpr")
class AUCPR(_AucBase):
    name = "aucpr"
    _fn = staticmethod(binary_pr_auc)
    _grouped_kind = "pr"
