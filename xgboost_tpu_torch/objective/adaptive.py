"""Adaptive-leaf objectives: ``reg:absoluteerror`` and
``reg:quantileerror`` (the JAX package's ``objective/adaptive.py``;
reference ``src/objective/adaptive.{h,cc}``, ``quantile_obj.cu``).

A tree is grown on surrogate gradients (the sign of the residual, or
the pinball loss's slope, with unit hessians); then each leaf's value
becomes ``eta`` times the alpha-quantile of the residuals
``label - margin`` of the rows the tree puts in that leaf, weighted
when the matrix has weights (``boosting/gbtree.py`` calls
:meth:`_AdaptiveBase.refresh_leaves` after each tree).

The quantiles are float64 on the matrix's device: one sort of the rows
by (leaf, residual) and one gather a leaf (:func:`segment_quantiles`),
the JAX package's ``_weighted_quantile`` segment by segment: type-7
interpolation without weights, the first row whose running weight
reaches ``alpha`` of the leaf's total with them. Each step is its own
elementwise op (no fused multiply-add), so the unweighted quantile is
the same bits on either device; the weighted running sums add in row
order on the CPU (numpy's order) and in a scan's order on the card.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .base import ObjInfo, Objective, register

# elements of one padded [leaves, rows] block of the weighted running
# sums (f64: 512 MiB)
WEIGHTED_BLOCK_ELEMENTS = 1 << 26


def parse_alphas(a: Any) -> List[float]:
    """``quantile_alpha`` as the JAX package reads it: a list, a scalar,
    or the string a saved model holds (``"[0.05, 0.5, 0.95]"``)."""
    if isinstance(a, (list, tuple)):
        return [float(x) for x in a]
    if isinstance(a, str) and "," in a:
        return [float(x) for x in a.strip("[]()").split(",")]
    if isinstance(a, str):
        return [float(a.strip("[]()"))]
    return [float(a)]


def _segment_running_sums(w: torch.Tensor, seg: torch.Tensor,
                          col: torch.Tensor, counts: List[int]
                          ) -> torch.Tensor:
    """Each segment's running sums of ``w`` (rows grouped by segment,
    ``seg`` / ``col`` each row's segment and place in it), every segment
    summed from its own first row: ``torch.cumsum`` over padded
    [segments, longest] blocks of at most ``WEIGHTED_BLOCK_ELEMENTS``."""
    out = torch.empty_like(w)
    L = len(counts)
    i = 0
    while i < L:
        j, longest = i + 1, max(counts[i], 1)
        while j < L and (j + 1 - i) * max(longest, counts[j]) \
                <= WEIGHTED_BLOCK_ELEMENTS:
            longest = max(longest, counts[j])
            j += 1
        rows = (seg >= i) & (seg < j)
        block = torch.zeros((j - i, longest), dtype=w.dtype,
                            device=w.device)
        s, c = seg[rows] - i, col[rows]
        block[s, c] = w[rows]
        out[rows] = block.cumsum(dim=1)[s, c]
        i = j
    return out


def segment_quantiles(positions: torch.Tensor, residuals: torch.Tensor,
                      weights: Optional[torch.Tensor], leaves: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """The alpha-quantile [L] (float64) of ``residuals`` [n] (float64)
    over the rows of each of ``leaves`` [L] (ascending node ids), the
    rows' nodes in ``positions`` [n]; 0 for a leaf no row reaches
    (the JAX package's ``segment_quantiles`` before its f32 cast)."""
    dev = residuals.device
    f64 = torch.float64
    n = residuals.shape[0]
    if n == 0:
        return torch.zeros(leaves.shape[0], dtype=f64, device=dev)
    # rows by (leaf, residual, row): a stable sort by residual, then a
    # stable sort by leaf
    o1 = torch.sort(residuals, stable=True).indices
    pos1 = positions[o1]
    o2 = torch.sort(pos1, stable=True).indices
    order = o1[o2]
    pos_s = pos1[o2].contiguous()
    v = residuals[order]
    leaves = leaves.to(pos_s.dtype)
    start = torch.searchsorted(pos_s, leaves, right=False)
    count = torch.searchsorted(pos_s, leaves, right=True) - start
    last = torch.clamp(count - 1, min=0)
    # an empty leaf reads row 0 (and gives 0)
    start = torch.where(count > 0, start, torch.zeros_like(start))
    if weights is None:
        idx = alpha * last.to(f64)
        lo = torch.floor(idx)
        frac = idx - lo
        lo = lo.to(torch.int64)
        hi = torch.minimum(lo + 1, last)
        val = v[start + lo] * (1.0 - frac) + v[start + hi] * frac
    else:
        w = weights.to(f64)[order]
        seg = torch.searchsorted(leaves, pos_s, right=False)
        seg = torch.clamp(seg, max=leaves.shape[0] - 1)
        col = torch.arange(n, device=dev) - start[seg]
        cw = _segment_running_sums(w, seg, col, count.cpu().tolist())
        total = cw[start + last]
        t = alpha * total
        below = (cw < t[seg]).to(torch.int64)
        first = torch.zeros_like(count).index_add_(0, seg, below)
        val = v[start + torch.minimum(first, last)]
    return torch.where(count > 0, val, torch.zeros_like(val))


def weighted_quantile(values: torch.Tensor,
                      weights: Optional[torch.Tensor],
                      alpha: float) -> float:
    """The alpha-quantile of all of ``values`` (the JAX package's
    ``_weighted_quantile``), as a float64."""
    if values.shape[0] == 0:
        return 0.0
    pos = torch.zeros(values.shape[0], dtype=torch.int64,
                      device=values.device)
    leaves = torch.zeros(1, dtype=torch.int64, device=values.device)
    return float(segment_quantiles(pos, values.to(torch.float64), weights,
                                   leaves, alpha)[0])


class _AdaptiveBase(Objective):
    info = ObjInfo("regression", zero_hess=True)
    _alpha = 0.5

    def alphas(self) -> List[float]:
        return [self._alpha]

    def refresh_leaves(self, tree, positions: torch.Tensor,
                       margin: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor], eta: float,
                       alpha: float) -> torch.Tensor:
        """Replace the leaves of ``tree`` (host ``TreeModel``) by ``eta *
        quantile_alpha(label - margin)`` over their rows (the JAX
        package's ``update_tree_leaf``): ``positions`` [n] the rows'
        compact node ids, ``margin`` [n] the margin before the round,
        ``labels`` [n]. Returns the new leaf values [n_nodes] f32 on the
        rows' device, for the round's margin delta."""
        dev = positions.device
        residual = labels.to(torch.float64) - margin.to(torch.float64)
        leaves_np = np.nonzero(tree.is_leaf)[0]
        leaves = torch.from_numpy(leaves_np).to(dev)
        q = segment_quantiles(positions, residual, weights, leaves, alpha)
        new = q.to(torch.float32) * float(np.float32(eta))
        values = torch.from_numpy(tree.leaf_value.copy()).to(dev)
        values[leaves] = new
        tree.leaf_value = values.cpu().numpy()
        return values

    def _quantiles_of_labels(self, labels: torch.Tensor,
                             weights: Optional[torch.Tensor],
                             alphas: List[float]) -> np.ndarray:
        y = labels.reshape(-1)
        return np.asarray([weighted_quantile(y, weights, a) for a in alphas],
                          dtype=np.float32)


def label_matrix_refusal(name: str) -> str:
    return (f"{name} does not train on a label matrix [n, K] in the "
            "PyTorch port: the JAX package's leaf refresh flattens the "
            "labels and fails, and upstream fits one leaf quantile a "
            "target (ROADMAP C); train one model a target")


@register("reg:absoluteerror")
class AbsoluteError(_AdaptiveBase):
    name = "reg:absoluteerror"
    default_metric = "mae"
    _alpha = 0.5                # the median

    def gradient(self, preds, labels, iteration=0):
        return torch.stack([torch.sign(preds - labels),
                            torch.ones_like(preds)], dim=-1)

    def init_estimation(self, labels, weights=None, **inputs):
        return self._quantiles_of_labels(labels, weights, [0.5])


@register("reg:quantileerror")
class QuantileError(_AdaptiveBase):
    """The pinball loss at each of ``quantile_alpha``'s alphas: one output
    group an alpha over a 1-D label (reference ``quantile_obj.cu``)."""

    name = "reg:quantileerror"
    default_metric = "quantile"

    def alphas(self) -> List[float]:
        return parse_alphas(self.params.get("quantile_alpha", 0.5))

    def n_targets(self, info=None) -> int:
        return len(self.alphas())

    def gradient(self, preds, labels, iteration=0):
        alphas = torch.tensor(self.alphas(), dtype=torch.float32,
                              device=preds.device)
        if labels.shape[1] != preds.shape[1]:
            labels = labels[:, :1].expand(preds.shape)
        err = labels - preds            # > 0 when under-predicting
        g = torch.where(err >= 0, (-alphas)[None, :].expand(preds.shape),
                        (1.0 - alphas)[None, :].expand(preds.shape))
        return torch.stack([g, torch.ones_like(preds)], dim=-1)

    def init_estimation(self, labels, weights=None, **inputs):
        return self._quantiles_of_labels(labels, weights, self.alphas())
