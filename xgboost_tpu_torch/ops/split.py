"""Split evaluation over (node, feature, missing direction, bin).

The port of the JAX package's ``ops/split.py evaluate_splits`` for
numeric features (reference ``HistEvaluator::EnumerateSplit``): the
histogram carries an explicit missing slot per feature, so both missing
directions come from one cumulative sum, ``left = cumsum(present)`` for
missing-right and ``left + missing`` for missing-left. The best split of
each node is a flat argmax over (feature, direction, bin); ties go to the
lowest flat index. The cumulative sum runs in another order than XLA's,
so gains agree with the JAX package's to f32 rounding, not bit for bit.
Categorical features, monotone constraints and feature masks wait with
ROADMAP A.5.4-A.5.5 and A.5.2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree.param import TrainParam, _f32, calc_gain


class SplitResult(NamedTuple):
    gain: torch.Tensor          # [N] loss_chg of the best split (-inf if none)
    feature: torch.Tensor       # [N] int64
    bin: torch.Tensor           # [N] int64 local threshold bin (left if <=)
    default_left: torch.Tensor  # [N] bool, direction of missing values
    left_sum: torch.Tensor      # [N, 2]
    right_sum: torch.Tensor     # [N, 2]


def evaluate_splits(hist: torch.Tensor, parent_sum: torch.Tensor,
                    n_real_bins: torch.Tensor, param: TrainParam,
                    has_missing: bool = True) -> SplitResult:
    """hist [N, F, B, 2] with the missing mass in slot B-1 when
    ``has_missing``; parent_sum [N, 2]; n_real_bins [F] int64."""
    N, F, B, _ = hist.shape
    nb = B - 1 if has_missing else B                    # real-bin slots
    present = hist[:, :, :nb, :].movedim(3, 2)          # [N, F, 2, nb]
    cum = torch.cumsum(present, dim=3)                  # missing -> right
    n_dirs = 2 if has_missing else 1
    if has_missing:
        miss = hist[:, :, B - 1, :]                     # [N, F, 2]
        left = torch.stack([cum, cum + miss[:, :, :, None]], dim=2)
    else:
        left = cum[:, :, None]                          # [N, F, dirs, 2, nb]
    parent5 = parent_sum[:, None, None, :, None]
    right = parent5 - left
    bins_idx = torch.arange(nb, device=hist.device)
    base_valid = bins_idx[None, None, :] < n_real_bins[:, None, None]

    lg, lh = left[:, :, :, 0, :], left[:, :, :, 1, :]   # [N, F, dirs, nb]
    rg, rh = right[:, :, :, 0, :], right[:, :, :, 1, :]
    pgain = calc_gain(parent_sum[:, 0], parent_sum[:, 1], param)
    loss_chg = (calc_gain(lg, lh, param) + calc_gain(rg, rh, param)
                - pgain[:, None, None, None])
    mcw = _f32(param.min_child_weight)
    valid = base_valid[None] & (lh >= mcw) & (rh >= mcw)
    loss_chg = torch.where(valid, loss_chg,
                           torch.full_like(loss_chg, float("-inf")))

    flat = loss_chg.reshape(N, -1)
    best = torch.argmax(flat, dim=1)                    # first maximum
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    f_idx = torch.div(best, nb * n_dirs, rounding_mode="floor")
    rem = best % (nb * n_dirs)
    d_idx = torch.div(rem, nb, rounding_mode="floor")
    b_idx = rem % nb
    nn = torch.arange(N, device=hist.device)
    best_left = left[nn, f_idx, d_idx, :, b_idx]        # [N, 2]
    return SplitResult(gain=best_gain, feature=f_idx, bin=b_idx,
                       default_left=d_idx.bool(), left_sum=best_left,
                       right_sum=parent_sum - best_left)
