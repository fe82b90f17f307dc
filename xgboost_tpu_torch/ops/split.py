"""Split evaluation over (node, feature, missing direction, bin).

The port of the JAX package's ``ops/split.py evaluate_splits`` for
numeric features (reference ``HistEvaluator::EnumerateSplit``): the
histogram carries an explicit missing slot per feature, so both missing
directions come from one cumulative sum, ``left = cumsum(present)`` for
missing-right and ``left + missing`` for missing-left. The best split of
each node is a flat argmax over (feature, direction, bin); ties go to the
lowest flat index. The cumulative sum runs in another order than XLA's,
so gains agree with the JAX package's to f32 rounding, not bit for bit.
A feature mask (column sampling, interaction constraints) takes
features out of the search. Monotone constraints score a split by its
children's weights clipped into the node's interval and refuse one whose
weights break the feature's sign.

Categorical features (:class:`CatInfo`; bin == category code) take the
same dense [node, feature, direction, bin] gain tensor with other left
sums (reference ``EnumerateOneHot`` / ``EnumeratePart``): **one-hot**
(at most ``max_cat_to_onehot`` categories) sends one category right and
the rest left, missing with the default direction; **sorted partition**
orders the categories by ``g / (h + lambda + 1e-10)`` (a stable sort,
empty categories last) and scores every prefix of at most
``max_cat_threshold`` categories as the left set. The winner's left set
is packed into ``(nb - 1) // 32 + 1`` uint32 words, held as int64
tensors (:func:`pack_mask`).

Also the pieces of the two-level coarse -> refine search (the JAX
package's ``ops/split.py:286-424``, ``hist_method`` ``coarse``, ``fused``
and ``scan``): a 20-slot coarse histogram over ``bins >> 4``, a refine
window of two coarse spans per (node, feature) chosen from the coarse
boundary gains, and an exact ``evaluate_splits`` over a synthetic layout
that keeps every coarse boundary and every in-window fine boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tree.param import (TrainParam, _f32, calc_gain,
                          calc_gain_given_weight, calc_weight)
from .xla_order import cumsum_in_xla_order, sum_in_xla_order


class CatInfo(NamedTuple):
    """Categorical features: is_cat [F] bool, and is_onehot [F] bool for
    those with at most ``max_cat_to_onehot`` categories."""

    is_cat: torch.Tensor
    is_onehot: torch.Tensor


class SplitResult(NamedTuple):
    gain: torch.Tensor          # [N] loss_chg of the best split (-inf if none)
    feature: torch.Tensor       # [N] int64
    bin: torch.Tensor           # [N] int64 local threshold bin (left if <=)
    default_left: torch.Tensor  # [N] bool, direction of missing values
    left_sum: torch.Tensor      # [N, 2]
    right_sum: torch.Tensor     # [N, 2]
    # with a CatInfo only: a categorical split won, and its left set as
    # [N, W] uint32 words held in int64
    is_cat: Optional[torch.Tensor] = None
    cat_words: Optional[torch.Tensor] = None


def pack_mask(mask: torch.Tensor, n_words: int) -> torch.Tensor:
    """[N, nb] bool -> [N, W] int64 holding little-endian uint32 words
    (bit b of word w is entry 32 w + b)."""
    N, nb = mask.shape
    pad = n_words * 32 - nb
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    bits = mask.reshape(N, n_words, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (bits << shifts).sum(dim=2)


def bin_prefix_sums(hist: torch.Tensor) -> torch.Tensor:
    """hist [N, F, nb, 2] f32 -> its prefix sums over the bins as
    [N, F, 2, nb] f32: each (node, feature, component) summed in bin
    order in float64, each sum rounded to f32 once. That is the CPU's
    own ``cumsum`` of f32 (a float64 accumulator), and on the card the
    scan of an axis that is not the innermost one runs in the same order:
    CUDA's scan of an innermost axis splits each row among a number of
    threads chosen from the count of rows, so the same node's sums would
    round otherwise in a tensor of more nodes, and an f32 accumulator in
    bin order drifts from the CPU's by up to a rounding a bin. So a level
    searched at the ``mega`` schedule's padded capacity
    (``tree/grow.py``) gives the unpadded level's bits, and the card's
    sums are the CPU's. (With the bins outermost the scan's threads read
    neighbouring addresses, but then a level of up to 128 nodes fills at
    most 14 blocks: twice the device time on the card.)"""
    return torch.cumsum(hist.to(torch.float64), dim=2).to(
        torch.float32).movedim(3, 2)


def evaluate_splits(hist: torch.Tensor, parent_sum: torch.Tensor,
                    n_real_bins: torch.Tensor, param: TrainParam,
                    has_missing: bool = True,
                    feature_mask: Optional[torch.Tensor] = None,
                    cat: Optional[CatInfo] = None,
                    monotone: Optional[torch.Tensor] = None,
                    node_lower: Optional[torch.Tensor] = None,
                    node_upper: Optional[torch.Tensor] = None
                    ) -> SplitResult:
    """hist [N, F, B, 2] with the missing mass in slot B-1 when
    ``has_missing``; parent_sum [N, 2]; n_real_bins [F] int64;
    feature_mask [F] or [N, F] bool, True where a feature may split (the
    sampled columns, and the interaction constraints); ``cat``: the
    categorical features (module docstring).

    ``monotone`` [F] int in {-1, 0, 1} with ``node_lower`` /
    ``node_upper`` [N] f32, each node's weight interval: the children's
    weights are clipped into their node's interval, the gains come from
    ``calc_gain_given_weight`` of those weights, and a split whose
    weights move against its feature's sign is invalid (reference
    ``TreeEvaluator``, the JAX package's ``ops/split.py:138-162``)."""
    N, F, B, _ = hist.shape
    nb = B - 1 if has_missing else B                    # real-bin slots
    present = hist[:, :, :nb, :].movedim(3, 2)          # [N, F, 2, nb]
    cum = bin_prefix_sums(hist[:, :, :nb, :])           # missing -> right
    n_dirs = 2 if has_missing else 1
    if has_missing:
        miss = hist[:, :, B - 1, :]                     # [N, F, 2]
        left = torch.stack([cum, cum + miss[:, :, :, None]], dim=2)
    else:
        miss = torch.zeros_like(hist[:, :, 0, :])
        left = cum[:, :, None]                          # [N, F, dirs, 2, nb]
    parent5 = parent_sum[:, None, None, :, None]
    bins_idx = torch.arange(nb, device=hist.device)
    base_valid = bins_idx[None, None, :] < n_real_bins[:, None, None]
    if cat is not None:
        left, base_valid, ranks = _categorical_left(
            present, miss, parent5, left, base_valid, bins_idx, cat, param,
            n_dirs)
    right = parent5 - left

    lg, lh = left[:, :, :, 0, :], left[:, :, :, 1, :]   # [N, F, dirs, nb]
    rg, rh = right[:, :, :, 0, :], right[:, :, :, 1, :]
    mcw = _f32(param.min_child_weight)
    valid = base_valid[None] & (lh >= mcw) & (rh >= mcw)
    if monotone is None:
        pgain = calc_gain(parent_sum[:, 0], parent_sum[:, 1], param)
        loss_chg = (calc_gain(lg, lh, param) + calc_gain(rg, rh, param)
                    - pgain[:, None, None, None])
    else:
        lo = node_lower[:, None, None, None]
        hi = node_upper[:, None, None, None]
        wl = torch.clamp(calc_weight(lg, lh, param), lo, hi)
        wr = torch.clamp(calc_weight(rg, rh, param), lo, hi)
        wp = torch.clamp(calc_weight(parent_sum[:, 0], parent_sum[:, 1],
                                     param), node_lower, node_upper)
        pgain = calc_gain_given_weight(parent_sum[:, 0], parent_sum[:, 1],
                                       wp, param)
        loss_chg = (calc_gain_given_weight(lg, lh, wl, param)
                    + calc_gain_given_weight(rg, rh, wr, param)
                    - pgain[:, None, None, None])
        mc = monotone.to(torch.float32)[None, :, None, None]
        valid = valid & ((mc == 0) | (mc * (wr - wl) >= 0))
    if feature_mask is not None:
        fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
        valid = valid & fm[:, :, None, None]
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
    res = SplitResult(gain=best_gain, feature=f_idx, bin=b_idx,
                      default_left=d_idx.bool(), left_sum=best_left,
                      right_sum=parent_sum - best_left)
    if cat is None:
        return res
    chosen_cat = cat.is_cat[f_idx]
    # the left set over the winning feature's real bins: every category
    # but the one sent right (one-hot), or the sorted prefix up to the
    # winning bin (partition)
    real = bins_idx[None, :] < n_real_bins[f_idx][:, None]        # [N, nb]
    oh_mask = (bins_idx[None, :] != b_idx[:, None]) & real
    sort_mask = (ranks[nn, f_idx] <= b_idx[:, None]) & real
    mask = torch.where(cat.is_onehot[f_idx][:, None], oh_mask, sort_mask) \
        & chosen_cat[:, None]
    return res._replace(is_cat=chosen_cat,
                        cat_words=pack_mask(mask, (nb - 1) // 32 + 1))


def _categorical_left(present, miss, parent5, left, base_valid, bins_idx,
                      cat: CatInfo, param: TrainParam, n_dirs: int):
    """The left sums and validity of :func:`evaluate_splits` with the
    categorical features' (one-hot and sorted partition) in place of the
    numeric ones, and the partition ranks [N, F, nb] (each category's
    place in its node's order)."""
    g, h = present[:, :, 0], present[:, :, 1]           # [N, F, nb]
    # the JAX package's f32 expression, in its order: g / ((h + lambda)
    # + 1e-10); empty categories sort last, ties keep the category order
    ratio = g / (h + _f32(param.reg_lambda) + _f32(1e-10))
    ratio = torch.where(h <= 0.0, torch.full_like(ratio, float("inf")),
                        ratio)
    order = torch.argsort(ratio, dim=2, stable=True)
    ranks = torch.empty_like(order).scatter_(
        2, order, torch.arange(order.shape[2], device=order.device)
        .expand_as(order).contiguous())
    sorted_hist = torch.gather(present, 3, order[:, :, None, :].expand(
        -1, -1, 2, -1))
    cums = torch.cumsum(sorted_hist, dim=3)
    left_sorted = torch.stack([cums, cums + miss[:, :, :, None]][:n_dirs],
                              dim=2)
    # one-hot: the category goes right; missing goes with the default
    # direction (dir 0 right: parent - miss - present; dir 1 left)
    present5 = present[:, :, None]
    miss5 = miss[:, :, None, :, None]
    left_oh = torch.cat([parent5 - miss5 - present5,
                         parent5 - present5][:n_dirs], dim=2)
    ic5 = cat.is_cat[None, :, None, None, None]
    oh5 = cat.is_onehot[None, :, None, None, None]
    left = torch.where(ic5, torch.where(oh5, left_oh, left_sorted), left)
    # a sorted prefix holds at most max_cat_threshold categories
    # (base_valid is [F, 1, nb])
    cat_valid = torch.where(cat.is_onehot[:, None, None], base_valid,
                            base_valid & (bins_idx < param.max_cat_threshold))
    base_valid = torch.where(cat.is_cat[:, None, None], cat_valid,
                             base_valid)
    return left, base_valid, ranks


class MultiSplitResult(NamedTuple):
    """The best split of each node of a vector-leaf tree: one split for
    all K targets."""

    gain: torch.Tensor          # [N] loss_chg summed over the targets
    feature: torch.Tensor       # [N] int64
    bin: torch.Tensor           # [N] int64
    default_left: torch.Tensor  # [N] bool
    left_sum: torch.Tensor      # [N, K, 2]
    right_sum: torch.Tensor     # [N, K, 2]


# the working set of one chunk of the vector-leaf split search: the
# nodes of a level are searched in chunks whose gain and hessian planes
# [4, n, F, 2, K, nb] f32 stay under this many bytes
MULTI_SPLIT_CHUNK_BYTES = 1 << 30


def evaluate_splits_multi(hist: torch.Tensor, parent_sum: torch.Tensor,
                          n_real_bins: torch.Tensor, param: TrainParam,
                          has_missing: bool = True,
                          feature_mask: Optional[torch.Tensor] = None
                          ) -> MultiSplitResult:
    """Split search for vector-leaf trees (the JAX package's
    ``evaluate_splits_multi``; reference ``HistMultiEvaluator``): one
    split is shared by the K targets and scored by the sum of their
    gains, and ``min_child_weight`` holds the children's hessians summed
    over the targets. hist [N, F, B, K, 2]; parent_sum [N, K, 2];
    feature_mask [F] or [N, F] bool (column samples, interaction
    constraints; there are no categorical splits or monotone
    constraints with vector leaves).

    The prefix sums over the bins and the sums over the targets add in
    the order the JAX package's compiled CPU program adds them
    (:func:`cumsum_in_xla_order`, :func:`sum_in_xla_order`), and each
    target's gain is its arithmetic, so that on the same histogram the
    search gives the JAX package's bits and near ties break alike.

    Each node's search is its own, so the nodes go through in chunks of
    ``MULTI_SPLIT_CHUNK_BYTES`` (the same bits as one pass): the
    working set stays bounded while a level's node count doubles."""
    N, F, B, K, _ = hist.shape
    nb = B - 1 if has_missing else B
    n_dirs = 2 if has_missing else 1
    per_node = 4 * F * n_dirs * K * nb * 4
    step = max(1, MULTI_SPLIT_CHUNK_BYTES // per_node)
    if feature_mask is not None and feature_mask.dim() == 1:
        feature_mask = feature_mask[None].expand(N, -1)
    parts = [_splits_multi(hist[lo:lo + step], parent_sum[lo:lo + step],
                           n_real_bins, param, has_missing,
                           None if feature_mask is None
                           else feature_mask[lo:lo + step])
             for lo in range(0, N, step)]
    if len(parts) == 1:
        return parts[0]
    return MultiSplitResult(*(torch.cat(f) for f in zip(*parts)))


def _splits_multi(hist, parent_sum, n_real_bins, param, has_missing,
                  feature_mask) -> MultiSplitResult:
    """:func:`evaluate_splits_multi` over one chunk of nodes."""
    N, F, B, K, _ = hist.shape
    nb = B - 1 if has_missing else B
    cum = cumsum_in_xla_order(hist[:, :, :nb].permute(0, 1, 3, 4, 2))
    if has_missing:
        miss = hist[:, :, B - 1]                            # [N, F, K, 2]
        left = torch.stack([cum, cum + miss[..., None]], dim=2)
    else:
        left = cum[:, :, None]                              # [N,F,d,K,2,nb]
    del cum
    n_dirs = left.shape[2]
    sides = torch.stack([left, parent_sum[:, None, None, :, :, None]
                         - left])                           # left, right
    # [4, N, F, d, K, nb]: the left and right gains, then their hessians
    terms = torch.cat([calc_gain(sides[..., 0, :], sides[..., 1, :], param),
                       sides[..., 1, :]])
    del sides
    gl, gr, hl, hr = sum_in_xla_order(terms, dim=4)
    del terms
    pgain = sum_in_xla_order(calc_gain(parent_sum[..., 0],
                                       parent_sum[..., 1], param),
                             dim=1)                         # [N]
    loss_chg = gl + gr - pgain[:, None, None, None]
    bins_idx = torch.arange(nb, device=hist.device)
    base_valid = bins_idx[None, None, :] < n_real_bins[:, None, None]
    mcw = _f32(param.min_child_weight)
    valid = base_valid[None] & (hl >= mcw) & (hr >= mcw)
    if feature_mask is not None:
        valid = valid & feature_mask[:, :, None, None]
    loss_chg = torch.where(valid, loss_chg,
                           torch.full_like(loss_chg, float("-inf")))

    flat = loss_chg.reshape(N, -1)
    best = torch.argmax(flat, dim=1)                        # first maximum
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    f_idx = torch.div(best, nb * n_dirs, rounding_mode="floor")
    rem = best % (nb * n_dirs)
    d_idx = torch.div(rem, nb, rounding_mode="floor")
    b_idx = rem % nb
    nn = torch.arange(N, device=hist.device)
    best_left = left[nn, f_idx, d_idx, :, :, b_idx]         # [N, K, 2]
    return MultiSplitResult(gain=best_gain, feature=f_idx, bin=b_idx,
                            default_left=d_idx.bool(), left_sum=best_left,
                            right_sum=parent_sum - best_left)


# ---- two-level coarse -> refine search --------------------------------------

COARSE_SPAN = 16   # fine bins per coarse bin
COARSE_B = 20      # coarse slots: 16 real + 3 pad + missing at 19
WINDOW = 32        # refined fine bins: the 2 spans around the boundary
SYN_B = 46         # synthetic slots: 14 lower + 32 fine + the upper ones


def coarse_bin_ids(bins: torch.Tensor, missing_bin: int) -> torch.Tensor:
    """Coarse slot of every element, uint8: ``bins >> 4``, the missing bin
    on slot ``COARSE_B - 1``. Without a missing slot ``missing_bin`` is the
    out-of-range sentinel and never matches."""
    b = bins.to(torch.int32)
    shift = COARSE_SPAN.bit_length() - 1
    return torch.where(b == missing_bin, COARSE_B - 1, b >> shift).to(
        torch.uint8)


def refine_bin_ids(bins: torch.Tensor, span: torch.Tensor,
                   missing_bin: int) -> torch.Tensor:
    """Refine slot of every element, uint8, given each element's window
    start ``span`` (in coarse units, broadcast against ``bins``): fine bins
    in the window land on [0, WINDOW); the rest, and the missing bin, on the
    discarded pad slot ``WINDOW + 3`` of a ``WINDOW + 4``-slot build."""
    b = bins.to(torch.int32)
    rb = b - COARSE_SPAN * span.to(torch.int32)
    ok = (rb >= 0) & (rb < WINDOW) & (b != missing_bin)
    return torch.where(ok, rb, WINDOW + 3).to(torch.uint8)


def refine_from_fine(fine: torch.Tensor, window: torch.Tensor,
                     missing_bin: int) -> torch.Tensor:
    """The refine histogram [N, F, WINDOW, 2] as a slice of the fine one
    [N, F, B, 2]: slot w of (node, feature) with window start c is fine
    bin ``16c + w``, the same rows as the direct ``refine_bin_ids`` build,
    so with integer sums the two are equal bit for bit. Slots past the
    last bin and the missing bin are zero, as the direct build drops
    them."""
    N, F, B, _ = fine.shape
    idx = (COARSE_SPAN * window.to(torch.int64)[:, :, None]
           + torch.arange(WINDOW, device=fine.device)[None, None, :])
    out = torch.gather(fine, 2, idx.clamp(0, B - 1)[..., None].expand(
        N, F, WINDOW, 2))
    ok = (idx < B) & (idx != missing_bin)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def choose_refine_window(hist_c: torch.Tensor, parent_sum: torch.Tensor,
                         n_real_bins: torch.Tensor, param: TrainParam,
                         has_missing: bool) -> torch.Tensor:
    """[N, F] int64 window start w (the window covers coarse spans w and
    w + 1): the best coarse boundary over both missing directions under
    the min_child_weight test, first maximum on ties, clamped per feature
    so that the window stays on the feature's real coarse bins."""
    cum = bin_prefix_sums(hist_c[:, :, :COARSE_SPAN, :])    # [N, F, 2, 16]
    if has_missing:
        miss = hist_c[:, :, COARSE_B - 1, :]                # [N, F, 2]
        left = torch.stack([cum, cum + miss[:, :, :, None]], dim=2)
    else:
        left = cum[:, :, None]                  # [N, F, dirs, 2, 16]
    right = parent_sum[:, None, None, :, None] - left
    lg, lh = left[:, :, :, 0, :], left[:, :, :, 1, :]
    rg, rh = right[:, :, :, 0, :], right[:, :, :, 1, :]
    g = calc_gain(lg, lh, param) + calc_gain(rg, rh, param)
    mcw = _f32(param.min_child_weight)
    g = torch.where((lh >= mcw) & (rh >= mcw), g,
                    torch.full_like(g, float("-inf")))
    best = torch.argmax(g.amax(dim=2), dim=2)               # [N, F]
    c_cnt = torch.div(n_real_bins + COARSE_SPAN - 1, COARSE_SPAN,
                      rounding_mode="floor")
    w_max = torch.clamp(c_cnt - 2, min=0).clamp(max=14)     # [F]
    return torch.minimum(best, w_max[None, :])


def assemble_two_level(hist_c: torch.Tensor, hist_r: torch.Tensor,
                       window: torch.Tensor, n_real_bins: torch.Tensor,
                       has_missing: bool):
    """-> (synthetic histogram [N, F, SYN_B (+1), 2], its real-slot count
    [F] int64). Slots [0, w) hold the coarse bins below the window,
    [w, w + 32) the window's fine bins, [w + 32, 46) the coarse bins above
    it, and the last slot the missing mass: cumulative sums over this
    order score every coarse and every in-window fine boundary exactly."""
    N, F = window.shape
    s = torch.arange(SYN_B, device=hist_c.device)[None, None, :]
    w = window.to(torch.int64)[:, :, None]
    in_fine = (s >= w) & (s < w + WINDOW)
    c_idx = torch.where(s < w, s, s - 30).clamp(0, COARSE_SPAN - 1)
    f_idx = (s - w).clamp(0, WINDOW - 1)

    def take(h, idx):
        return torch.gather(h, 2, idx[..., None].expand(N, F, SYN_B, 2))

    syn = torch.where(in_fine[..., None], take(hist_r, f_idx),
                      take(hist_c, c_idx))
    if has_missing:
        syn = torch.cat([syn, hist_c[:, :, COARSE_B - 1:, :]], dim=2)
    c_cnt = torch.div(n_real_bins + COARSE_SPAN - 1, COARSE_SPAN,
                      rounding_mode="floor")
    return syn, torch.clamp(c_cnt + 30, 1, SYN_B)


def decode_two_level_bin(slot: torch.Tensor,
                         window_sel: torch.Tensor) -> torch.Tensor:
    """Synthetic slot -> fine split bin, given the window start of each
    node's winning feature."""
    lower = 16 * slot + 15
    fine = 16 * window_sel + (slot - window_sel)
    upper = 16 * (slot - 30) + 15
    return torch.where(slot < window_sel, lower,
                       torch.where(slot < window_sel + WINDOW, fine, upper))
