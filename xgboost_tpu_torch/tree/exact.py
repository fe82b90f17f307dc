"""Exact greedy tree growing (``tree_method="exact"``; reference
``ColMaker``, ``src/tree/updater_colmaker.cc:604``).

The port of the JAX package's ``tree/exact.py``: every feature is
quantised losslessly, each distinct value its own rank
(:class:`ExactQuantization`, built with host numpy once a matrix), and
the depthwise heap loop of ``tree/grow.py`` evaluates every threshold of
one feature at a time: the per-(node, rank) gradient sums by a
scatter-add, a cumulative sum over the ranks for the left sums with
missing values right and left, then the gain. One feature at a time, as
the JAX package's ``lax.scan`` over features, because a rank axis is
about as long as the rows: a level of N nodes over R ranks holds about
``N * R * 16`` bytes of left sums, so nodes go in chunks of at most
``EXACT_CHUNK_ENTRIES`` (node, rank) pairs. A split between two distinct
values takes their midpoint, ColMaker's ``(fvalue + last_fvalue) / 2``.

As in the JAX package the grower takes no column sampling and no
constraints; the tree's row sample comes from ``boosting/gbtree.py``.
The sums are f64 (:func:`grow_exact`). On the card the scatter-add sums
in the order its atomics land and the cumulative sum in blocks, so
trees agree with the CPU's, and with the JAX package's f32 ones, under
the tests' near-tie certificate, not bit for bit. Categorical features
are refused before training, as upstream refuses them (``core.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.partition import update_positions
from ..ops.split import SplitResult
from ..registry import TREE_UPDATERS
from .grow import GrownTree, HeapTree
from .param import TrainParam, _f32, calc_gain
from .tree import TreeModel

# the most (node, rank) pairs one feature's search holds at once
EXACT_CHUNK_ENTRIES = 1 << 24


class ExactQuantization:
    """Lossless per-feature rank encoding of a raw matrix X [n, F]: rank r
    of feature f is its r-th smallest distinct finite value; a value that
    is not finite (NaN, or +-inf, as in the JAX package) takes the
    missing rank ``n_ranks`` (the most distinct values of any feature).
    ``midpoints[f, r]`` is the threshold of a split after rank r (+inf
    past the feature's last pair). Host numpy, once; :meth:`on` copies
    the tensors to a device."""

    def __init__(self, X: np.ndarray) -> None:
        n, F = X.shape
        self.uniques = []
        ranks = np.zeros((n, F), np.int32)
        for f in range(F):
            col = np.asarray(X[:, f], np.float32)
            mask = np.isfinite(col)
            vals = np.unique(col[mask])
            self.uniques.append(vals)
            ranks[mask, f] = np.searchsorted(vals, col[mask])
            ranks[~mask, f] = -1
        self.n_ranks = max([1] + [len(v) for v in self.uniques])
        ranks[ranks < 0] = self.n_ranks
        mids = np.full((F, self.n_ranks), np.inf, np.float32)
        for f, vals in enumerate(self.uniques):
            if len(vals) > 1:
                mids[f, :len(vals) - 1] = (vals[:-1] + vals[1:]) / 2.0
        self.ranks = ranks
        self.midpoints = mids
        self.n_distinct = np.asarray([len(v) for v in self.uniques],
                                     np.int64)
        self._on = {}

    def on(self, device: torch.device):
        """(ranks [n, F] int32, n_distinct [F] int64) on ``device``, copied
        once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (torch.from_numpy(self.ranks).to(device),
                             torch.from_numpy(self.n_distinct).to(device))
        return self._on[key]


def _feature_best(r: torch.Tensor, gpair: torch.Tensor, rel: torch.Tensor,
                  n_level: int, n_ranks: int, n_distinct: int,
                  parent_sum: torch.Tensor, pgain: torch.Tensor,
                  param: TrainParam):
    """The best split of each of ``n_level`` nodes on one feature whose
    rows have ranks ``r`` [n] (missing ``n_ranks``) -> (gain, rank,
    missing left, left sum [N, 2]), all f64; gain -inf where no split is
    valid. ``gpair`` [n, 2], ``parent_sum`` [N, 2] and ``pgain`` [N] are
    f64. The (rank, direction) pairs are scored in the JAX package's
    order, rank-major, so ties go to the first, as ``jnp.argmax``'s. The
    sums lie [node, g/h, rank], so the cumulative sum runs along the
    innermost axis."""
    dev = gpair.device
    R1 = n_ranks + 1
    seg = rel.to(torch.int64) * R1 + r
    hist = torch.zeros(((n_level + 1) * R1, 2), dtype=torch.float64,
                       device=dev).index_add_(0, seg, gpair)
    hist = hist[:n_level * R1].view(n_level, R1, 2).permute(0, 2, 1)
    rr = torch.arange(n_ranks, device=dev)
    chunk = max(1, EXACT_CHUNK_ENTRIES // max(n_ranks, 1))
    mcw = _f32(param.min_child_weight)
    out = []
    for lo in range(0, n_level, chunk):
        hi = min(lo + chunk, n_level)
        h = hist[lo:hi].contiguous()                             # [C, 2, R1]
        miss = h[:, :, n_ranks]                                  # [C, 2]
        cum = torch.cumsum(h[:, :, :n_ranks], dim=2)             # [C, 2, R]
        par = parent_sum[lo:hi, :, None]
        losses = []
        # direction 0: missing right; 1: missing left
        for left in (cum, cum + miss[:, :, None]):
            right = par - left
            loss = (calc_gain(left[:, 0], left[:, 1], param)
                    + calc_gain(right[:, 0], right[:, 1], param)
                    - pgain[lo:hi, None])
            valid = ((rr[None, :] < n_distinct - 1)
                     & (left[:, 1] >= mcw) & (right[:, 1] >= mcw))
            losses.append(torch.where(valid, loss,
                                      torch.full_like(loss, -np.inf)))
        flat = torch.stack(losses, dim=2).reshape(hi - lo, -1)   # [C, 2R]
        best = torch.argmax(flat, dim=1)
        gain = flat.gather(1, best[:, None])[:, 0]
        rank, dleft = best // 2, best % 2
        nn = torch.arange(hi - lo, device=dev)
        left = cum[nn, :, rank] + dleft[:, None] * miss
        out.append((gain, rank, dleft.bool(), left))
    return tuple(torch.cat(parts) for parts in zip(*out))


def grow_exact(ranks: torch.Tensor, gpair: torch.Tensor,
               n_distinct: torch.Tensor, n_distinct_h: np.ndarray,
               n_ranks: int, param: TrainParam) -> GrownTree:
    """One depthwise tree from ranks [n, F] int32 and gpair [n, 2] f32 on
    one device (the JAX package's ``_grow_exact``): at each level the best
    (feature, rank, direction) of every node, the first feature on a tie,
    recorded in the heap; rows advance by rank, the missing rank
    ``n_ranks`` going the default way. The sums, the node sums they are
    taken from and the gains are f64, as upstream's ``ColMaker`` keeps
    its statistics (the JAX package's are f32): a child's sums are its
    parent's less its sibling's, and in f32 a small node below a large
    one keeps few digits. The heap keeps them in f32."""
    n, F = ranks.shape
    dev = gpair.device
    g64 = gpair.to(torch.float64)
    root = g64.sum(dim=0)
    tree = HeapTree(param.max_depth, root.float(), param)
    sums = torch.zeros((tree.max_nodes, 2), dtype=torch.float64, device=dev)
    sums[0] = root
    positions = torch.zeros((n,), dtype=torch.int64, device=dev)
    for depth in range(param.max_depth):
        lo, n_level = 2 ** depth - 1, 2 ** depth
        hi = lo + n_level
        in_level = (positions >= lo) & (positions < hi)
        rel = torch.where(in_level, positions - lo,
                          torch.full_like(positions, n_level))
        parent = sums[lo:hi]
        pgain = calc_gain(parent[:, 0], parent[:, 1], param)
        best = None
        for f in range(F):
            cand = _feature_best(ranks[:, f].to(torch.int64), g64, rel,
                                 n_level, n_ranks, int(n_distinct_h[f]),
                                 parent, pgain, param)
            if best is None:
                best = cand + (torch.zeros(n_level, dtype=torch.int64,
                                           device=dev),)
                continue
            win = cand[0] > best[0]
            best = (torch.where(win, cand[0], best[0]),
                    torch.where(win, cand[1], best[1]),
                    torch.where(win, cand[2], best[2]),
                    torch.where(win[:, None], cand[3], best[3]),
                    torch.where(win, torch.full_like(best[4], f), best[4]))
        gain, rank, dleft, left, feat = best
        right = parent - left
        res = SplitResult(gain=gain.float(), feature=feat, bin=rank,
                          default_left=dleft, left_sum=left.float(),
                          right_sum=right.float())
        can_split = tree.record(lo, n_level, res)
        cs = can_split[:, None]
        sums[2 * lo + 1:2 * hi + 1] = torch.stack(
            [torch.where(cs, left, torch.zeros_like(left)),
             torch.where(cs, right, torch.zeros_like(right))],
            dim=1).reshape(-1, 2)
        is_split = torch.zeros((tree.max_nodes,), dtype=torch.bool,
                               device=dev)
        is_split[lo:hi] = can_split
        positions = update_positions(ranks, positions, tree.split_feature,
                                     tree.split_bin, tree.default_left,
                                     is_split, n_ranks)
    return tree.finish(positions)


@TREE_UPDATERS.register("grow_colmaker", "exact")
class ExactGrower:
    """The grower of ``tree_method="exact"`` (numerical features only)
    over one matrix's :class:`ExactQuantization`."""

    def __init__(self, param: TrainParam, quant: ExactQuantization) -> None:
        self.param = param
        self.quant = quant

    def grow(self, gpair: torch.Tensor) -> GrownTree:
        ranks, n_distinct = self.quant.on(gpair.device)
        return grow_exact(ranks, gpair, n_distinct, self.quant.n_distinct,
                          self.quant.n_ranks, self.param)

    def to_tree_model(self, g: GrownTree) -> TreeModel:
        """The heap on the host, its thresholds the split ranks'
        midpoints."""
        sf = g.split_feature.cpu().numpy()
        sb = g.split_bin.cpu().numpy()
        split_value = np.zeros(sf.shape, np.float32)
        mask = sf >= 0
        split_value[mask] = self.quant.midpoints[sf[mask], sb[mask]]
        return TreeModel.from_heap(
            split_feature=sf, split_bin=sb, split_value=split_value,
            default_left=g.default_left.cpu().numpy(),
            is_leaf=g.is_leaf.cpu().numpy(), active=g.active.cpu().numpy(),
            leaf_value=g.leaf_value.cpu().numpy(),
            sum_hess=g.node_sum[:, 1].cpu().numpy(),
            gain=g.gain.cpu().numpy(),
            base_weight=g.base_weight.cpu().numpy())
