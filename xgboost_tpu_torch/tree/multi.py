"""Vector-leaf trees: ``multi_strategy="multi_output_tree"``.

The port of the JAX package's ``tree/multi.py`` on one device (reference
``MultiTargetTree`` and ``MultiTargetHistBuilder``): one tree a round
for all K targets, whose every node holds K weights. A split is shared
by the targets and scored by the sum of their gains
(``ops/split.py evaluate_splits_multi``); each level's histogram is K
passes of the scalar build (``ops/histogram.py build_hist_multi``), so
every pass runs K4, K2 or K3 as a scalar build of that level would, and
each is quantised with its own target's scale.

Depthwise growth (:class:`MultiTargetGrower`) runs the scalar grower's
level loop over ``tree/grow.py HeapTree``, which holds [K, 2] sums a
node; ``max_leaves`` truncates the grown heap as it does for scalar
trees, and a row's margin delta is the K weights of its final node
(``leaf_value[positions]``: the JAX package's one-hot product per level
adds exactly one nonzero term a row, so the bits are the same). Its
column samples are the JAX package's: the tree's mask drawn from every
feature, the levels' and nodes' from it (``draw_feature_masks``).
Leaf-wise growth (:class:`MultiLossguideGrower`) is the greedy loop of
``tree/lossguide.py`` with the pair's K-target build and one packed copy
of its split results a split. Interaction constraints apply per
feature, as in the reference's ``HistMultiEvaluator``; monotone
constraints, categorical splits, dart and the two-level histogram
schedules are refused by the Booster, as the JAX package refuses them.

:class:`MultiTargetTreeModel` is the JAX package's model (``leaf_value``
and ``base_weight`` [n, K]; ``sum_hess`` the hessian summed over the
targets), with its JSON. Prediction walks the trees as torch ops
(``boosting/predict.py``); the packed walk (K1) takes scalar trees only,
in both packages.

The paged vector-leaf growers are ``tree/paged.py``'s. Under a data
mesh (``tree/shards.py RowShards``) each shard builds its K-target
histograms and the shards' partials and root sums are summed (the JAX
package's row ``allreduce`` and root sum, ``tree/multi.py:89-128``);
each target's scale is reduced over the shards. Over a column mesh
(``ColShards``, the JAX package's ``col_split`` branches of
``_grow_multi`` and ``_eval2_multi_col``) each shard builds and searches
its own features over every row, the shards' results cross the scalar
trees' best-split exchange, and the rows advance through the owners'
decisions (``tree/grow.py advance_heap``). Vertical federated parties
take scalar trees only, as in the JAX package.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional

import numpy as np
import torch

from ..obs import trace as _trace
from ..ops.histogram import build_hist_multi, resolve_hist_kernel
from ..ops.partition import level_rel
from ..ops.split import MultiSplitResult, evaluate_splits_multi
from ..ops.xla_order import sum_in_xla_order
from .grow import (GrownTree, HeapTree, TreeGrower, advance_heap,
                   draw_feature_masks, interaction_allowed_host)
from .lossguide import LossguideGrower, LossguideGrown, pair_rel
from .param import TrainParam, _f32, calc_weight
from .shards import ColShards, RowShards
from .tree import TreeModel

_EPS = 1e-6  # reference kRtEps


class MultiTargetTreeModel(TreeModel):
    """A compact tree whose ``leaf_value`` / ``base_weight`` are [n, K]
    (reference ``MultiTargetTree``); ``sum_hess`` holds the hessian
    summed over the targets, so cover importances stay defined."""

    @property
    def n_targets(self) -> int:
        return self.leaf_value.shape[1]

    def to_json(self) -> dict:
        # thresholds stay in split_conditions; the leaf and node weights
        # ride in their own fields
        return {
            "n_targets": self.n_targets,
            "left_children": self.left_child.tolist(),
            "right_children": self.right_child.tolist(),
            "parents": self.parent.tolist(),
            "split_indices": [int(max(f, 0)) for f in self.split_feature],
            "split_conditions": [float(v) for v in self.split_value],
            "default_left": [int(d) for d in self.default_left],
            "loss_changes": self.gain.tolist(),
            "sum_hessian": self.sum_hess.tolist(),
            "split_bins": self.split_bin.tolist(),
            "leaf_values": self.leaf_value.tolist(),
            "base_weights": self.base_weight.tolist(),
        }

    @staticmethod
    def from_json(obj: dict) -> "MultiTargetTreeModel":
        base = TreeModel.from_json({**obj, "base_weights":
                                    [0.0] * len(obj["left_children"])})
        lv = np.asarray(obj["leaf_values"], np.float32)
        return MultiTargetTreeModel(
            left_child=base.left_child, right_child=base.right_child,
            parent=base.parent, split_feature=base.split_feature,
            split_bin=base.split_bin,
            split_value=np.asarray(obj["split_conditions"], np.float32),
            default_left=base.default_left, is_leaf=base.is_leaf,
            leaf_value=np.where(base.is_leaf[:, None], lv,
                                0.0).astype(np.float32),
            sum_hess=base.sum_hess, gain=base.gain,
            base_weight=np.asarray(obj["base_weights"], np.float32))


def is_vector_leaf(trees) -> bool:
    """True when a forest's trees have vector leaves."""
    return bool(trees) and isinstance(trees[0], MultiTargetTreeModel)


# ---- depthwise ----------------------------------------------------------------

def grow_multi_tree(bins, gpair: torch.Tensor,
                    n_real_bins: torch.Tensor, *, param: TrainParam,
                    max_nbins: int, hist_method: str = "auto",
                    has_missing: bool = True,
                    feature_masks: Optional[List[torch.Tensor]] = None,
                    constraint_sets: Optional[torch.Tensor] = None
                    ) -> GrownTree:
    """One vector-leaf tree, depthwise (the JAX package's
    ``_grow_multi``), from bins [n, F] and gpair [n, K, 2] f32 on one
    device: the root's sums in the JAX package's order, then per level
    the K-target histogram, the shared split search, the heap's
    bookkeeping and the rows' advance. ``bins``, ``feature_masks`` and
    ``constraint_sets`` as :func:`tree.grow.grow_tree` takes them (a
    mesh's shards, row or column, too)."""
    rows = RowShards.of(bins)
    gps = rows.split(gpair)
    scale = rows.scale(gps)
    dev = rows.device
    max_depth = param.max_depth
    missing_bin = max_nbins - 1 if has_missing else max_nbins
    for depth in range(max_depth):      # refuse an unported method up front
        resolve_hist_kernel(hist_method, rows.shard_rows, 2 ** depth,
                            max_nbins, has_missing,
                            col_split=isinstance(rows, ColShards))
    tree = HeapTree(max_depth, rows.reduce([sum_in_xla_order(g, 0)
                                            for g in gps], "mesh/root-sum"),
                    param, constraint_sets=constraint_sets)
    positions = [torch.zeros((b.shape[0],), dtype=torch.int64,
                             device=b.device) for b in rows.parts]
    for depth in range(max_depth):
        lo = 2 ** depth - 1
        n_level = 2 ** depth
        hi = lo + n_level
        fmask, _ = tree.constraint_args(
            lo, n_level, None if feature_masks is None
            else feature_masks[depth])
        res = search_multi(rows, gps, [level_rel(p, lo, n_level)
                                       for p in positions], n_level,
                           tree.node_sum[lo:hi], n_real_bins, fmask,
                           param=param, max_nbins=max_nbins,
                           hist_method=hist_method, has_missing=has_missing,
                           scale=scale)
        can_split = tree.record(lo, n_level, res)
        is_split = torch.zeros((tree.max_nodes,), dtype=torch.bool,
                               device=dev)
        is_split[lo:hi] = can_split
        positions = advance_heap(rows, positions, (
            tree.split_feature, tree.split_bin, tree.default_left, is_split,
            None, None), missing_bin)
    return tree.finish(rows.gather(positions))


def search_multi(rows, gps, rels, n_nodes: int, parent_sum: torch.Tensor,
                 n_real_bins: torch.Tensor, fmask, *, param: TrainParam,
                 max_nbins: int, hist_method: str, has_missing: bool,
                 scale=None) -> MultiSplitResult:
    """The best vector-leaf splits of ``n_nodes`` nodes (each shard's
    gradients ``gps`` [n_s, K, 2] and node of each row ``rels``): the
    shards' K-target histograms summed and searched once, or, over a
    column mesh's ``ColShards``, each shard's searched over its own
    features and the results exchanged (features global)."""
    if isinstance(rows, ColShards):
        # (the vector-leaf search's sums are elementwise in a fixed order,
        # ``ops/xla_order.py``: no pooled layout is needed)
        results = []
        for s, (b, g, r) in enumerate(zip(rows.parts, gps, rels)):
            res = evaluate_splits_multi(
                build_hist_multi(b, g, r, n_nodes, max_nbins,
                                 method=hist_method, has_missing=has_missing,
                                 col_split=True),
                parent_sum.to(b.device), rows.local(n_real_bins, s), param,
                has_missing=has_missing, feature_mask=rows.local(fmask, s))
            results.append(res._replace(feature=res.feature
                                        + rows.offsets[s]))
        return rows.exchange(results)
    hist = rows.reduce([build_hist_multi(
        b, g, r, n_nodes, max_nbins, method=hist_method,
        has_missing=has_missing, **(scale or {}))
        for b, g, r in zip(rows.parts, gps, rels)])
    return evaluate_splits_multi(hist, parent_sum, n_real_bins, param,
                                 has_missing=has_missing, feature_mask=fmask)


class MultiTargetGrower(TreeGrower):
    """Depthwise vector-leaf growth (the JAX package's
    ``MultiTargetGrower``): :func:`grow_multi_tree`, ``max_leaves``'
    truncation of the heap, and the :class:`MultiTargetTreeModel`."""

    def feature_masks(self, tkeys, device: torch.device):
        """The trees' column samples; a vector-leaf tree draws its mask
        from every feature (the JAX package's ``MultiTargetGrower.grow``),
        where a scalar tree draws from those with real bins."""
        F = len(self.padded(self.cuts.n_real_bins()))
        return draw_feature_masks(
            tkeys, torch.ones(F, dtype=torch.bool, device=device),
            self.param, self.param.max_depth)

    def grow(self, bins, gpair: torch.Tensor,
             masks: Optional[List[torch.Tensor]]) -> GrownTree:
        """One tree from gpair [n, K, 2]; ``masks`` from
        :meth:`feature_masks`, or None."""
        _, sets = self.constraints_on(gpair.device)
        g = grow_multi_tree(bins, gpair, self._n_real_on(gpair.device),
                            param=self.param, max_nbins=self.max_nbins,
                            hist_method=self.hist_method,
                            has_missing=self.has_missing,
                            feature_masks=masks, constraint_sets=sets)
        if self.param.max_leaves > 0:
            g = self._truncate_max_leaves(g)
        return g

    def to_tree_model(self, g: GrownTree) -> MultiTargetTreeModel:
        sf = g.split_feature.cpu().numpy()
        sb = g.split_bin.cpu().numpy()
        node_sum = g.node_sum.cpu().numpy()                  # [cap, K, 2]
        return MultiTargetTreeModel.from_heap(
            split_feature=sf, split_bin=sb,
            split_value=self.cuts.split_values(sf, sb),
            default_left=g.default_left.cpu().numpy(),
            is_leaf=g.is_leaf.cpu().numpy(), active=g.active.cpu().numpy(),
            leaf_value=g.leaf_value.cpu().numpy(),
            sum_hess=node_sum[:, :, 1].sum(axis=1),
            gain=g.gain.cpu().numpy(),
            base_weight=g.base_weight.cpu().numpy())


# ---- leaf-wise ----------------------------------------------------------------

def eval2_multi(rows: RowShards, gps, positions, id0: int, id1: int,
                parent_sums, fmask, n_real_bins, *, param: TrainParam,
                max_nbins: int, hist_method: str, has_missing: bool,
                scale=None) -> MultiSplitResult:
    """The best splits of nodes ``id0`` and ``id1`` (-1: none) from one
    K-target build over every row, the others inactive (the JAX
    package's ``_eval2_multi``), on every shard and summed over them:
    parent_sums [2, K, 2] f32, fmask [2, F] bool (over a column mesh,
    :func:`search_multi`'s exchange)."""
    return search_multi(rows, gps, [pair_rel(p, id0, id1)
                                    for p in positions], 2, parent_sums,
                        n_real_bins, fmask, param=param, max_nbins=max_nbins,
                        hist_method=hist_method, has_missing=has_missing,
                        scale=scale)


def pack_multi_result(res: MultiSplitResult) -> torch.Tensor:
    """A pair's :class:`MultiSplitResult` as one float64 tensor
    [2, 4 + 4K] (gain, feature, bin, default_left, the K left sums' (g, h),
    the K right sums'; every value exact in float64), so that one copy
    brings a split's results to the host."""
    cols = [res.gain[:, None], res.feature[:, None], res.bin[:, None],
            res.default_left[:, None], res.left_sum.reshape(2, -1),
            res.right_sum.reshape(2, -1)]
    return torch.cat([c.to(torch.float64) for c in cols], dim=1)


class MultiLossguideGrower(LossguideGrower):
    """Leaf-wise vector-leaf growth (the JAX package's
    ``MultiLossguideGrower``): the candidate with the largest summed gain
    is popped one at a time, ``max_leaves`` caps the leaves; each split
    moves the popped node's rows (:func:`tree.lossguide.apply1`) and
    builds its children's K-target histograms in one N = 2 pass
    (:func:`eval2_multi`). Compact host arrays of capacity
    ``2 * max_leaves - 1``; column samples from the scalar lossguide's
    host sampler (``col_masks``)."""

    def _eval2(self, rows, *args, **kwargs) -> MultiSplitResult:
        return eval2_multi(rows, *args, **kwargs)

    @staticmethod
    def _root(gp: torch.Tensor) -> torch.Tensor:
        return sum_in_xla_order(gp, 0)

    def grow(self, bins, gpair: torch.Tensor,
             node_mask: Callable[[int], np.ndarray]) -> LossguideGrown:
        """One tree from bins [n, F], a mesh's ``RowShards`` or a paged
        matrix (through :meth:`_eval2` / :meth:`_apply1`) and gpair
        [n, K, 2] f32 on the (first) device; ``node_mask``: its column
        sampler."""
        param = self.param
        F = bins.shape[1]
        K = gpair.shape[1]
        dev = gpair.device
        max_leaves = param.max_leaves if param.max_leaves > 0 else (
            2 ** max(param.max_depth, 1))
        cap = 2 * max_leaves - 1
        rows, gps, positions, root, n_k, scale = self._rows(bins, gpair)
        resolve_hist_kernel(self.hist_method, n_k, 2, self.max_nbins,
                            self.has_missing,
                            col_split=isinstance(rows, ColShards))
        n_real = self._n_real_on(dev)
        cons = (None if self.constraint_sets is None
                else self.padded(self.constraint_sets))
        mb = self.max_nbins - 1 if self.has_missing else self.max_nbins
        kw = dict(param=param, max_nbins=self.max_nbins,
                  hist_method=self.hist_method, has_missing=self.has_missing,
                  scale=scale)

        sf = np.full(cap, -1, np.int32)
        sb = np.zeros(cap, np.int32)
        dl = np.zeros(cap, bool)
        lc = np.full(cap, -1, np.int32)
        rc = np.full(cap, -1, np.int32)
        pa = np.full(cap, -1, np.int32)
        gn = np.zeros(cap, np.float32)
        gh = np.zeros((cap, K, 2), np.float64)
        depth_of = np.zeros(cap, np.int32)
        paths = np.zeros((cap, F), bool) if cons is not None else None

        gh[0] = root.cpu().numpy()
        n_nodes, n_leaves, counter = 1, 1, 0
        pq: list = []       # (-gain, push order, node, split payload)
        min_gain = max(param.gamma, _EPS)

        def eval_nodes(id0: int, id1: int) -> None:
            nonlocal counter
            ids = [i for i in (id0, id1) if i >= 0]
            if param.max_depth > 0:
                ids = [i for i in ids if depth_of[i] < param.max_depth]
            if not ids:
                return
            i0 = ids[0]
            i1 = ids[1] if len(ids) > 1 else -1
            fm = np.stack([node_mask(int(depth_of[i])) if i >= 0
                           else np.zeros(F, bool) for i in (i0, i1)])
            if paths is not None:
                fm[0] &= interaction_allowed_host(paths[i0][None], cons)[0]
                if i1 >= 0:
                    fm[1] &= interaction_allowed_host(paths[i1][None],
                                                      cons)[0]
            psums = torch.from_numpy(np.stack(
                [gh[i0], gh[i1] if i1 >= 0 else np.zeros((K, 2))]).astype(
                    np.float32)).to(dev)
            with _trace.span("lossguide/eval"):
                res = self._eval2(rows, gps, positions, i0, i1, psums,
                                  torch.from_numpy(fm).to(dev), n_real, **kw)
                _trace.sync(res)
            with _trace.span("lossguide/fetch"):
                host = pack_multi_result(res).cpu().numpy()
            for slot, nid in ((0, i0), (1, i1)):
                if nid < 0:
                    continue
                g = float(np.float32(host[slot, 0]))
                if not np.isfinite(g) or g <= min_gain:
                    continue
                heapq.heappush(pq, (-g, counter, nid, host[slot].copy()))
                counter += 1

        eval_nodes(0, -1)
        while pq and n_leaves < max_leaves:
            neg_gain, _, nid, row = heapq.heappop(pq)
            feat, rbin, rdl = int(row[1]), int(row[2]), bool(row[3])
            li, ri = n_nodes, n_nodes + 1
            n_nodes += 2
            n_leaves += 1
            sf[nid], sb[nid], dl[nid] = feat, rbin, rdl
            gn[nid] = -neg_gain
            lc[nid], rc[nid] = li, ri
            pa[li] = pa[ri] = nid
            gh[li] = row[4:4 + 2 * K].reshape(K, 2)
            gh[ri] = row[4 + 2 * K:4 + 4 * K].reshape(K, 2)
            depth_of[li] = depth_of[ri] = depth_of[nid] + 1
            if paths is not None:
                paths[li] = paths[ri] = paths[nid]
                paths[li, feat] = paths[ri, feat] = True
            with _trace.span("lossguide/apply"):
                positions = self._apply1(rows, positions, nid, feat, rbin,
                                         rdl, False, None, li, ri, mb)
                _trace.sync(positions)
            eval_nodes(li, ri)

        # the weights: f32 from the f32 sums, times eta
        w = (calc_weight(
            torch.from_numpy(gh[:n_nodes, :, 0].astype(np.float32)),
            torch.from_numpy(gh[:n_nodes, :, 1].astype(np.float32)), param)
            * _f32(param.eta)).numpy()                       # [n_nodes, K]
        is_leaf = lc[:n_nodes] < 0
        leaf_value = np.where(is_leaf[:, None], w, 0.0).astype(np.float32)
        tree = MultiTargetTreeModel.from_compact(
            left_child=lc[:n_nodes].copy(), right_child=rc[:n_nodes].copy(),
            parent=pa[:n_nodes].copy(), split_feature=sf[:n_nodes].copy(),
            split_bin=sb[:n_nodes].copy(),
            split_value=self.cuts.split_values(sf[:n_nodes], sb[:n_nodes]),
            default_left=dl[:n_nodes].copy(), is_leaf=is_leaf,
            leaf_value=leaf_value,
            sum_hess=gh[:n_nodes, :, 1].sum(axis=1).astype(np.float32),
            gain=np.where(is_leaf, 0.0, gn[:n_nodes]).astype(np.float32),
            base_weight=w.astype(np.float32))
        positions = self._final(rows, positions)
        delta = torch.from_numpy(leaf_value).to(dev)[positions]
        return LossguideGrown(positions=positions, delta=delta, tree=tree)
