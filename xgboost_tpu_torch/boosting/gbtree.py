"""Gradient-boosted tree ensemble: the forest container and one boosting
round.

The port of the JAX package's ``boosting/gbtree.py``: the forest, its
per-tree output groups and per-round boundaries, the same JSON payload,
and ``do_boost``: one tree per output group and parallel tree a round
(reference ``GBTree::BoostNewTrees``), all grown from the round's margin
snapshot in class order, each from its own key ``fold_in(key, k * npt +
p)``, with the learning rate divided by ``num_parallel_tree`` (boosted
random forests). Row sampling (:func:`sample_gradients`) and the
trees' column samples come from that key. ``grow_policy="lossguide"``
grows with ``tree/lossguide.py LossguideGrower``; a paged
(external-memory) matrix with the paged growers of ``tree/paged.py``
(depthwise and leaf-wise, scalar and vector leaves).
``multi_strategy="multi_output_tree"`` with K > 1 outputs (a label
matrix, or ``multi:softprob``'s classes) grows one vector-leaf tree a
round and parallel tree for all K (``tree/multi.py``; the JAX package's
``_do_boost_multi``), each from ``fold_in(key, p)``. A paged matrix's
margins are
walked over its bins page by page (:meth:`GBTree.margin_delta_binned`,
:meth:`GBTree.full_margin_binned`). ``boosting/dart.py`` derives dart
from this class.

``tree_method="approx"`` (the reference's ``GlobalApproxUpdater``,
``src/tree/updater_approx.cc:55``) re-sketches the cuts before each
class's trees with that class's hessian as the weights, after the
objective has folded in the row weights and before row sampling
(``data/binned.py ApproxSource``; a paged matrix re-sketches its pages
on the host, ``PagedApproxSource``), re-bins the matrix and grows from
it; each tree takes its thresholds from its own round's cuts.
The grower is kept, its cuts swapped, while the bin slots are unchanged
and no feature is categorical (the JAX package's rule), else rebuilt.
``tree_method="exact"`` grows with ``tree/exact.py`` over the matrix's
rank encoding, without column sampling, as the JAX package does.

Under a data mesh the Booster hands ``do_boost`` the matrix cut into the
mesh's shards (``data/binned.py shard_binned``: ``bins`` is a
``tree/shards.py RowShards``, or ``MeshApproxSource`` under ``approx``)
and gradients over the padded rows, whose pad rows are zero: row
sampling draws over the padded row count, as the JAX package's mesh
draws (``gbtree.py:505-508``); the threefry stream is counter-based, so
the real rows draw one device's bits. ``n_rows`` trims the round's
delta to the real rows. Under a column mesh (``data_split_mode="col"``
with a mesh) ``bins`` is a ``tree/shards.py ColShards`` (every row, the
features padded and cut into blocks, ``data/binned.py
pad_features_for_mesh``), and the growers pad their per-feature arrays
alike. Vertical federated parties (``data_split_mode="col"`` under a
multi-rank communicator, no mesh; :attr:`GBTree.vertical`) grow with
``tree/vertical.py``'s growers, and an adaptive objective's leaves are
refreshed on the label rank and reach the others through
``apply_with_labels``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..registry import BOOSTERS
from ..tree.exact import ExactGrower
from ..tree.grow import TreeGrower
from ..tree.lossguide import LossguideGrower
from ..tree.multi import (MultiLossguideGrower, MultiTargetGrower,
                          MultiTargetTreeModel, is_vector_leaf)
from ..tree.paged import (PagedGrower, PagedLossguideGrower,
                          PagedMultiLossguideGrower, PagedMultiTargetGrower)
from ..tree.param import TrainParam, _f32
from ..tree.shards import ColShards
from ..tree.tree import TreeModel
from ..tree.vertical import VerticalFederatedGrower, VerticalLossguideGrower
from ..utils import random as xrandom
from .predict import margin_binned, stack_trees


def sample_gradients(gp: torch.Tensor, tkey: xrandom.Key,
                     param: TrainParam) -> torch.Tensor:
    """Row sampling of one tree's gradients gp [n, 2] (the JAX package's
    ``sample_gradients``) under ``fold_in(tkey, 0x5AB)``. ``uniform``:
    rows kept with probability ``subsample``, the others zeroed.
    ``gradient_based``: row i kept with probability
    ``p_i = min(1, subsample * n * u_i / sum(u))``,
    ``u_i = sqrt(g_i^2 + lambda * h_i^2)``, and its pair scaled by
    ``1 / p_i``. ``sum(u)`` is an f32 sum whose order differs from
    XLA's, so p can differ from the JAX package's by an ulp or two."""
    if param.subsample >= 1.0:
        return gp
    skey = xrandom.fold_in(tkey, 0x5AB)
    n = gp.shape[0]
    if param.sampling_method == "gradient_based":
        u = torch.sqrt(gp[:, 0] * gp[:, 0]
                       + _f32(param.reg_lambda) * (gp[:, 1] * gp[:, 1]))
        p = torch.clamp(_f32(param.subsample * n) * u
                        / (u.sum() + _f32(1e-30)), max=1.0)
        keep = xrandom.bernoulli(skey, p)
        # a true division (a Python number over a tensor would go
        # through the reciprocal)
        scale = torch.where(keep, torch.ones_like(p)
                            / torch.clamp(p, min=_f32(1e-30)),
                            torch.zeros_like(p))
        return gp * scale[:, None]
    mask = xrandom.bernoulli(skey, param.subsample, (n,), gp.device)
    return gp * mask[:, None].to(gp.dtype)


# (vector leaves, lossguide, paged) -> the grower class
_GROWERS = {
    (False, False, False): TreeGrower,
    (False, False, True): PagedGrower,
    (False, True, False): LossguideGrower,
    (False, True, True): PagedLossguideGrower,
    (True, False, False): MultiTargetGrower,
    (True, False, True): PagedMultiTargetGrower,
    (True, True, False): MultiLossguideGrower,
    (True, True, True): PagedMultiLossguideGrower,
}


@BOOSTERS.register("gbtree")
class GBTree:
    name = "gbtree"
    # the Booster's margin caches move by each round's delta (dart's old
    # trees change weight, so it recomputes instead)
    supports_margin_cache = True

    def __init__(self, n_groups: int, num_parallel_tree: int = 1,
                 multi_strategy: str = "one_output_per_tree") -> None:
        self.n_groups = n_groups
        self.num_parallel_tree = num_parallel_tree
        self.multi_strategy = multi_strategy
        # set by the Booster before training
        self.tree_param = TrainParam()
        self.hist_method = "auto"
        # the parsed constraints (``tree/param.py``), set with tree_param
        self.monotone: Optional[List[int]] = None
        self.constraint_sets: Optional[np.ndarray] = None
        self.trees: List[TreeModel] = []
        self.tree_info: List[int] = []
        self.iteration_indptr: List[int] = [0]
        self._grower: Optional[TreeGrower] = None
        # "hist", "approx" or "exact", set by the Booster
        self.tree_method = "hist"
        # vertical federated parties (column split over a communicator),
        # set by the Booster
        self.vertical = False
        # insight's fused tier: keep the round's grown heaps (on the
        # device) in ``last_grown`` for its telemetry (``core.py``)
        self.keep_grown = False
        self.last_grown: Optional[List[Any]] = None

    # -- training -------------------------------------------------------------
    @property
    def vector_leaf(self) -> bool:
        """This forest grows, or holds, vector-leaf trees."""
        return (is_vector_leaf(self.trees)
                or (self.multi_strategy == "multi_output_tree"
                    and self.n_groups > 1))

    def _grower_for(self, binned) -> TreeGrower:
        """The grower of this matrix (the JAX package's ``_grower_for``):
        leaf-wise (``tree/lossguide.py``) for ``grow_policy="lossguide"``,
        else depthwise, resident or paged; vector-leaf trees
        (``tree/multi.py``) under ``multi_output_tree``. Under ``approx``
        the grower of the previous cuts takes the new ones when its bin
        slots fit them (:meth:`TreeGrower.set_cuts`)."""
        lossguide = self.tree_param.grow_policy == "lossguide"
        kw = dict(hist_method=self.hist_method,
                  has_missing=binned.has_missing,
                  constraint_sets=self.constraint_sets)
        if self.vertical:
            cls = (VerticalLossguideGrower if lossguide
                   else VerticalFederatedGrower)
        else:
            cls = _GROWERS[(self.vector_leaf, lossguide, binned.is_paged)]
            if isinstance(getattr(binned, "bins", None), ColShards):
                kw["feature_pad"] = binned.bins.pad
        if not self.vector_leaf:
            kw["monotone"] = self.monotone
        g = self._grower
        if (self.tree_method == "approx" and type(g) is cls
                and g.max_nbins == binned.max_nbins
                and g.has_missing == binned.has_missing
                and not binned.cuts.is_cat().any()):
            g.set_cuts(binned.cuts)      # a new round's cuts, same shapes
        if g is None or g.cuts is not binned.cuts or type(g) is not cls:
            param = self.tree_param
            if self.num_parallel_tree > 1:
                # reference BoostNewTrees: lr /= num_parallel_tree
                param = param.clone()
                param.eta = param.eta / self.num_parallel_tree
            self._grower = cls(param, binned.max_nbins, binned.cuts, **kw)
        return self._grower

    def do_boost(self, binned, gpair: torch.Tensor, key: xrandom.Key,
                 obj=None, margin: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None,
                 n_rows: Optional[int] = None) -> torch.Tensor:
        """gpair [n, K, 2] on the device of ``binned`` and the round's key
        -> margin delta [n, K]; appends the round's K * num_parallel_tree
        trees (class k's trees tagged k in ``tree_info``). ``binned``: the
        training matrix's bins, its ``ApproxSource`` under
        ``tree_method="approx"``, or its ``ExactQuantization`` under
        ``"exact"``. With an
        adaptive-leaf ``obj`` (``info.zero_hess``), ``margin`` [n, K] from
        before the round, ``labels`` [n] and ``weights`` [n] or None, each
        tree's leaves are refreshed as it is grown (the JAX package's
        ``update_tree_leaf`` hook): ``eta / num_parallel_tree`` times the
        quantile at target k's alpha of the residuals in each leaf, and
        the round's delta is taken from those leaves. ``n_rows``: the real
        rows of a mesh's padded gradients (module docstring); the delta
        covers those."""
        K = gpair.shape[1]
        if K != self.n_groups:
            raise ValueError(f"{K} gradient columns for a forest of "
                             f"{self.n_groups} output groups")
        npt = max(self.num_parallel_tree, 1)
        adaptive = obj is not None and obj.info.zero_hess
        if adaptive and self.vector_leaf:
            raise NotImplementedError(
                "multi_output_tree does not support adaptive-leaf "
                "objectives")
        method = self.tree_method
        if self.vector_leaf:
            if method in ("approx", "exact"):
                raise NotImplementedError(
                    "multi_output_tree requires tree_method=hist")
            return self._do_boost_multi(binned, self._grower_for(binned),
                                        gpair, key)[:n_rows]
        tkeys = [xrandom.fold_in(key, i) for i in range(K * npt)]
        masks = None
        if method == "exact":
            grower = ExactGrower(self.tree_param, binned)
        elif method == "hist":
            grower = self._grower_for(binned)
            masks = grower.feature_masks(tkeys, gpair.device)
        if adaptive:
            eta = self.tree_param.eta / npt
            alphas = obj.alphas()
        deltas = []
        kept = [] if self.keep_grown else None
        for k in range(K):
            keys = tkeys[k * npt:(k + 1) * npt]
            if method == "approx":
                src = binned.binned(gpair[:, k, 1])
                grower = self._grower_for(src)
                masks_k = grower.feature_masks(keys, gpair.device)
            else:
                src = binned
                masks_k = None if masks is None else masks[k * npt:]
            delta = None
            for p in range(npt):
                gp = sample_gradients(gpair[:, k, :].contiguous(), keys[p],
                                      self.tree_param)
                if method == "exact":
                    grown = grower.grow(gp)
                else:
                    grown = grower.grow(
                        src if src.is_paged else src.bins, gp,
                        None if masks_k is None else masks_k[p])
                tree = grower.to_tree_model(grown)
                if kept is not None:
                    kept.append(grown)
                d = grown.delta
                if adaptive:
                    # grower positions -> the compact tree's node ids (of
                    # the real rows under a mesh)
                    pos = torch.from_numpy(tree.heap_map.astype(
                        np.int64)).to(gp.device)[
                            grown.positions[:margin.shape[0]]]
                    d = self._refresh(obj, tree, pos, margin[:, k], labels,
                                      weights, eta,
                                      alphas[min(k, len(alphas) - 1)])[pos]
                self.trees.append(tree)
                self.tree_info.append(k)
                delta = d if delta is None else delta + d
            deltas.append(delta)
        self.last_grown = kept
        self.iteration_indptr.append(len(self.trees))
        return torch.stack(deltas, dim=1)[:n_rows]

    def _refresh(self, obj, tree: TreeModel, pos: torch.Tensor,
                 margin: torch.Tensor, labels, weights, eta: float,
                 alpha: float) -> torch.Tensor:
        """``obj.refresh_leaves`` of one tree; vertical parties run it on
        the label rank (the leaves are label quantiles), whose leaves
        reach every rank (the JAX package's ``apply_with_labels`` around
        ``update_tree_leaf``)."""
        if not self.vertical:
            return obj.refresh_leaves(tree, pos, margin, labels, weights,
                                      eta, alpha)
        from ..parallel.collective import apply_with_labels

        tree.leaf_value = np.asarray(apply_with_labels(
            lambda: obj.refresh_leaves(tree, pos, margin, labels, weights,
                                       eta, alpha).cpu().numpy()),
            np.float32)
        return torch.from_numpy(tree.leaf_value).to(pos.device)

    def _do_boost_multi(self, binned, grower, gpair: torch.Tensor,
                        key: xrandom.Key) -> torch.Tensor:
        """One vector-leaf tree a parallel tree for all K outputs (the
        JAX package's ``_do_boost_multi``): tree p from ``fold_in(key,
        p)``, tagged 0 in ``tree_info`` -> margin delta [n, K]. Rows are
        kept with probability ``subsample`` under ``fold_in(tkey,
        0x5AB)``, uniformly whatever ``sampling_method`` says, as the JAX
        package's vector-leaf round draws them."""
        npt = max(self.num_parallel_tree, 1)
        tkeys = [xrandom.fold_in(key, p) for p in range(npt)]
        masks = grower.feature_masks(tkeys, gpair.device)
        sub = self.tree_param.subsample
        delta = None
        for p in range(npt):
            gp = gpair
            if sub < 1.0:
                keep = xrandom.bernoulli(xrandom.fold_in(tkeys[p], 0x5AB),
                                         sub, (gp.shape[0],), gp.device)
                gp = gp * keep[:, None, None].to(gp.dtype)
            grown = grower.grow(binned if binned.is_paged else binned.bins,
                                gp, None if masks is None else masks[p])
            self.trees.append(grower.to_tree_model(grown))
            self.tree_info.append(0)
            delta = grown.delta if delta is None else delta + grown.delta
        self.iteration_indptr.append(len(self.trees))
        return delta

    # -- margins over bins ---------------------------------------------------
    def _margin_binned_paged(self, forest, binned, base: torch.Tensor
                             ) -> torch.Tensor:
        """The walk over a paged matrix's pages (through its ring), one
        page at a time."""
        return torch.cat([
            margin_binned(forest, page, binned.missing_bin, base,
                          packed=binned.packed)
            for _, _, page in binned.pages(base.device)])

    def _margin_binned(self, lo: int, hi: int, binned,
                       base: torch.Tensor) -> torch.Tensor:
        w = self.tree_weights()
        forest = stack_trees(self.trees[lo:hi], self.tree_info[lo:hi],
                             self.n_groups, base.device,
                             None if w is None else w[lo:hi])
        if binned.is_paged:
            return self._margin_binned_paged(forest, binned, base)
        return margin_binned(forest, binned.bins, binned.missing_bin, base)

    def margin_delta_binned(self, binned, tree_lo: int, tree_hi: int,
                            device: torch.device) -> torch.Tensor:
        """Margin contribution [n, G] of trees [tree_lo, tree_hi) over the
        bins of ``binned`` (resident or paged), on ``device``: the margin
        cache's increment on a matrix without raw values."""
        zero = torch.zeros(self.n_groups, dtype=torch.float32, device=device)
        return self._margin_binned(tree_lo, tree_hi, binned, zero)

    def full_margin_binned(self, binned, base: torch.Tensor) -> torch.Tensor:
        """Margins [n, G] of every tree plus ``base`` [G] over the bins."""
        if not self.trees:
            return base[None, :].expand(binned.shape[0], -1).clone()
        return self._margin_binned(0, len(self.trees), binned, base)

    def version(self) -> int:
        """Tree count: the margin caches slice trees by it."""
        return len(self.trees)

    def _tree_range(self, iteration_range=None):
        """iteration_range -> (tree_lo, tree_hi) indices."""
        if iteration_range is not None and iteration_range != (0, 0):
            b, e = iteration_range
            e = min(e if e else self.num_boosted_rounds(),
                    self.num_boosted_rounds())
            return self.iteration_indptr[b], self.iteration_indptr[e]
        return 0, len(self.trees)

    def tree_weights(self) -> Optional[np.ndarray]:
        """[T] f32 weight of each tree in the margin; None: every weight
        is 1 (gbtree)."""
        return None

    def forest_slice(self, iteration_range=None):
        """-> (trees, tree_info, tree_weights) of the selected rounds
        (tree_weights None when every weight is 1)."""
        lo, hi = self._tree_range(iteration_range)
        w = self.tree_weights()
        return (self.trees[lo:hi], np.asarray(self.tree_info[lo:hi]),
                None if w is None else w[lo:hi])

    def slice_rounds(self, rounds) -> "GBTree":
        """A forest of the same kind holding the trees of ``rounds`` (an
        iterable of round indices), sharing them with this one."""
        new = type(self)(self.n_groups,
                         num_parallel_tree=self.num_parallel_tree,
                         multi_strategy=self.multi_strategy)
        new.tree_param, new.hist_method = self.tree_param, self.hist_method
        for it in rounds:
            lo, hi = self.iteration_indptr[it], self.iteration_indptr[it + 1]
            new.trees.extend(self.trees[lo:hi])
            new.tree_info.extend(self.tree_info[lo:hi])
            new.iteration_indptr.append(len(new.trees))
        return new

    def num_boosted_rounds(self) -> int:
        return len(self.iteration_indptr) - 1

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "num_parallel_tree": self.num_parallel_tree,
            "multi_strategy": self.multi_strategy,
            "trees": [t.to_json() for t in self.trees],
            "tree_info": list(self.tree_info),
            "iteration_indptr": list(self.iteration_indptr),
        }

    def from_json(self, obj: dict) -> None:
        self.num_parallel_tree = int(obj.get("num_parallel_tree", 1))
        self.multi_strategy = obj.get("multi_strategy",
                                      "one_output_per_tree")
        self.trees = [MultiTargetTreeModel.from_json(t) if "n_targets" in t
                      else TreeModel.from_json(t) for t in obj["trees"]]
        self.tree_info = [int(x) for x in obj["tree_info"]]
        self.iteration_indptr = [int(x) for x in obj["iteration_indptr"]]
