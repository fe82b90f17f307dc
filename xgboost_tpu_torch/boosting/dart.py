"""The dart booster: gradient boosting with tree dropout.

The port of the JAX package's ``boosting/dart.py`` (reference
``src/gbm/gbtree.cc``, ``Dart``). Each round drops a subset of the trees
(:meth:`Dart._select_drop`: ``sample_type`` ``uniform`` or ``weighted``
under ``rate_drop``, ``one_drop`` and ``skip_drop``), grows the round's
trees from gradients against the margin without them, then rescales:
``normalize_type="tree"`` gives the new trees ``1 / (k + eta)`` and
multiplies the k dropped ones by ``k / (k + eta)``; ``"forest"`` gives
both ``1 / (1 + eta)``. Tree t's weight in every margin is
``weight_drop[t]``, saved with the model.

The drops are drawn from ``np.random.RandomState(seed)`` (the Booster's
``seed``, made when training starts, one stream per Booster): upstream
XGBoost's dropout follows ``seed``; the JAX package always draws from
``RandomState(0)``, so the two agree at the default seed 0 (ROADMAP C).

Margins: the Booster keeps no per-round cache for dart (its old trees
change weight), but the training margin over every tree changes by a
closed form each round (the dropped trees' term times ``factor - 1``,
plus the new trees' delta times their weight), so it rolls forward in
the training matrix's cache entry (``state["dart_margin"]``, beside the
tree count and the weights it holds). The dropped trees' term comes from
a ring of per-round unit deltas [R, n, K] on the device
(``state["dart_deltas"]``: 64 rounds, doubled while it fits
``XTPU_DART_CACHE_BYTES``, 2 GiB by default, as in the JAX package) as
one ``torch.einsum`` with the dropped (round, class) slots' weights; a
tree the ring does not hold (a loaded model's, or ``num_parallel_tree``
above 1) is walked over the bins (``boosting/predict.py
margin_binned``), or, under ``tree_method="approx"`` / ``"exact"``,
whose training matrix keeps no bins, over its raw values (kernel K1).
An evaluation set recomputes its margin over the whole
weighted forest whenever the forest changes (kernel K1). Vertical
federated parties (``GBTree.vertical``) hold only some of the features,
so every such walk goes through the parties' decision-bit protocol
(the Booster's ``state["vertical_walk"]``, ``tree/vertical.py
federated_vertical_margin``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..registry import BOOSTERS
from ..serve.packed import PackedForest
from ..tree.param import _f32
from .gbtree import GBTree
from .predict import margin_binned, stack_trees

_DART_KEYS = ("rate_drop", "one_drop", "skip_drop", "sample_type",
              "normalize_type")
RING_ROUNDS = 64


@BOOSTERS.register("dart")
class Dart(GBTree):
    name = "dart"
    supports_margin_cache = False

    def __init__(self, n_groups: int, num_parallel_tree: int = 1,
                 multi_strategy: str = "one_output_per_tree") -> None:
        super().__init__(n_groups, num_parallel_tree=num_parallel_tree,
                         multi_strategy=multi_strategy)
        self.rate_drop = 0.0
        self.one_drop = False
        self.skip_drop = 0.0
        self.sample_type = "uniform"
        self.normalize_type = "tree"
        self.weight_drop: List[float] = []
        self._dropped: List[int] = []
        self._drop_sum: Optional[torch.Tensor] = None
        self._rng: Optional[np.random.RandomState] = None
        self._ring_off = False      # set for good once past the budget

    def configure(self, params: Dict[str, Any], seed: int = 0) -> None:
        """Take the dart parameters from ``params``; the first call also
        seeds the drop stream."""
        for k in ("rate_drop", "skip_drop"):
            if k in params:
                setattr(self, k, float(params[k]))
        if "one_drop" in params:
            self.one_drop = str(params["one_drop"]).lower() in ("1", "true")
        for k in ("sample_type", "normalize_type"):
            if k in params:
                setattr(self, k, str(params[k]))
        if self.sample_type not in ("uniform", "weighted"):
            raise ValueError(f"unknown sample_type {self.sample_type!r}; "
                             "use 'uniform' or 'weighted'")
        if self.normalize_type not in ("tree", "forest"):
            raise ValueError(f"unknown normalize_type "
                             f"{self.normalize_type!r}; use 'tree' or "
                             "'forest'")
        if self._rng is None:
            self._rng = np.random.RandomState(int(seed) & 0xFFFFFFFF)

    def tree_weights(self) -> Optional[np.ndarray]:
        if not self.weight_drop:
            return None
        return np.asarray(self.weight_drop, dtype=np.float32)

    # -- dropout --------------------------------------------------------------
    def _select_drop(self) -> List[int]:
        """The trees to mute this round (reference ``DropTrees``), the JAX
        package's draws from this Booster's stream."""
        n = len(self.trees)
        if self._rng is None:
            self.configure({})
        if n == 0 or self._rng.rand() < self.skip_drop:
            return []
        if self.sample_type == "weighted":
            w = np.asarray(self.weight_drop, dtype=np.float64)
            p = w / w.sum() if w.sum() > 0 else None
            k = max(1, int(self.rate_drop * n)) if (
                self.one_drop or self.rate_drop > 0) else 0
            if k == 0:
                return []
            idx = self._rng.choice(n, size=min(k, n), replace=False, p=p)
            return sorted(int(i) for i in idx)
        mask = self._rng.rand(n) < self.rate_drop
        idx = [int(i) for i in np.nonzero(mask)[0]]
        if not idx and self.one_drop:
            idx = [int(self._rng.randint(n))]
        return idx

    # -- margins ----------------------------------------------------------------
    def training_margin(self, state: dict, walk: Callable) -> torch.Tensor:
        """Draw this round's drops; the training margin without them."""
        self._dropped = self._select_drop()
        self._drop_sum = None
        full = self.compute_margin(state, walk)
        if not self._dropped:
            return full
        self._drop_sum = self._subset_delta(state, self._dropped)
        return full - self._drop_sum

    def compute_margin(self, state: dict, walk: Callable) -> torch.Tensor:
        """The margin of every tree at its weight on the matrix of
        ``state`` (a Booster cache entry): the cached one while the trees
        and weights are those it holds; else the training matrix walked
        over its bins, another matrix through ``walk(state, lo, hi)``."""
        c = state.get("dart_margin")
        if (c is not None and c["n"] == len(self.trees)
                and np.array_equal(c["w"], np.asarray(self.weight_drop))):
            return c["m"]
        base = state["base"]
        if not self.trees:
            m = base
        elif (state["is_train"] and state["binned"] is not None
              and not self.vertical):
            m = base + self.margin_delta_binned(
                state["binned"], 0, len(self.trees), base.device)
        else:
            m = base + walk(state, 0, len(self.trees))
        self._store(state, m)
        return m

    def _store(self, state: dict, m: torch.Tensor) -> None:
        state["dart_margin"] = {
            "n": len(self.trees), "m": m,
            "w": np.asarray(self.weight_drop, np.float64).copy()}

    def _cached_drop_sum(self, state: dict, idx: List[int]
                         ) -> Optional[torch.Tensor]:
        """The dropped trees' margin from the ring, or None when it does
        not hold every one of them."""
        c = state.get("dart_deltas")
        if c is None or any(t not in c["tree_slot"] for t in idx):
            return None
        buf = c["buf"]
        R, _, K = buf.shape
        w = np.zeros((R, K), np.float32)
        wd = np.asarray(self.weight_drop, np.float32)
        for t in idx:
            slot, k = c["tree_slot"][t]
            w[slot, k] = wd[t]
        # one reduction over the whole ring: the slots not dropped weigh 0
        return torch.einsum("rnk,rk->nk", buf,
                            torch.from_numpy(w).to(buf.device))

    def _cache_round_delta(self, state: dict, delta: torch.Tensor,
                           start: int, n_new: int) -> None:
        """Append this round's unit delta [n, K] to the ring and map its
        trees to (slot, class). Only one tree per class a round fits the
        ring's decomposition."""
        if (self._ring_off or n_new != self.n_groups
                or self.num_parallel_tree != 1):
            state.pop("dart_deltas", None)
            return
        n, K = delta.shape
        budget = int(os.environ.get("XTPU_DART_CACHE_BYTES", 2 << 30))
        c = state.get("dart_deltas")
        if c is None or c["buf"].shape[1] != n:
            if RING_ROUNDS * n * K * 4 > budget:
                # too large to hold usefully: walk the dropped trees
                self._ring_off = True
                state.pop("dart_deltas", None)
                return
            c = state["dart_deltas"] = {
                "buf": torch.zeros((RING_ROUNDS, n, K), dtype=torch.float32,
                                   device=delta.device),
                "n_rounds": 0, "tree_slot": {}}
        slot = c["n_rounds"]
        R = c["buf"].shape[0]
        if slot == R:
            if 2 * R * n * K * 4 > budget:
                self._ring_off = True
                state.pop("dart_deltas", None)
                return
            c["buf"] = torch.cat([c["buf"], torch.zeros_like(c["buf"])])
        c["buf"][slot] = delta
        for j in range(n_new):
            c["tree_slot"][start + j] = (slot, int(self.tree_info[start + j]))
        c["n_rounds"] = slot + 1

    def _subset_delta(self, state: dict, idx: List[int]) -> torch.Tensor:
        """sum over t in ``idx`` of w_t * tree_t's margin [n, K] on the
        training matrix."""
        cached = self._cached_drop_sum(state, idx)
        if cached is not None:
            return cached
        binned = state["binned"]
        dev = state["base"].device
        w = np.asarray(self.weight_drop, np.float32)[idx]
        if self.vertical:       # the parties' decision-bit walk
            return state["vertical_walk"](idx, w)
        zero = torch.zeros(self.n_groups, dtype=torch.float32, device=dev)
        if binned is None:      # approx / exact: the raw values through K1
            return PackedForest.from_trees(
                [self.trees[i] for i in idx], [self.tree_info[i] for i in idx],
                self.n_groups, w).margin(state["X"], zero)
        forest = stack_trees([self.trees[i] for i in idx],
                             [self.tree_info[i] for i in idx], self.n_groups,
                             dev, w)
        if binned.is_paged:
            return self._margin_binned_paged(forest, binned, zero)
        return margin_binned(forest, binned.bins, binned.missing_bin, zero)

    def on_resume(self, state: dict) -> None:
        """A training snapshot's resume (``core.Booster._prime_resume``):
        its margin is the cached margin of the forest at its weights, and
        the ring of the rounds' unit deltas is rebuilt by walking each
        round's trees at weight 1 over the training bins, which gives the
        grown deltas bit for bit (one leaf a row and group), so that the
        resumed rounds take the straight run's drop sums (the JAX
        package's ``on_resume``)."""
        self._store(state, state["margin"])
        binned = state.get("binned")
        if self._ring_off or binned is None or self.vertical:
            return
        dev = state["base"].device
        zero = torch.zeros(self.n_groups, dtype=torch.float32, device=dev)
        for it in range(len(self.iteration_indptr) - 1):
            lo, hi = self.iteration_indptr[it], self.iteration_indptr[it + 1]
            if hi - lo != self.n_groups or self.num_parallel_tree != 1:
                state.pop("dart_deltas", None)
                return
            forest = stack_trees(self.trees[lo:hi], self.tree_info[lo:hi],
                                 self.n_groups, dev)
            if binned.is_paged:
                delta = self._margin_binned_paged(forest, binned, zero)
            else:
                delta = margin_binned(forest, binned.bins, binned.missing_bin,
                                      zero)
            self._cache_round_delta(state, delta, lo, hi - lo)

    # -- one round --------------------------------------------------------------
    def do_boost(self, binned, gpair: torch.Tensor, key,
                 state: Optional[dict] = None, **adaptive) -> torch.Tensor:
        """:meth:`GBTree.do_boost` from the gradients of
        :meth:`training_margin` (``adaptive``: its objective, that margin,
        labels and weights, for an adaptive-leaf objective's refresh),
        then the weights of the new and the dropped trees, and the
        training margin rolled forward in ``state``."""
        if state is None:
            raise ValueError("dart boosts with the Booster's cache entry of "
                             "the training matrix (state=)")
        start = len(self.trees)
        w_pre = np.asarray(self.weight_drop, np.float64).copy()
        delta = super().do_boost(binned, gpair, key, **adaptive)
        n_new = len(self.trees) - start
        self._cache_round_delta(state, delta, start, n_new)
        k = len(self._dropped)
        lr = self.tree_param.eta
        if k == 0:
            new_w, factor = 1.0, 1.0
        elif self.normalize_type == "forest":
            new_w = factor = 1.0 / (1.0 + lr)
        else:
            new_w = 1.0 / (k + lr)
            factor = k / (k + lr)
        for t in self._dropped:
            self.weight_drop[t] *= factor
        self.weight_drop.extend([new_w] * n_new)
        # the closed form, from the margin of the trees before this round
        # at their weights before it
        c = state.get("dart_margin")
        if c is not None and c["n"] == start and np.array_equal(c["w"],
                                                               w_pre):
            m = c["m"]
            if k:
                m = m + _f32(factor - 1.0) * self._drop_sum
            self._store(state, m + _f32(new_w) * delta)
        self._dropped = []
        self._drop_sum = None
        return delta

    def slice_rounds(self, rounds) -> "Dart":
        """:meth:`GBTree.slice_rounds` with the trees' weights and the
        dart parameters."""
        rounds = list(rounds)
        new = super().slice_rounds(rounds)
        for k in _DART_KEYS:
            setattr(new, k, getattr(self, k))
        for it in rounds:
            lo, hi = self.iteration_indptr[it], self.iteration_indptr[it + 1]
            new.weight_drop.extend(self.weight_drop[lo:hi])
        return new

    # -- serialisation ----------------------------------------------------------
    def to_json(self) -> dict:
        obj = super().to_json()
        obj["weight_drop"] = list(self.weight_drop)
        return obj

    def from_json(self, obj: dict) -> None:
        super().from_json(obj)
        self.weight_drop = [float(w) for w in obj.get(
            "weight_drop", [1.0] * len(self.trees))]
