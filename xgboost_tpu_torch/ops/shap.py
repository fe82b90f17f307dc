"""TreeSHAP on the booster's device: exact and conditional per-leaf
contributions, interactions and Saabas contributions, as torch ops in
float64.

The port of the JAX package's ``ops/shap.py`` (the per-leaf form of
GPUTreeShap). For each (tree, leaf) the root-to-leaf path is laid out
ahead of time (:func:`build_shap_pack`, once a forest, on the host) as
up to K unique-feature slots: a feature's repeated splits multiply into
one zero fraction (the product of their cover ratios, f64) and, per
row, one one-fraction (1 when the row follows every one of its edges),
which is what the reference's unwind and re-extend compute. A row's
only part is that indicator; the device then runs Lundberg's extend and
unwound-sum recurrences over [rows, trees, L, K] (:func:`_unwound_sums`)
and reduces each leaf's terms onto the features by one-hot products,
so the sums are in a fixed order on every device. Two identities keep
the shapes static: the path polynomial is symmetric in its slots, and a
slot with zero = one = 1 leaves every other slot's unwound sum
unchanged, so short paths pad to K with such slots.

- :func:`contribs`: φ [n, G, F + 1], the last column the forest's
  cover-weighted mean plus the base score, so a row sums to its margin.
- :func:`interactions`: conditioning on slot j is the same recurrence
  with j's slot set to (1, 1), its term scaled by j's one-indicator
  (present) or its zero fraction (absent); half their difference is
  ``0.5 (o_j - z_j)`` times the leaf's unconditioned-on-j term, which is
  computed for every j at once ([rows, trees, L, K, K]) rather than
  one pass a feature. The diagonal and the bias row are what is left
  of φ, as in the reference.
- :func:`saabas`: the approximate contributions, each row's path walked
  level by level, ``mean(child) - mean(node)`` credited to the split
  feature (reference ``approximate=True``).

The recurrences run in float64 on every device (the host recursion
``boosting/shap.py`` is the plain version the tests hold this against);
``Booster.predict`` casts the result to float32. Rows and trees are cut
into chunks so that the largest [rows, trees, L, ..] tensor stays under
``SHAP_CHUNK_BYTES``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..boosting.predict import _raw_step, stack_trees
from ..boosting.shap import forest_arrays, node_means
from ..tree.tree import TreeModel

# the largest f64 tensor of one chunk (rows x trees x leaves x slots ...)
SHAP_CHUNK_BYTES = 1 << 28
# trees a chunk
SHAP_TREE_CHUNK = 16


class ShapPack:
    """The per-leaf path tables of one forest (host numpy) and their
    copies on each device. Axes: T trees, L the most leaves of a tree,
    D the longest path, K the most unique features on a path."""

    def __init__(self, arrays: Dict[str, np.ndarray], n_groups: int,
                 bias_shap: np.ndarray, bias_mean: np.ndarray,
                 trees, tree_info, tree_weights) -> None:
        self.arrays = arrays
        self.n_groups = int(n_groups)
        self.bias_shap = bias_shap   # [G] f64: Σ mean * weight, tree order
        self.bias_mean = bias_mean   # [T] f64: each tree's mean * weight
        self.T, self.L, self.D = arrays["occ_feat"].shape
        self.K = arrays["slot_z"].shape[2]
        self._trees = (trees, tree_info, tree_weights)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._stacked: Dict[str, object] = {}

    def device_arrays(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {k: torch.from_numpy(v).to(device)
                              for k, v in self.arrays.items()}
        return self._dev[key]

    def stacked(self, device: torch.device):
        """The trees as a ``StackedForest`` on ``device`` (Saabas's walk),
        beside each node's mean [T * M] f64."""
        key = str(device)
        if key not in self._stacked:
            trees, info, w = self._trees
            f = stack_trees(trees, info, self.n_groups, device, w)
            means = torch.from_numpy(self.arrays["node_mean"].reshape(-1))
            self._stacked[key] = (f, means.to(device))
        return self._stacked[key]

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.arrays.values())


def _slots(occ_feat: np.ndarray, occ_valid: np.ndarray):
    """Each occurrence's slot (the rank of its feature's first occurrence
    on the path; K for padding) and the slot count K."""
    D = occ_feat.shape[-1]
    f = np.where(occ_valid, occ_feat, -1)
    eq = (f[..., :, None] == f[..., None, :]) & occ_valid[..., :, None] \
        & occ_valid[..., None, :]
    earlier = np.tril(np.ones((D, D), bool), -1)
    first = occ_valid & ~(eq & earlier).any(-1)
    rank = np.cumsum(first, axis=-1) - 1
    K = max(1, int(first.sum(-1).max(initial=0)))
    slot = np.take_along_axis(rank, np.argmax(eq, axis=-1), -1)
    return np.where(occ_valid, slot, K), K


def build_shap_pack(trees: Sequence[TreeModel], tree_info: np.ndarray,
                    tree_weights: Optional[np.ndarray], n_groups: int
                    ) -> ShapPack:
    """Lay every (tree, leaf) path of a forest out into the static tables
    of the recurrences (host numpy, vectorised over trees and leaves)."""
    arr = forest_arrays(trees)
    T, M = arr["is_leaf"].shape
    rows = np.arange(T)[:, None]
    real = np.arange(M)[None, :] < np.asarray(
        [t.num_nodes() for t in trees])[:, None]
    depth = np.zeros((T, M), np.int64)
    for i in range(1, M):
        depth[:, i] = np.where(real[:, i],
                               depth[rows[:, 0],
                                     np.maximum(arr["parent"][:, i], 0)] + 1,
                               0)
    is_leaf = arr["is_leaf"] & real
    L = int(is_leaf.sum(1).max())
    order = np.argsort(~is_leaf, axis=1, kind="stable")[:, :L]
    leaf_valid = np.take_along_axis(is_leaf, order, 1)
    leaf_nid = np.where(leaf_valid, order, 0)
    D = max(1, int((depth[rows, leaf_nid] * leaf_valid).max(initial=0)))
    W = arr["cat_words"].shape[-1]
    sh = arr["sum_hess"].astype(np.float64)

    occ_feat = np.zeros((T, L, D), np.int64)
    occ_sv = np.zeros((T, L, D), np.float32)
    occ_dl = np.zeros((T, L, D), bool)
    occ_cat = np.zeros((T, L, D), bool)
    occ_cw = np.zeros((T, L, D, W), np.int64)
    occ_hot_left = np.zeros((T, L, D), bool)
    occ_valid = np.zeros((T, L, D), bool)
    occ_z = np.ones((T, L, D), np.float64)
    cur = leaf_nid.copy()
    for _ in range(D):
        dcur = depth[rows, cur]
        live = leaf_valid & (dcur > 0)
        if not live.any():
            break
        p = np.where(live, arr["parent"][rows, cur], 0)
        ti, li = np.nonzero(live)
        o, pp, cc = dcur[live] - 1, p[live], cur[live]
        occ_feat[ti, li, o] = arr["split_feature"][ti, pp]
        occ_sv[ti, li, o] = arr["split_value"][ti, pp]
        occ_dl[ti, li, o] = arr["default_left"][ti, pp]
        occ_cat[ti, li, o] = arr["is_cat_split"][ti, pp]
        occ_cw[ti, li, o] = arr["cat_words"][ti, pp]
        occ_hot_left[ti, li, o] = arr["left_child"][ti, pp] == cc
        occ_valid[ti, li, o] = True
        cover = sh[ti, pp]
        occ_z[ti, li, o] = np.where(
            cover > 0, sh[ti, cc] / np.where(cover > 0, cover, 1.0), 0.0)
        cur = np.where(live, p, cur)

    occ_slot, K = _slots(occ_feat, occ_valid)
    slot_z = np.ones((T, L, K + 1), np.float64)
    slot_feat = np.zeros((T, L, K + 1), np.int64)
    slot_valid = np.zeros((T, L, K + 1), bool)
    for o in range(D):          # root first: the host's product order
        ti, li = np.nonzero(occ_valid[..., o])
        k = occ_slot[ti, li, o]
        slot_z[ti, li, k] *= occ_z[ti, li, o]
        slot_feat[ti, li, k] = occ_feat[ti, li, o]
        slot_valid[ti, li, k] = True

    w = (np.ones(T, np.float32) if tree_weights is None
         else np.asarray(tree_weights, np.float32)).astype(np.float64)
    mean = node_means(arr)
    tg = np.asarray(tree_info, np.int64)
    bias_shap = np.zeros(n_groups, np.float64)
    for t in range(T):                       # the host's order
        bias_shap[tg[t]] += mean[t, 0] * w[t]
    arrays = dict(
        occ_feat=occ_feat, occ_sv=occ_sv, occ_dl=occ_dl,
        occ_hot_left=occ_hot_left, occ_valid=occ_valid, occ_slot=occ_slot,
        slot_z=slot_z[..., :K], slot_feat=slot_feat[..., :K],
        slot_valid=slot_valid[..., :K],
        leaf_value=np.take_along_axis(arr["leaf_value"], leaf_nid,
                                      1).astype(np.float64),
        leaf_valid=leaf_valid, tree_group=tg, tree_weight=w,
        node_mean=mean)
    if occ_cat.any():
        arrays["occ_cat"] = occ_cat
        arrays["occ_cw"] = occ_cw
    return ShapPack(arrays, n_groups, bias_shap,
                    mean[:, 0] * w, list(trees), tg, tree_weights)


def _follows(X: torch.Tensor, a: Dict[str, torch.Tensor], sl: slice
             ) -> torch.Tensor:
    """[n, C, L, D]: does each row follow each path edge (padding edges
    count as followed)? NaN goes the default way; at a categorical split
    the left set's bit, a code out of range the default way; else
    ``not (x > split)``."""
    x = X[:, a["occ_feat"][sl]]
    miss = torch.isnan(x)
    dl = a["occ_dl"][sl]
    left = ~(x > a["occ_sv"][sl])
    if "occ_cw" in a:
        cw = a["occ_cw"][sl]
        W = cw.shape[-1]
        code = torch.where(miss, torch.full_like(x, -1.0), x).to(torch.int64)
        in_range = (code >= 0) & (code < W * 32)
        cc = code.clamp(0, W * 32 - 1)
        base = torch.arange(cw[..., 0].numel(), device=X.device).reshape(
            cw.shape[:-1]) * W
        word = cw.reshape(-1)[base + cc // 32]
        bit = ((word >> (cc % 32)) & 1) == 1
        left = torch.where(a["occ_cat"][sl], torch.where(in_range, bit, dl),
                           left)
    left = torch.where(miss, dl, left)
    return (left == a["occ_hot_left"][sl]) | ~a["occ_valid"][sl]


def _one_fractions(X: torch.Tensor, a: Dict[str, torch.Tensor], sl: slice,
                   K: int) -> torch.Tensor:
    """[n, C, L, K] f64: 1 where the row follows every edge of the slot's
    feature on the path (padding slots 1)."""
    fol = _follows(X, a, sl).to(torch.float64)
    n, C, L, D = fol.shape
    o = torch.ones((n, C, L, K + 1), dtype=torch.float64, device=X.device)
    idx = a["occ_slot"][sl][None].expand(n, C, L, D)
    o.scatter_reduce_(3, idx, fol, reduce="amin")
    return o[..., :K]


def _unwound_sums(z: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Extend the path polynomial with every slot (z, o) [..., K], then
    each slot's unwound sum [..., K] (reference ``ExtendPath`` and
    ``UnwoundPathSum`` at d = K)."""
    K = z.shape[-1]
    kidx = torch.arange(K + 1, dtype=torch.float64, device=z.device)
    pw = torch.zeros(z.shape[:-1] + (K + 1,), dtype=torch.float64,
                     device=z.device)
    pw[..., 0] = 1.0
    zero = torch.zeros_like(pw[..., :1])
    for j in range(K):
        d = j + 1
        shifted = torch.cat([zero, pw[..., :-1]], dim=-1)
        pw = (z[..., j:j + 1] * pw * (d - kidx) / (d + 1)
              + o[..., j:j + 1] * shifted * kidx / (d + 1))
    o_safe = torch.where(o == 0, torch.ones_like(o), o)
    z_safe = torch.where(z == 0, torch.ones_like(z), z)
    nxt = pw[..., K:K + 1].expand_as(o)
    hot = torch.zeros_like(o)
    cold = torch.zeros_like(o)
    for i in range(K - 1, -1, -1):
        t = nxt / ((i + 1) * o_safe)
        hot = hot + t
        nxt = pw[..., i:i + 1] - t * z * (K - i)
        cold = cold + pw[..., i:i + 1] / (z_safe * (K - i))
    return torch.where(o != 0, hot, cold) * (K + 1)


def _leaf_scale(a: Dict[str, torch.Tensor], sl: slice) -> torch.Tensor:
    """[C, L] f64 leaf value times tree weight, 0 at padding leaves."""
    lv = a["leaf_value"][sl] * a["tree_weight"][sl][:, None]
    return torch.where(a["leaf_valid"][sl], lv, torch.zeros_like(lv))


def _feature_onehot(a: Dict[str, torch.Tensor], sl: slice, F: int
                    ) -> torch.Tensor:
    """[C, L, K, F + 1] f64: each valid slot's feature."""
    feat = torch.where(a["slot_valid"][sl], a["slot_feat"][sl],
                       torch.full_like(a["slot_feat"][sl], F + 1))
    return torch.nn.functional.one_hot(feat, F + 2)[..., :F + 1].to(
        torch.float64)


def _group_onehot(a: Dict[str, torch.Tensor], sl: slice, G: int
                  ) -> torch.Tensor:
    return torch.nn.functional.one_hot(a["tree_group"][sl], G).to(
        torch.float64)


def _chunks(pack: ShapPack, n: int, per_pair: int):
    """(tree slice, row ranges) pairs whose largest tensor, ``per_pair``
    f64 values a (row, tree), stays under ``SHAP_CHUNK_BYTES``."""
    C = min(SHAP_TREE_CHUNK, pack.T)
    rows = max(1, SHAP_CHUNK_BYTES // (8 * C * per_pair))
    for t0 in range(0, pack.T, C):
        sl = slice(t0, min(pack.T, t0 + C))
        for r0 in range(0, n, rows):
            yield sl, r0, min(n, r0 + rows)


def contribs(pack: ShapPack, X: torch.Tensor, base: np.ndarray
             ) -> torch.Tensor:
    """φ [n, G, F + 1] f64 of X [n, F] f32 (NaN missing) on X's device;
    the bias column the forest's cover-weighted mean plus ``base`` [G]."""
    n, F = X.shape
    G, K, L = pack.n_groups, pack.K, pack.L
    dev = X.device
    out = torch.zeros((n, G, F + 1), dtype=torch.float64, device=dev)
    out[:, :, F] = torch.from_numpy(
        pack.bias_shap + np.asarray(base, np.float64)).to(dev)
    if n == 0:
        return out
    a = pack.device_arrays(dev)
    for sl, r0, r1 in _chunks(pack, n, L * (K + 1)):
        Xc = X[r0:r1]
        o = _one_fractions(Xc, a, sl, K)
        z = a["slot_z"][sl][None].expand_as(o)
        term = _unwound_sums(z, o) * (o - z) * _leaf_scale(a, sl)[None, ...,
                                                                   None]
        C = term.shape[1]
        per_tree = torch.bmm(term.reshape(-1, C, L * K).transpose(0, 1),
                             _feature_onehot(a, sl, F).reshape(C, L * K,
                                                               F + 1))
        out[r0:r1] += torch.einsum("cnf,cg->ngf", per_tree,
                                   _group_onehot(a, sl, G))
    return out


def interactions(pack: ShapPack, X: torch.Tensor, base: np.ndarray,
                 phi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Interaction values [n, G, F + 1, F + 1] f64 (the JAX package's
    ``shap_interactions``); ``phi``: :func:`contribs` of X when the caller
    has it."""
    n, F = X.shape
    G, K, L = pack.n_groups, pack.K, pack.L
    dev = X.device
    if phi is None:
        phi = contribs(pack, X, base)
    out = torch.zeros((n, G, F + 1, F + 1), dtype=torch.float64, device=dev)
    a = pack.device_arrays(dev) if n else None
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    for sl, r0, r1 in (_chunks(pack, n, L * K * (K + 1) + L * K * (F + 1))
                       if n else ()):
        Xc = X[r0:r1]
        o = _one_fractions(Xc, a, sl, K)
        z = a["slot_z"][sl][None].expand_as(o)
        # [n, C, L, J, K]: slot j conditioned on, i.e. set to (1, 1)
        oj = torch.where(eye, torch.ones_like(o[..., None, :]),
                         o[..., None, :].expand(o.shape + (K,)))
        zj = torch.where(eye, torch.ones_like(z[..., None, :]),
                         z[..., None, :].expand(z.shape + (K,)))
        term = _unwound_sums(zj, oj) * (oj - zj) \
            * (0.5 * (o - z) * _leaf_scale(a, sl)[None, ..., None])[..., None]
        P = _feature_onehot(a, sl, F)                     # [C, L, K, F+1]
        by_k = torch.einsum("cnljk,clkf->cnljf", term.transpose(0, 1), P)
        per_tree = torch.einsum("cljg,cnljf->cngf", P, by_k)
        out[r0:r1] += torch.einsum("cngf,ch->nhgf", per_tree,
                                   _group_onehot(a, sl, G))
    idx = torch.arange(F, device=dev)
    diag = phi[..., :F] - out[..., :F, :].sum(dim=3)
    out[:, :, idx, idx] = diag
    out[:, :, F, :F] = phi[..., :F] - out[:, :, :F, :F].sum(dim=2)
    out[:, :, F, F] = phi[..., F]
    return out


def saabas(pack: ShapPack, X: torch.Tensor, base: np.ndarray
           ) -> torch.Tensor:
    """Approximate contributions [n, G, F + 1] f64: each row's path walked
    level by level on X's device, ``mean(child) - mean(node)`` times the
    tree's weight credited to the node's split feature."""
    n, F = X.shape
    G, dev = pack.n_groups, X.device
    out = torch.zeros((n, G, F + 1), dtype=torch.float64, device=dev)
    bias = np.asarray(base, np.float64).copy()
    for t, g in enumerate(pack.arrays["tree_group"]):   # the host's order
        bias[g] += pack.bias_mean[t]
    out[:, :, F] = torch.from_numpy(bias).to(dev)
    if n == 0 or pack.T == 0:
        return out
    forest, means = pack.stacked(dev)
    M = forest.n_nodes
    tw = torch.from_numpy(pack.arrays["tree_weight"]).to(dev)
    onehot = forest.group_onehot.to(torch.float64)
    C = min(SHAP_TREE_CHUNK, pack.T)
    rows = max(1, SHAP_CHUNK_BYTES // (8 * C * (F + 1)))
    for t0 in range(0, pack.T, C):
        t1 = min(pack.T, t0 + C)
        tofs = (torch.arange(t0, t1, device=dev) * M)[None, :]
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            step = _raw_step(forest, X[r0:r1])
            acc = torch.zeros((r1 - r0, t1 - t0, F + 1), dtype=torch.float64,
                              device=dev)
            pos = torch.zeros((r1 - r0, t1 - t0), dtype=torch.int64,
                              device=dev)
            for _ in range(forest.max_depth):
                gi = tofs + pos
                act = ~forest.is_leaf[gi]
                child = torch.where(step(gi), forest.right_child[gi],
                                    forest.left_child[gi]).clamp(min=0)
                delta = (means[tofs + child] - means[gi]) * tw[None, t0:t1]
                delta = torch.where(act, delta, torch.zeros_like(delta))
                fid = forest.split_feature[gi].clamp(min=0)
                acc.scatter_add_(2, fid[..., None], delta[..., None])
                pos = torch.where(act, child, pos)
            out[r0:r1] += torch.einsum("ncf,cg->ngf", acc, onehot[t0:t1])
    return out
