"""LambdaRank objectives: ``rank:ndcg``, ``rank:pairwise``, ``rank:map``.

The JAX package's ``objective/ranking.py`` device path (reference
``src/objective/lambdarank_obj.cc``), as torch ops on the Booster's
device. A query's documents are the rows between two of the matrix's
query offsets (``MetaInfo.group_ptr``). The queries are padded into a
[G, L] matrix (L the longest query; pads score -inf and sort last);
each query's ranks come from a stable argsort of its scores. Pairs
(i, j) with different labels get the RankNet lambda ``-p * |delta|``,
``p = 1 / (1 + exp(clip(s_hi - s_lo, -50, 50)))``, and the hessian
``max(p (1 - p) |delta|, 1e-16)``; ``delta`` is the change of NDCG
(``rank:ndcg``), of average precision over binary labels (``rank:map``)
or 1 (``rank:pairwise``) when the two swap ranks. Like the JAX package,
the lambdas follow the LambdaMART paper without the reference's
empirical scalings.

Two ways to choose the pairs (``lambdarank_pair_method``):

- ``mean`` (the default): each document draws
  ``lambdarank_num_pair_per_sample`` (k, default 1) rivals uniformly
  among its query's documents of another label, a [C, L, k] tensor per
  chunk of C queries. The draws are the JAX package's bit for bit: the
  round's key ``fold_in(key(seed), iteration)``, split once a chunk, and
  the chunk ``min(G, 2^24 // (L k))`` queries (``utils/random.py``). A
  rival's lambda goes back to it through a sum whose order is fixed (a
  stable sort by target and a per-target sum), so two runs on the card
  give the same bits.
- ``topk``: every document ranked below k (all when k is 0, the
  default) against every other document of its query, a [C, L, L]
  tensor per chunk. Each query's sums stay within its chunk, so the
  chunk is free: :data:`TOPK_PAIRS_CUDA` pairs on the card (about 0.5 GB
  for each f32 temporary, a dozen of them at the peak), the JAX
  package's 2^24 on the CPU.

``lambdarank_unbiased`` (unbiased LambdaMART, reference
``lambdarank_obj.h``): each pair's lambda and hessian are divided by
``ti+[pos_hi] * tj-[pos_lo]`` (positions in the input order, the first
``kpos`` of them: k under ``topk``, else min(L, 32)); the pairs' costs
per position, summed on the device, update ti+ / tj- after the round.
They are read back lazily, when the next round or the model's JSON
needs them. ``to_json`` / ``configure`` carry ``ti_plus`` / ``tj_minus``.

The JAX package's per-query numpy loop (its oracle, ``XTPU_RANK_HOST=1``)
is not ported.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import random as xrandom
from .base import Objective, guard_gradient, register

# the topk chunk's pairs (C L^2) on the card; the CPU keeps the JAX
# package's budget
TOPK_PAIRS_CUDA = 1 << 27
TOPK_PAIRS_CPU = 1 << 24
# the mean chunk's draws (C L k): the JAX package's, which fixes the
# random stream
MEAN_DRAWS = 1 << 24
_EPS64 = float(np.finfo(np.float64).eps)


def _gains(v: torch.Tensor, exp_gain: bool) -> torch.Tensor:
    return torch.exp2(v) - 1.0 if exp_gain else v


def _rank_of(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of each row of ``order``."""
    iota = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, iota)


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Stable argsort of each row, largest first (a -0.0 made +0.0, so
    that zeros of both signs tie as they do in the JAX package)."""
    return torch.argsort(-x + 0.0, dim=1, stable=True)


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a`` [C, L] at ``idx`` [C, ...] along the query's row."""
    return torch.gather(a, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def _map_prefix(yp, vp, order, L):
    """Each query's MAP prefix statistics in rank order: C_k (relevant
    documents in the top k + 1), T0 (the shifted sum of rel / (rank + 1),
    T0[0] = 0) and R (relevant documents, at least 1)."""
    yb = ((yp > 0) & vp).to(torch.float32)
    rel_rank = torch.gather(yb, 1, order)
    Ck = torch.cumsum(rel_rank, dim=1)
    T = torch.cumsum(rel_rank / (torch.arange(
        L, dtype=torch.float32, device=yp.device) + 1.0), dim=1)
    T0 = torch.cat([torch.zeros_like(T[:, :1]), T], dim=1)
    R = torch.clamp(Ck[:, -1], min=1.0)
    return Ck, T0, R


def _map_delta(rank_i, rank_j, a_is_i, Ck, T0, R):
    """|delta AP| for swapping the relevant one of documents i, j with the
    other."""
    r_rel = torch.where(a_is_i, rank_i, rank_j)
    r_irr = torch.where(a_is_i, rank_j, rank_i)
    u = torch.minimum(r_rel, r_irr)
    v = torch.maximum(r_rel, r_irr)
    Cu, Cv = _gather(Ck, u), _gather(Ck, v)
    Tv1 = _gather(T0, v)            # T[v - 1]
    Tu = _gather(T0, u + 1)         # T[u]
    Tu1 = _gather(T0, u)            # T[u - 1]
    uf = u.to(torch.float32)
    vf = v.to(torch.float32)
    d_down = Cv / (vf + 1.0) - Cu / (uf + 1.0) - (Tv1 - Tu)
    d_up = (Cu + 1.0) / (uf + 1.0) - Cv / (vf + 1.0) + (Tv1 - Tu1)
    extra = (1,) * (u.dim() - 1)
    return torch.abs(torch.where(r_rel < r_irr, d_down, d_up)) \
        / R.reshape(-1, *extra)


def _delta(objective, *, yp, vp, order, L, gv, dv, inv_idcg, gj, dj,
           rank_i, rank_j, a_is_i):
    """The metric change of a pair tensor (|dNDCG|, |dAP| or 1); ``gj`` /
    ``dj`` / ``rank_j`` already gathered to the pair shape."""
    if objective == "pairwise":
        return 1.0
    if objective == "map":
        return _map_delta(rank_i, rank_j, a_is_i, *_map_prefix(yp, vp, order,
                                                               L))
    return torch.abs((gv[:, :, None] - gj) * (dv[:, :, None] - dj)) \
        * inv_idcg[:, None, None]


def _ranknet(s_i, s_j, a_is_i, delta, mask):
    """RankNet lambda and hessian of oriented pairs (the higher label
    first), and the sigmoid ``p`` the unbiased costs take."""
    sij = torch.where(a_is_i, s_i - s_j, s_j - s_i)
    p = 1.0 / (1.0 + torch.exp(torch.clamp(sij, -50.0, 50.0)))
    lam = torch.where(mask, -p * delta, 0.0)
    hes = torch.where(mask, torch.clamp(p * (1.0 - p) * delta, min=1e-16),
                      0.0)
    return lam, hes, p


def _debias(lam, hes, p, delta, mask, i_pos, j_pos, ti, tj, kpos):
    """Unbiased LambdaMART: scale each pair by 1 / (ti+[pos_i] tj-[pos_j])
    where both positions are below ``kpos`` and both estimates at least
    float64's eps (else the pair passes unscaled and costs nothing);
    returns (lam, hes, cost / tj-, cost / ti+)."""
    tpi = ti[torch.clamp(i_pos, max=kpos - 1)]
    tmj = tj[torch.clamp(j_pos, max=kpos - 1)]
    ok = mask & (i_pos < kpos) & (j_pos < kpos) & (tpi >= _EPS64) \
        & (tmj >= _EPS64)
    scale = torch.where(ok, tpi * tmj, 1.0)
    cost = torch.where(ok, torch.log(1.0 / torch.clamp(p, min=1e-30))
                       * delta, 0.0)
    return (lam / scale, hes / scale, cost / torch.clamp(tmj, min=_EPS64),
            cost / torch.clamp(tpi, min=_EPS64))


def ordered_scatter_sum(index: torch.Tensor, values: torch.Tensor,
                        size: int) -> torch.Tensor:
    """[size, d]: the rows of ``values`` [m, d] summed at ``index`` [m], in
    one fixed order on every device (the rows sorted stably by target,
    then each target's run added in that order), so the result does not
    depend on the order of atomic adds."""
    perm = torch.sort(index, stable=True).indices
    counts = torch.bincount(index, minlength=size)
    return torch.segment_reduce(values[perm], "sum", lengths=counts,
                                axis=0, unsafe=True)


def _padded(s, lay, Gp):
    """Scores (-inf pads), labels and the valid mask as [Gp, L]."""
    L, dev = lay["L"], s.device
    qidx, slot = lay["qidx"], lay["slot"]
    s_pad = torch.full((Gp, L), -float("inf"), dtype=torch.float32,
                       device=dev)
    s_pad[qidx, slot] = s
    y_pad = torch.zeros((Gp, L), dtype=torch.float32, device=dev)
    y_pad[qidx, slot] = lay["y"]
    valid = torch.zeros((Gp, L), dtype=torch.bool, device=dev)
    valid[qidx, slot] = True
    sz = torch.zeros((Gp,), dtype=torch.int64, device=dev)
    sz[:lay["G"]] = lay["sizes"]
    return s_pad, y_pad, valid, sz


def _query_stats(sp, yp, disc, exp_gain):
    """(order, rank_of, inv_idcg, gains, discounts) of a chunk's queries."""
    order = _desc_order(sp)
    rank_of = _rank_of(order)
    y_desc = torch.sort(yp, dim=1, descending=True).values
    idcg = torch.sum(_gains(y_desc, exp_gain) * disc[None, :], dim=1)
    inv_idcg = torch.where(idcg > 0, 1.0 / idcg, 0.0)
    return order, rank_of, inv_idcg, _gains(yp, exp_gain), disc[rank_of]


def _finish(g_pad, h_pad, li_s, lj_s, lay, kpos):
    """[n, 1, 2] (grad, hess) by row, weighted; the positions' costs."""
    qidx, slot, w_row = lay["qidx"], lay["slot"], lay["w_row"]
    L = g_pad.shape[1]
    g = g_pad[qidx, slot] * w_row
    h = h_pad[qidx, slot] * w_row
    gpair = torch.stack([g, h], dim=-1)[:, None, :]
    if kpos <= 0:
        return gpair, None, None
    m = min(kpos, L)
    li = torch.zeros((kpos,), dtype=torch.float32, device=g.device)
    lj = torch.zeros_like(li)
    li[:m] = torch.stack(li_s).sum(dim=0)[:m]
    lj[:m] = torch.stack(lj_s).sum(dim=0)[:m]
    return gpair, li, lj


def lambda_grad_topk(s, lay, *, kcap, exp_gain, objective, chunk, kpos=0,
                     ti=None, tj=None):
    """All-pairs lambdas (the JAX package's ``_lambda_grad_device``):
    each document ranked below ``kcap`` (all for 0) anchors a pair with
    every other document of its query. Returns ([n, 1, 2], li, lj), the
    last two None unless ``kpos`` > 0 (unbiased)."""
    G, L, dev = lay["G"], lay["L"], s.device
    Gp = -(-G // chunk) * chunk
    s_pad, y_pad, valid, sz = _padded(s, lay, Gp)
    kc = sz if kcap == 0 else torch.clamp(sz, max=kcap)
    pos = torch.arange(L, device=dev)
    disc = 1.0 / torch.log2(pos.to(torch.float32) + 2.0)
    g_out, h_out, li_s, lj_s = [], [], [], []
    for a in range(0, Gp, chunk):
        sp, yp, vp = s_pad[a:a + chunk], y_pad[a:a + chunk], \
            valid[a:a + chunk]
        C = sp.shape[0]
        order, rank_of, inv_idcg, gv, dv = _query_stats(sp, yp, disc,
                                                        exp_gain)
        yi, yj = yp[:, :, None], yp[:, None, :]
        mask = (vp[:, :, None] & vp[:, None, :] & (yi != yj)
                & (rank_of < kc[a:a + chunk, None])[:, :, None])
        a_is_i = yi > yj
        delta = _delta(objective, yp=yp, vp=vp, order=order, L=L, gv=gv,
                       dv=dv, inv_idcg=inv_idcg, gj=gv[:, None, :],
                       dj=dv[:, None, :],
                       rank_i=rank_of[:, :, None].expand(C, L, L),
                       rank_j=rank_of[:, None, :].expand(C, L, L),
                       a_is_i=a_is_i)
        lam, hes, p = _ranknet(sp[:, :, None], sp[:, None, :], a_is_i, delta,
                               mask)
        if kpos > 0:        # slots are the input positions
            i_pos = torch.where(a_is_i, pos[None, :, None], pos[None, None, :])
            j_pos = torch.where(a_is_i, pos[None, None, :], pos[None, :, None])
            lam, hes, ci, cj = _debias(lam, hes, p, delta, mask, i_pos,
                                       j_pos, ti, tj, kpos)
            li_s.append(torch.where(a_is_i, ci, 0.0).sum(dim=2).sum(dim=0)
                        + torch.where(~a_is_i, ci, 0.0).sum(dim=1).sum(dim=0))
            lj_s.append(torch.where(~a_is_i, cj, 0.0).sum(dim=2).sum(dim=0)
                        + torch.where(a_is_i, cj, 0.0).sum(dim=1).sum(dim=0))
        g_out.append(torch.where(a_is_i, lam, -lam).sum(dim=2)
                     + torch.where(a_is_i, -lam, lam).sum(dim=1))
        h_out.append(hes.sum(dim=2) + hes.sum(dim=1))
    return _finish(torch.cat(g_out), torch.cat(h_out), li_s, lj_s, lay, kpos)


def draw_rivals(key_words, n_lefts, n_geq, szc, y_order, k):
    """[C, L, k] rival slots of a chunk's documents: each uniform among
    its query's documents of another label (``n_lefts``: of a higher
    label, ``n_geq``: of at least its label, ``y_order``: the documents
    by label, highest first), from the chunk's key words [2]. Also the
    rival counts [C, L]."""
    C, L = n_lefts.shape
    n_riv = n_lefts + (szc[:, None] - n_geq)
    u = (xrandom.uniform(key_words, (C, L, k))
         * n_riv[:, :, None].to(torch.float32)).to(torch.int64)
    u = torch.minimum(torch.clamp(u, min=0),
                      torch.clamp(n_riv - 1, min=0)[:, :, None])
    nl = n_lefts[:, :, None]
    ridx = torch.where(u < nl, u, u - nl + n_geq[:, :, None])
    return _gather(y_order, ridx), n_riv


def lambda_grad_mean(s, lay, key, *, k, exp_gain, objective, chunk, kpos=0,
                     ti=None, tj=None):
    """Sampled-pair lambdas (the JAX package's
    ``_lambda_grad_device_mean``): each document draws ``k`` rivals of
    another label from its query (:func:`draw_rivals`, chunk c under key
    ``split(key, Gp // chunk)[c]``). Returns ([n, 1, 2], li, lj) as
    :func:`lambda_grad_topk`."""
    G, L, dev = lay["G"], lay["L"], s.device
    Gp = -(-G // chunk) * chunk
    s_pad, y_pad, valid, sz = _padded(s, lay, Gp)
    stats = []
    for name in ("y_order", "n_lefts", "n_geq"):
        t = torch.zeros((Gp, L), dtype=torch.int64, device=dev)
        t[:G] = lay[name]
        stats.append(t)
    pos = torch.arange(L, device=dev)
    disc = 1.0 / torch.log2(pos.to(torch.float32) + 2.0)
    keys = xrandom.split(key, Gp // chunk, dev)
    g_out, h_out, li_s, lj_s = [], [], [], []
    for c, a in enumerate(range(0, Gp, chunk)):
        sp, yp, vp = s_pad[a:a + chunk], y_pad[a:a + chunk], \
            valid[a:a + chunk]
        y_order, n_lefts, n_geq = (t[a:a + chunk] for t in stats)
        C = sp.shape[0]
        order, rank_of, inv_idcg, gv, dv = _query_stats(sp, yp, disc,
                                                        exp_gain)
        rival, n_riv = draw_rivals(keys[c], n_lefts, n_geq, sz[a:a + chunk],
                                   y_order, k)
        pair_ok = vp[:, :, None] & (n_riv[:, :, None] > 0)
        yj = _gather(yp, rival)
        a_is_i = yp[:, :, None] > yj
        delta = _delta(objective, yp=yp, vp=vp, order=order, L=L, gv=gv,
                       dv=dv, inv_idcg=inv_idcg, gj=_gather(gv, rival),
                       dj=_gather(dv, rival),
                       rank_i=rank_of[:, :, None].expand(C, L, k),
                       rank_j=_gather(rank_of, rival), a_is_i=a_is_i)
        lam, hes, p = _ranknet(sp[:, :, None], _gather(sp, rival), a_is_i,
                               delta, pair_ok)
        if kpos > 0:        # the anchor's slot against its rival's
            i_pos = torch.where(a_is_i, pos[None, :, None], rival)
            j_pos = torch.where(a_is_i, rival, pos[None, :, None])
            lam, hes, ci, cj = _debias(lam, hes, p, delta, pair_ok, i_pos,
                                       j_pos, ti, tj, kpos)
        # what each pair adds to its rival, summed in a fixed order
        back = [torch.where(a_is_i, -lam, lam), hes]
        if kpos > 0:
            back += [torch.where(~a_is_i, ci, 0.0),
                     torch.where(a_is_i, cj, 0.0)]
            li_c = torch.where(a_is_i, ci, 0.0).sum(dim=2).sum(dim=0)
            lj_c = torch.where(~a_is_i, cj, 0.0).sum(dim=2).sum(dim=0)
        target = (rival + torch.arange(C, device=dev)[:, None, None] * L
                  ).reshape(-1)
        sums = ordered_scatter_sum(
            target, torch.stack([b.reshape(-1) for b in back], dim=1),
            C * L).reshape(C, L, -1)
        g_out.append(torch.where(a_is_i, lam, -lam).sum(dim=2)
                     + sums[..., 0])
        h_out.append(hes.sum(dim=2) + sums[..., 1])
        if kpos > 0:
            li_s.append(li_c + sums[..., 2].sum(dim=0))
            lj_s.append(lj_c + sums[..., 3].sum(dim=0))
    return _finish(torch.cat(g_out), torch.cat(h_out), li_s, lj_s, lay, kpos)


class _LambdaRankBase(Objective):
    default_metric = "ndcg"
    takes = ("group_ptr",)

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self._layout_cache = None
        self._ti = self._tj = None
        self._pending_bias = None
        super().__init__(params)

    # ------------------------------------------------------------- layout
    def _layout(self, labels: torch.Tensor, weights: Optional[torch.Tensor],
                group_ptr: np.ndarray) -> Dict[str, Any]:
        """The padded-query indexing of ``labels`` (cached while the same
        label and weight tensors and query offsets come back)."""
        ptr = np.asarray(group_ptr, dtype=np.int64)
        c = self._layout_cache
        if c is not None and c[0] is labels and c[1] is weights \
                and np.array_equal(c[2], ptr):
            return c[3]
        dev = labels.device
        sizes = np.diff(ptr)
        G, L = len(sizes), int(sizes.max(initial=1))
        n = int(ptr[-1])
        sizes_t = torch.from_numpy(sizes).to(dev)
        qidx = torch.repeat_interleave(torch.arange(G, device=dev), sizes_t)
        slot = (torch.arange(n, device=dev)
                - torch.from_numpy(ptr[:-1]).to(dev)[qidx])
        if weights is None:
            w_row = torch.ones(n, dtype=torch.float32, device=dev)
        elif weights.shape[0] == G:         # one weight a query
            w_row = torch.repeat_interleave(weights, sizes_t)
        else:
            w_row = weights
        lay = dict(G=G, L=L, sizes=sizes_t, qidx=qidx, slot=slot,
                   w_row=w_row.to(torch.float32),
                   y=labels.reshape(-1).to(torch.float32))
        self._layout_cache = (labels, weights, ptr, lay)
        return lay

    @staticmethod
    def _mean_stats(lay: Dict[str, Any]) -> Dict[str, Any]:
        """Attach each query's label buckets to the layout (once): its
        documents by label, highest first, stable (``y_order``), and for
        each document the count of a higher label (``n_lefts``) and of at
        least its label (``n_geq``); pads count nowhere and sort last."""
        if "y_order" not in lay:
            G, L, dev = lay["G"], lay["L"], lay["y"].device
            y_pad = torch.zeros((G, L), dtype=torch.float32, device=dev)
            valid = torch.zeros((G, L), dtype=torch.bool, device=dev)
            y_pad[lay["qidx"], lay["slot"]] = lay["y"]
            valid[lay["qidx"], lay["slot"]] = True
            neg = -y_pad + 0.0
            key = torch.where(valid, neg, float("inf"))
            srt, y_order = torch.sort(key, dim=1, stable=True)
            lay["y_order"] = y_order
            lay["n_lefts"] = torch.searchsorted(srt, neg, side="left")
            lay["n_geq"] = torch.searchsorted(srt, neg, side="right")
        return lay

    # ----------------------------------------------------------- gradient
    def get_gradient(self, preds: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     iteration: int = 0,
                     group_ptr: Optional[np.ndarray] = None) -> torch.Tensor:
        """preds [n, 1] margins, labels [n], weights [n] or one a query
        [G], ``group_ptr`` [G + 1] the queries' offsets -> [n, 1, 2]."""
        if group_ptr is None:
            raise ValueError(f"{self.name} requires query group information "
                             "(set group= or qid= on the DMatrix)")
        lay = self._layout(labels, weights, group_ptr)
        if self.name == "rank:map" and "binary" not in lay:
            y = lay["y"]
            lay["binary"] = bool(((y == 0) | (y == 1)).all())
        if self.name == "rank:map" and not lay["binary"]:
            raise ValueError(
                "rank:map requires binary relevance labels (0/1); got "
                "graded labels — use rank:ndcg instead")
        method = str(self.params.get("lambdarank_pair_method", "mean"))
        if method not in ("mean", "topk"):
            raise ValueError(f"lambdarank_pair_method={method!r}: use "
                             "'mean' or 'topk'")
        exp_gain = str(self.params.get("ndcg_exp_gain", "true")).lower() \
            not in ("false", "0")
        unbiased = str(self.params.get("lambdarank_unbiased",
                                       "false")).lower() in ("1", "true")
        s = preds.reshape(-1)[:lay["y"].shape[0]].to(torch.float32)
        objective = self.name.split(":")[1]
        kpos, ti, tj = 0, None, None
        if unbiased:
            kpos = self._position_bias_state(method, lay["L"])
            bias = torch.tensor(np.stack([self._ti, self._tj]),
                                dtype=torch.float32, device=s.device)
            ti, tj = bias[0], bias[1]
        if method == "mean":
            k = int(self.params.get("lambdarank_num_pair_per_sample", 1))
            key = xrandom.fold_in(
                xrandom.key(int(self.params.get("seed", 0))), iteration)
            chunk = max(1, min(lay["G"], MEAN_DRAWS // max(lay["L"] * k, 1)))
            gpair, li, lj = lambda_grad_mean(
                s, self._mean_stats(lay), key, k=k, exp_gain=exp_gain,
                objective=objective, chunk=chunk, kpos=kpos, ti=ti, tj=tj)
        else:
            kcap = int(self.params.get("lambdarank_num_pair_per_sample", 0))
            budget = TOPK_PAIRS_CUDA if s.is_cuda else TOPK_PAIRS_CPU
            chunk = max(1, min(lay["G"], budget // max(lay["L"] ** 2, 1)))
            gpair, li, lj = lambda_grad_topk(
                s, lay, kcap=kcap, exp_gain=exp_gain, objective=objective,
                chunk=chunk, kpos=kpos, ti=ti, tj=tj)
        if unbiased:        # read back when the state is next needed
            self._pending_bias = torch.stack([li, lj])
        return guard_gradient(gpair, self.name, iteration)

    def init_estimation(self, labels, weights=None, **inputs) -> np.ndarray:
        return np.zeros(1, dtype=np.float32)

    # ---------------------------------------------- position-bias state
    @property
    def ti_plus(self) -> Optional[np.ndarray]:
        self._flush_bias_update()
        return self._ti

    @property
    def tj_minus(self) -> Optional[np.ndarray]:
        self._flush_bias_update()
        return self._tj

    def _flush_bias_update(self) -> None:
        """Apply the last round's position costs to ti+ / tj-."""
        pend, self._pending_bias = self._pending_bias, None
        if pend is not None:
            acc = pend.cpu().numpy().astype(np.float64)
            self._update_position_bias(acc[0], acc[1])

    def _position_bias_state(self, method: str, max_gs: int) -> int:
        """The positions tracked (``kpos``: the pair cap under topk, else
        min(longest query, 32)), with ti+ / tj- (re)made at that length."""
        self._flush_bias_update()
        if method == "topk":
            kpos = int(self.params.get("lambdarank_num_pair_per_sample",
                                       max_gs))
        else:
            kpos = min(max_gs, 32)
        kpos = max(kpos, 1)
        if self._ti is None or len(self._ti) != kpos:
            self._ti = np.ones(kpos, np.float64)
            self._tj = np.ones(kpos, np.float64)
        return kpos

    def _update_position_bias(self, li_acc, lj_acc) -> None:
        """Normalise the costs to position 0 and damp them by
        1 / (1 + ``lambdarank_bias_norm``) (reference
        ``LambdaRankUpdatePositionBias``)."""
        reg = 1.0 / (1.0 + float(self.params.get("lambdarank_bias_norm",
                                                 1.0)))
        if li_acc[0] >= _EPS64:
            self._ti = np.power(li_acc / max(li_acc[0], _EPS64), reg)
        if lj_acc[0] >= _EPS64:
            self._tj = np.power(lj_acc / max(lj_acc[0], _EPS64), reg)

    # ------------------------------------------------------------- JSON
    def to_json(self) -> Dict[str, Any]:
        out = super().to_json()
        if self.ti_plus is not None:
            out["ti_plus"] = [float(v) for v in self._ti]
            out["tj_minus"] = [float(v) for v in self._tj]
        return out

    def configure(self, params: Dict[str, Any]) -> None:
        params = dict(params)
        tp = params.pop("ti_plus", None)
        tm = params.pop("tj_minus", None)
        super().configure(params)

        def vec(v):
            return np.asarray(json.loads(v) if isinstance(v, str) else v,
                              np.float64)

        if tp is not None:
            self._ti = vec(tp)
        if tm is not None:
            self._tj = vec(tm)


@register("rank:ndcg")
class LambdaRankNDCG(_LambdaRankBase):
    name = "rank:ndcg"
    default_metric = "ndcg"


@register("rank:pairwise")
class LambdaRankPairwise(_LambdaRankBase):
    name = "rank:pairwise"
    default_metric = "map"


@register("rank:map")
class LambdaRankMAP(_LambdaRankBase):
    name = "rank:map"
    default_metric = "map"
