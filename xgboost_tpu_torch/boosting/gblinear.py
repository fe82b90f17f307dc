"""The linear booster: boosted elastic-net regression (``booster="gblinear"``).

The port of the JAX package's ``boosting/gblinear.py`` (reference
``src/gbm/gblinear.cc`` and ``src/linear/``). Each round takes a Newton
step on the bias, refreshes the gradient by it, then moves the weights
W [F, K] with the elastic-net coordinate rule (reference
``CoordinateDelta``, ``src/linear/coordinate_common.h:45``):

- ``shotgun`` (:func:`shotgun`): every coordinate at once from two
  products, G = Xᵀg and H = (X²)ᵀh, and one soft-threshold move;
- ``coord_descent`` (:func:`coord_descent`): one feature after another,
  the gradient refreshed after each, in a loop whose every step stays on
  the matrix's device (no value comes to the host inside it).

The products are ``torch.matmul`` in full f32 (no TF32 on the card), as
the JAX package runs them at ``Precision.HIGHEST``; torch sums in
another order than XLA's einsum, so the weights agree to a rounding
gap, not bit for bit. Missing values count as 0. An iterator-built
resident matrix trains on its bins' representative values (missing ->
0), the JAX package's rule. A paged (external-memory) matrix streams
``shotgun`` over its pages (the JAX package's ``_do_boost_paged``): the
bias step from the gradient's sums, one pass adding each page's G and H
(its bins decoded to those values on the device,
:func:`page_features`), the weight move, and the margin recomputed in a
second pass; ``coord_descent`` there raises, as in the JAX package.
``feature_selector`` and ``top_k`` are accepted and not used, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..registry import BOOSTERS, LINEAR_UPDATERS


def _soft_threshold(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - alpha, min=0.0)


def _bias_step(gpair: torch.Tensor, eta: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bias's Newton step dbias [K] and the gradient g [n, K]
    refreshed by it; h [n, K]."""
    g, h = gpair[..., 0], gpair[..., 1]
    dbias = -g.sum(dim=0) / torch.clamp(h.sum(dim=0), min=1e-10) * eta
    return dbias, g + h * dbias[None, :], h


@LINEAR_UPDATERS.register("shotgun")
def shotgun(X: torch.Tensor, gpair: torch.Tensor, W: torch.Tensor,
            bias: torch.Tensor, *, eta: float, lam: float, alpha: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One parallel coordinate round (the JAX package's
    ``_shotgun_round``). X [n, F] f32 (0 = missing), gpair [n, K, 2],
    W [F, K], bias [K] -> (new W, new bias, margin delta [n, K])."""
    dbias, g, h = _bias_step(gpair, eta)
    G = X.T @ g
    H = torch.square(X).T @ h
    W_star = _soft_threshold(H * W - G, alpha) \
        / torch.clamp(H + lam, min=1e-10)
    dW = (W_star - W) * eta
    delta = X @ dW + dbias[None, :]
    return W + dW, bias + dbias, delta


@LINEAR_UPDATERS.register("coord_descent")
def coord_descent(X: torch.Tensor, gpair: torch.Tensor, W: torch.Tensor,
                  bias: torch.Tensor, *, eta: float, lam: float,
                  alpha: float, XT: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential coordinate descent over the features (the JAX
    package's ``_coord_round``, its ``lax.scan`` a loop here): each
    feature's move from the gradient the previous moves left. ``XT``:
    X transposed and contiguous, so that a feature's column is one row
    (made here when not given)."""
    dbias, g, h = _bias_step(gpair, eta)
    XT = X.T.contiguous() if XT is None else XT
    Wc = W.clone()
    for f in range(XT.shape[0]):
        x = XT[f]
        G = x @ g
        H = torch.square(x) @ h
        w_old = Wc[f]
        w_new = _soft_threshold(H * w_old - G, alpha) \
            / torch.clamp(H + lam, min=1e-10)
        dw = (w_new - w_old) * eta
        g = g + h * (x[:, None] * dw[None, :])
        Wc[f] = w_old + dw
    delta = X @ (Wc - W) + dbias[None, :]
    return Wc, bias + dbias, delta


def linear_features(dm, device: torch.device) -> torch.Tensor:
    """The [n, F] f32 operand of a resident matrix on ``device``: its raw
    values, or an iterator-built matrix's representative bin values, with
    missing as 0 (the JAX package's ``np.nan_to_num`` and
    ``_page_features``)."""
    X = torch.from_numpy(np.ascontiguousarray(dm.values(), np.float32))
    return torch.nan_to_num(X.to(device), nan=0.0)


def cut_arrays(paged, device: torch.device):
    """(first cut of each feature [F], cut values, real bins [F]) on
    ``device``: the operands of :func:`page_features`."""
    cuts = paged.cuts
    return tuple(torch.from_numpy(a).to(device) for a in (
        np.asarray(cuts.ptrs[:-1], np.int64),
        np.asarray(cuts.values, np.float32),
        np.asarray(paged.n_real_bins(), np.int64)))


def page_features(page: torch.Tensor, ptrs: torch.Tensor, vals: torch.Tensor,
                  n_real: torch.Tensor) -> torch.Tensor:
    """[p, F] bin ids -> each bin's representative value (its upper cut),
    missing -> 0 (the JAX package's ``_page_features``; equal to
    ``data/binned.py values_of_bins`` with NaN as 0)."""
    local = page.long()
    gb = torch.clamp(ptrs[None, :] + torch.minimum(local, n_real[None, :] - 1),
                     0, vals.shape[0] - 1)
    return torch.where(local >= n_real[None, :], torch.zeros_like(vals[:1]),
                       vals[gb])


@BOOSTERS.register("gblinear")
class GBLinear:
    """Linear model W [F, K], bias [K] (None before the first round)."""

    name = "gblinear"
    supports_margin_cache = False

    def __init__(self, n_groups: int, updater: str = "shotgun",
                 reg_lambda: float = 0.0, reg_alpha: float = 0.0,
                 eta: float = 0.5, feature_selector: str = "cyclic") -> None:
        self.n_groups = n_groups
        self.updater = updater
        self.reg_lambda = reg_lambda
        self.reg_alpha = reg_alpha
        self.eta = eta
        self.feature_selector = feature_selector
        self.W: Optional[torch.Tensor] = None
        self.bias: Optional[torch.Tensor] = None
        self.rounds = 0
        self.trees: list = []     # none: the Booster's tree checks see it

    # -- booster interface ----------------------------------------------------
    def version(self) -> int:
        return self.rounds

    def num_boosted_rounds(self) -> int:
        return self.rounds

    def _X_of(self, state: dict) -> torch.Tensor:
        if "linear_X" not in state:
            dev = state["base"].device
            state["linear_X"] = linear_features(state["dm"], dev)
        return state["linear_X"]

    def _to(self, device: torch.device) -> None:
        """Keep the weights on the device of the matrix at hand (a loaded
        model's are made on the host)."""
        if self.W is not None and self.W.device != device:
            self.W, self.bias = self.W.to(device), self.bias.to(device)

    def _paged(self, state: dict):
        """The state's paged matrix to stream, or None; ``coord_descent``
        on pages raises, as in the JAX package."""
        paged = state["dm"].paged
        if paged is not None and self.updater == "coord_descent":
            raise NotImplementedError(
                "external-memory gblinear streams updater=shotgun only "
                "(the reference shotgun iterates GetBatches the same "
                "way); coord_descent's in-scan gradient refresh needs "
                "the resident matrix")
        if paged is not None and "linear_cuts" not in state:
            state["linear_cuts"] = cut_arrays(paged, state["base"].device)
        return paged

    def _page_X(self, paged, page, state: dict) -> torch.Tensor:
        return page_features(paged.decode_page(page), *state["linear_cuts"])

    def _do_boost_paged(self, paged, gpair: torch.Tensor,
                        state: dict) -> None:
        """One ``shotgun`` round streamed over the pages (module
        docstring)."""
        dev = gpair.device
        F, K = paged.n_features, gpair.shape[1]
        self._to(dev)
        if self.W is None:
            self.W = torch.zeros((F, K), dtype=torch.float32, device=dev)
            self.bias = torch.zeros(K, dtype=torch.float32, device=dev)
        dbias, _, _ = _bias_step(gpair, self.eta)
        G = torch.zeros((F, K), dtype=torch.float32, device=dev)
        H = torch.zeros_like(G)
        for s, e, page in paged.pages(dev):
            X = self._page_X(paged, page, state)
            gp = gpair[s:e]
            G += X.T @ (gp[..., 0] + gp[..., 1] * dbias[None, :])
            H += torch.square(X).T @ gp[..., 1]
        W_star = (_soft_threshold(H * self.W - G, self.reg_alpha)
                  / torch.clamp(H + self.reg_lambda, min=1e-10))
        self.W = self.W + (W_star - self.W) * self.eta
        self.bias = self.bias + dbias
        self.rounds += 1

    def do_boost(self, src, gpair: torch.Tensor, key=None, *, state: dict,
                 **_) -> None:
        """One round on the state's matrix; the caller recomputes the
        margin with :meth:`compute_margin`, as the JAX package does."""
        paged = self._paged(state)
        if paged is not None:
            return self._do_boost_paged(paged, gpair, state)
        X = self._X_of(state)
        self._to(X.device)
        if self.W is None:
            self.W = torch.zeros((X.shape[1], self.n_groups),
                                 dtype=torch.float32, device=X.device)
            self.bias = torch.zeros(self.n_groups, dtype=torch.float32,
                                    device=X.device)
        # unknown names keep shotgun, as the JAX package's registry does
        fn = LINEAR_UPDATERS.get(self.updater) or shotgun
        kw = dict(eta=self.eta, lam=self.reg_lambda, alpha=self.reg_alpha)
        if fn is coord_descent:
            if "linear_XT" not in state:
                state["linear_XT"] = X.T.contiguous()
            kw["XT"] = state["linear_XT"]
        self.W, self.bias, _ = fn(X, gpair, self.W, self.bias, **kw)
        self.rounds += 1

    def compute_margin(self, state: dict, walk=None) -> torch.Tensor:
        """base + X W + bias on the state's matrix (its margin after
        every round, recomputed, not moved by a delta); over a paged
        matrix page by page."""
        if self.W is None:
            return state["base"]
        paged = self._paged(state)
        if paged is not None:
            dev = state["base"].device
            self._to(dev)
            return state["base"] + torch.cat([
                self._page_X(paged, page, state) @ self.W
                + self.bias[None, :] for _, _, page in paged.pages(dev)])
        X = self._X_of(state)
        self._to(X.device)
        return state["base"] + X @ self.W + self.bias[None, :]

    def training_margin(self, state: dict, walk=None) -> torch.Tensor:
        """The training matrix's margin, recomputed when the model has
        rounds the cache has not seen (a continued model)."""
        if state["n_trees"] < self.version():
            state["margin"] = self.compute_margin(state)
            state["n_trees"] = self.version()
        return state["margin"]

    def predict_margin(self, X: torch.Tensor, base: torch.Tensor
                       ) -> torch.Tensor:
        """Margins [n, K] of raw values X (NaN missing) plus ``base``
        [K]."""
        Xc = torch.nan_to_num(X, nan=0.0)
        if self.W is None:
            return base[None, :].expand(X.shape[0], -1).clone()
        self._to(X.device)
        return Xc @ self.W + self.bias[None, :] + base[None, :]

    def slice_rounds(self, rounds) -> "GBLinear":
        raise NotImplementedError("gblinear models cannot be sliced")

    def feature_scores(self) -> np.ndarray:
        """|coefficients| summed over groups (the reference's weight
        importance)."""
        if self.W is None:
            return np.zeros(0)
        return np.abs(self.W.cpu().numpy()).sum(axis=1)

    # -- serialization --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "name": "gblinear",
            "updater": self.updater,
            "weights": (self.W.cpu().numpy().tolist()
                        if self.W is not None else []),
            "bias": (self.bias.cpu().numpy().tolist()
                     if self.bias is not None else []),
            "rounds": self.rounds,
        }

    def from_json(self, obj: dict) -> None:
        self.updater = obj.get("updater", "shotgun")
        if obj.get("weights"):
            self.W = torch.from_numpy(np.asarray(obj["weights"], np.float32))
            self.bias = torch.from_numpy(np.asarray(obj["bias"], np.float32))
        self.rounds = int(obj.get("rounds", 0))
