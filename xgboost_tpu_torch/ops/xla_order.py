"""Sums in the order the JAX package's compiled CPU programs add them.

XLA rewrites a long reduction on the CPU into a tree of windows and a
long cumulative sum into blocks; torch fixes no order for either.
:func:`sum_in_xla_order` and :func:`cumsum_in_xla_order` replay XLA's
order with f32 adds one step at a time, so that a vector-leaf tree's
root sums, prefix sums over the bins and gains summed over the targets
(``ops/split.py evaluate_splits_multi``, ``tree/multi.py``), and a
label matrix's intercepts (:func:`stump_sums`), are the JAX package's
bits on the same inputs, on either device.
``tests/test_torch_multi_target.py`` holds both against ``jnp.sum`` /
``jnp.cumsum`` at the lengths that take each branch.
"""

from __future__ import annotations

import torch


# XLA's CPU tree-reduction rewrite: a sum over more terms than this is
# split into windows of this many (a reduce-window), whose sums are added
# again the same way
XLA_REDUCE_WINDOW = 32


def sum_in_xla_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` in the order the JAX package's
    compiled ``jnp.sum`` adds on the CPU, f32 at every step: up to 32
    terms a left fold in index order; more are padded with zeros to a
    multiple of 32 (half the padding before the first term, the rest
    after the last), each window of 32 folded, and the windows' sums
    summed the same way. (No torch reduction fixes an order.)"""
    x = x.movedim(dim, 0)
    while x.shape[0] > XLA_REDUCE_WINDOW:
        x = _window_sums(x)
    return _fold(x, 0)


def _window_sums(x: torch.Tensor) -> torch.Tensor:
    """One level of the windowed sum over axis 0, without a padded copy:
    step t adds term ``32 j + t - lead`` to window j's sum, for every
    window whose step t is not padding, as strided views of ``x``. A
    padding zero added to an f32 sum changes nothing but the sign of a
    zero, so the first window starts from +0 when it is padded in front
    and the last adds one +0 when it is padded at the back."""
    w = XLA_REDUCE_WINDOW
    n = x.shape[0]
    pad = -n % w
    lead = pad // 2
    n_win = (n + pad) // w
    acc = torch.empty((n_win,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for t in range(w):
        j0 = 1 if t < lead else 0                 # first window padded
        j1 = n_win - 1 if (n_win - 1) * w + t - lead >= n else n_win
        terms = x[(j0 * w + t - lead)::w][:j1 - j0]
        if t == 0:
            acc[j0:j1] = terms
            if j0:
                acc[0] = 0.0
        else:
            acc[j0:j1] += terms
    if (n_win - 1) * w + w - 1 - lead >= n:       # last window padded
        acc[-1] += 0.0
    return acc


# XLA's CPU rewrite of a long cumulative sum: blocks of this many
XLA_SCAN_BLOCK = 16


def cumsum_in_xla_order(x: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sums of ``x`` over its last axis in the order
    the JAX package's compiled ``jnp.cumsum`` adds on the CPU, f32 at
    every step: up to 16 terms a left fold; more are padded at the end to
    blocks of 16, each block's prefix folded, the block totals' exclusive
    prefix taken the same way (recursively above 16 blocks), and each
    block's prefix added to its block's offset."""
    L = x.shape[-1]
    w = XLA_SCAN_BLOCK
    if L <= w:
        return _prefix(x)
    nb = -(-L // w)
    xp = torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (nb * w - L,))],
                   dim=-1)
    within = _prefix(xp.reshape(tuple(x.shape[:-1]) + (nb, w)))
    totals = within[..., -1]
    if nb <= w:
        incl = _prefix(totals)
    else:
        incl = cumsum_in_xla_order(totals)
    offset = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                       dim=-1)
    out = within + offset[..., None]
    return out.reshape(tuple(x.shape[:-1]) + (nb * w,))[..., :L]


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, left to right."""
    out = torch.empty_like(x)
    out[..., 0] = x[..., 0]
    for t in range(1, x.shape[-1]):
        out[..., t] = out[..., t - 1] + x[..., t]
    return out


def _fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x_0 + x_1 + ...`` over ``dim``, left to right."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def stump_sums(gpair: torch.Tensor) -> torch.Tensor:
    """A zero-margin gradient [n, k, 2] summed over its rows -> [k, 2],
    the sums an intercept is fitted from: a label matrix's (k > 1) in the
    JAX package's order (:func:`sum_in_xla_order`), one column in
    torch's own order, which every scalar model of the port was fitted
    with. This is the one place the port picks between the two orders
    for an intercept (ROADMAP C names the one convention that is to
    replace both)."""
    if gpair.shape[1] > 1:
        return sum_in_xla_order(gpair, 0)
    return torch.stack([gpair[..., 0].sum(dim=0), gpair[..., 1].sum(dim=0)],
                       dim=-1)
