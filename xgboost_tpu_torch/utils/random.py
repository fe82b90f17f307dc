"""Threefry-2x32 random numbers, bit for bit those of ``jax.random``.

The JAX package draws its row and column samples from ``jax.random``
with the ``threefry2x32`` key type, ``jax_threefry_partitionable`` on
and 64-bit types off. This module reproduces the functions it calls:

- ``key(seed)``: a key is the pair of 32-bit words ``(seed >> 32,
  seed & 0xFFFFFFFF)``, so ``(0, seed)`` for a 32-bit seed;
- ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``
  under ``key``; its two output words are the new key;
- ``split(key, n)``: key i is the hash of the counter pair ``(0, i)``
  (the partitionable scheme: each element's counter is its flat index,
  high and low word);
- ``random_bits(key, shape)``: the hash of each element's flat index
  ``(i >> 32, i & 0xFFFFFFFF)``, its two words xor-ed;
- ``uniform(key, shape)``: f32 in [0, 1) from the top 23 bits,
  ``bits >> 9 | 0x3F800000`` read as a float, minus 1;
- ``bernoulli(key, p, shape)``: ``uniform < p`` in f32.

PyTorch has no full unsigned 32-bit arithmetic, so the words live in
int64 tensors and every add and shift is masked back to 32 bits; the
rotation is written out. Integer ops are exact, so a draw gives the same
bits on the CPU and on the card. :func:`threefry2x32` also takes Python
ints (what the scalar key derivations use, on the host) and broadcasts
int64 tensors of any shape against them.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Word = Union[int, torch.Tensor]
Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word
                 ) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x0, x1)`` under the key ``(k0, k1)``: 32-bit words held in Python
    ints or int64 tensors (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2^32) (the JAX package
    passes a uint32)."""
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``; ``data`` is taken as a uint32."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Each element's flat index as (high word, low word), int64."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(k: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.split(k, n)`` -> [n, 2] int64 words."""
    hi, lo = _counters((n,), device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def _key_words(keys) -> Tuple[Word, Word]:
    """A key pair, or [..., 2] int64 key words (one key per leading
    index), as two broadcastable words."""
    if isinstance(keys, torch.Tensor):
        return keys[..., 0], keys[..., 1]
    return keys[0], keys[1]


def random_bits(keys, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)) of ``shape`` under
    each key: ``keys`` a key pair, or [..., 2] words whose leading
    dimensions come first in the result (one draw of ``shape`` a key, as
    ``jax.vmap`` over the keys would give)."""
    k0, k1 = _key_words(keys)
    if isinstance(keys, torch.Tensor):
        device = keys.device
        lead = keys.shape[:-1]
        k0 = k0.reshape(*lead, *([1] * len(shape)))
        k1 = k1.reshape(*lead, *([1] * len(shape)))
    hi, lo = _counters(tuple(shape), device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return b0 ^ b1


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def uniform(keys, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` (f32 in [0, 1)); for [..., 2]
    key words, one draw of ``shape`` per key."""
    return bits_to_unit_float(random_bits(keys, shape, device))


def bernoulli(k: Key, p, shape: Sequence[int] = None,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p`` in f32, for
    a scalar ``p`` (a Python float rounds to f32, as JAX's weak type does)
    or an f32 tensor ``p`` of the draw's shape."""
    if isinstance(p, torch.Tensor):
        if shape is None:
            shape = tuple(p.shape)
        return uniform(k, shape, p.device) < p
    return uniform(k, shape, device) < float(np.float32(p))
