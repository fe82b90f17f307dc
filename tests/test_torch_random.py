"""The port's threefry (``xgboost_tpu_torch/utils/random.py``) against
``jax.random``, bit for bit, on the CPU: keys, ``fold_in``, ``split``,
``uniform`` and ``bernoulli`` (scalar and array ``p``), under this
package's JAX settings (``jax_threefry_partitionable`` on, 64-bit types
off), for seeds 0 and 2^32 - 1 among others, the fold-in data the
training stream uses (class x tree indices, 0xC0, 0x5AB, 0x5EED, level
depths) and draws of 1, odd, 54 and 2^17 + 3 elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu_torch.utils import random as xrandom

SEEDS = (0, 1, 12345, 2 ** 31, 2 ** 32 - 1)
FOLDS = (0, 1, 2, 6, 7 * 4 + 3, 0xC0, 0x5AB, 0x5EED, 2 ** 32 - 1)
SHAPES = ((1,), (7,), (54,), (2 ** 17 + 3,), (3, 5))


def _words(k) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_partitionable_threefry_is_the_configuration():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


def _case_key(seed):
    return jax.random.key(np.uint32(seed)), xrandom.key(seed)


def _check_key(seed):
    jk, tk = _case_key(seed)
    assert _words(jk) == tk


def _check_fold_in(seed):
    jk, tk = _case_key(seed)
    for d in FOLDS:
        assert _words(jax.random.fold_in(jk, np.uint32(d))) == \
            xrandom.fold_in(tk, d)
    # the chains the grower walks: tree key -> 0x5EED -> depth -> 1
    j = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jk, 5), 0x5EED), 3)
    t = xrandom.fold_in(xrandom.fold_in(xrandom.fold_in(tk, 5), 0x5EED), 3)
    assert _words(j) == t


def _check_split(seed):
    jk, tk = _case_key(seed)
    for n in (1, 2, 3, 64, 128):
        want = np.asarray(jax.random.key_data(jax.random.split(jk, n)))
        np.testing.assert_array_equal(xrandom.split(tk, n).numpy(),
                                      want.astype(np.int64))


def _check_uniform(seed):
    jk, tk = _case_key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(jk, shape))
        got = xrandom.uniform(tk, shape).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), shape
    # one draw per key, as jax.vmap over split keys gives
    keys = jax.random.split(jk, 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (54,)))(keys))
    got = xrandom.uniform(xrandom.split(tk, 6), (54,)).numpy()
    assert got.tobytes() == want.tobytes()


def _check_bernoulli(seed):
    jk, tk = _case_key(seed)
    for shape in SHAPES:
        for p in (0.5, 0.8, 0.3):
            want = np.asarray(jax.random.bernoulli(jk, p, shape))
            np.testing.assert_array_equal(
                xrandom.bernoulli(tk, p, shape).numpy(), want)
    p = np.random.RandomState(seed % 997).rand(1001).astype(np.float32)
    p[:5] = (0.0, 1.0, 0.5, 1e-7, 0.99999994)
    want = np.asarray(jax.random.bernoulli(jk, jnp.asarray(p)))
    np.testing.assert_array_equal(
        xrandom.bernoulli(tk, torch.from_numpy(p)).numpy(), want)


CHECKS = {"key": _check_key, "fold_in": _check_fold_in, "split": _check_split,
          "uniform": _check_uniform, "bernoulli": _check_bernoulli}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fn", sorted(CHECKS))
def test_threefry_equals_jax_random(fn, seed):
    CHECKS[fn](seed)


def test_hash_takes_python_ints_and_tensors_alike():
    """The scalar key path (Python ints, on the host) and the tensor path
    (int64, any device) are one function and give the same words."""
    k = xrandom.key(99)
    x1 = torch.arange(10, dtype=torch.int64)
    b0, b1 = xrandom.threefry2x32(k[0], k[1], 0, x1)
    for i in range(10):
        assert xrandom.threefry2x32(k[0], k[1], 0, i) == \
            (int(b0[i]), int(b1[i]))
