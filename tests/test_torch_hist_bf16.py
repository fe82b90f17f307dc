"""K3's bf16 and bf16x2 precisions (``hist_method="pallas:bf16"`` /
``"pallas:bf16x2"``) in the port against the JAX package, on the CPU.

The TPU kernel rounds each row's (g, h) to bfloat16 (``hi``), and under
bf16x2 also the remainder (``lo = bf16(x - hi)``), and adds them on its
matrix unit in f32. XLA:CPU emulates bf16 dots with bf16 accumulation,
so Pallas interpret mode is no tight oracle here
(``tests/test_pallas_hist.py``). The port is held to three anchors:

(a) each row's ``hi`` and ``lo`` equal JAX's ``astype(jnp.bfloat16)``
    bit for bit;
(b) the histogram equals a float64 sum of those rounded values to one f32
    rounding (plus the fixed point's quantum 2^-k a row: the sums are
    exact int64, converted once);
(c) it meets Pallas interpret mode at the JAX package's own stated
    tolerance for bf16x2, rtol = atol = 2e-2 of the histogram's scale.

Training through either precision is held to training through K3's f32
precision (the JAX package's CPU training cannot run a Pallas kernel
outside interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xt
from xgboost_tpu.ops.pallas.histogram import build_hist_pallas
from xgboost_tpu_torch.ops.histogram import (bf16_parts, build_hist,
                                             build_hist_f32_reference,
                                             fixed_point_scale)

F = 5


def _data(n, B, N, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (n, F)).astype(np.uint8 if B <= 256
                                            else np.uint16)
    g = (rng.randn(n, 2) * scale).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1])
    g[:7, 0] = (0.0, -0.0, 1.0, 1.00390625, 1.005859375, 3e-39, -65504.0)
    rel = rng.randint(0, N, n).astype(np.int32)
    rel[rng.rand(n) < 0.1] = N                     # inactive rows
    return bins, g, rel


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_rounded_rows_equal_jax_bf16(scale):
    """(a): ties to even included (1 + 2^-8 and 1 + 3 * 2^-9 are exact
    halves of a bf16 step), and a subnormal. Row 5's value is subnormal
    and so is its remainder, which XLA:CPU flushes to +0; the port (as
    the card) rounds it to -0: equal in value, and it adds nothing."""
    _, g, _ = _data(5000, 16, 4, seed=1, scale=scale)
    x = jnp.asarray(g)
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    got_hi, got_lo = bf16_parts(torch.from_numpy(g), "bf16x2")
    assert got_hi.numpy().tobytes() == \
        np.asarray(hi.astype(jnp.float32)).tobytes()
    want_lo = np.asarray(lo.astype(jnp.float32))
    normal = np.ones(g.shape, bool)
    normal[5, 0] = False
    assert got_lo.numpy()[normal].tobytes() == want_lo[normal].tobytes()
    np.testing.assert_array_equal(got_lo.numpy(), want_lo)
    (only,) = bf16_parts(torch.from_numpy(g), "bf16")
    assert only.numpy().tobytes() == got_hi.numpy().tobytes()


def _exact(bins, parts, rel, N, B):
    """float64 sums of the rounded values by (node, feature, bin)."""
    out = np.zeros((N, F, B, 2), np.float64)
    act = rel < N
    v = sum(p.numpy().astype(np.float64) for p in parts)[act]
    for f in range(F):
        np.add.at(out, (rel[act], f, bins[act, f].astype(np.int64)), v)
    return out


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
@pytest.mark.parametrize("n,B,N", [(1000, 16, 1), (3000, 256, 4),
                                   (2000, 257, 16), (40_000, 64, 8)])
def test_histogram_is_one_rounding_of_the_exact_sum(precision, n, B, N):
    """(b), through ``build_hist`` and the plain version."""
    bins, g, rel = _data(n, B, N, seed=n + B)
    method = f"pallas:{precision}"
    got = build_hist(torch.from_numpy(bins), torch.from_numpy(g),
                     torch.from_numpy(rel), N, B, method=method).numpy()
    gt = torch.from_numpy(g)
    qs, inv = fixed_point_scale(gt)
    plain = build_hist_f32_reference(
        torch.from_numpy(bins), gt, torch.from_numpy(rel), qs, inv, N, B,
        precision=precision).numpy()
    assert got.tobytes() == plain.tobytes()
    parts = bf16_parts(gt, precision)
    exact = _exact(bins, parts, rel, N, B)
    count = np.zeros((N, F, B), np.float64)
    act = rel < N
    for f in range(F):
        np.add.at(count, (rel[act], f, bins[act, f].astype(np.int64)), 1)
    quantum = inv.numpy().astype(np.float64)[None, None, None, :]
    bound = (np.abs(exact) * 2.0 ** -24
             + count[..., None] * 0.5 * quantum * len(parts))
    err = np.abs(got.astype(np.float64) - exact)
    assert (err <= bound).all(), float((err - bound).max())
    # and bf16x2 carries ~16 bits of each value: close to the f32 sums
    if precision == "bf16x2":
        f32 = _exact(bins, [gt], rel, N, B)
        scale = np.abs(f32).max()
        np.testing.assert_allclose(got / scale, f32 / scale, atol=2e-5)


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
@pytest.mark.parametrize("B,N", [(16, 1), (16, 64), (256, 4), (17, 4)])
def test_meets_pallas_interpret_at_its_tolerance(precision, B, N):
    """(c): the JAX package's bf16x2 tolerance, rtol = atol = 2e-2 of the
    histogram's scale (``tests/test_pallas_hist.py TOL``), for both
    rounded precisions."""
    bins, g, rel = _data(1000, B, N, seed=B * N)
    want = np.asarray(build_hist_pallas(
        jnp.asarray(bins).T, jnp.asarray(g), jnp.asarray(rel), N, B,
        precision=precision, block_rows=256, interpret=True))
    got = build_hist(torch.from_numpy(bins), torch.from_numpy(g),
                     torch.from_numpy(rel), N, B,
                     method=f"pallas:{precision}").numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
def test_training_through_the_rounded_precisions(precision, monkeypatch):
    """``hist_method="pallas:bf16x2"`` / ``"pallas:bf16"`` train at every
    level (they raised before this slice), near the model of K3's f32
    precision: bf16x2 within 1e-3 of its probabilities, bf16 within
    2e-2."""
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    rng = np.random.RandomState(2)
    X = rng.randn(2000, 6).astype(np.float32)
    y = (X @ rng.randn(6) + 0.3 * rng.randn(2000) > 0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 4, "base_score": 0.5}
    got = xt.train(dict(p, hist_method=f"pallas:{precision}", device="cpu"),
                   xt.DMatrix(X, label=y), 4, verbose_eval=False)
    assert got.num_boosted_rounds() == 4
    ref = xt.train(dict(p, hist_method="pallas:f32", device="cpu"),
                   xt.DMatrix(X, label=y), 4, verbose_eval=False)
    pg, pr = got.predict(xt.DMatrix(X)), ref.predict(xt.DMatrix(X))
    tol = 1e-3 if precision == "bf16x2" else 2e-2
    assert np.abs(pg - pr).max() < tol
