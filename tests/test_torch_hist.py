"""The port's histogram builds (the plain versions of kernels K2, K3 and
K4) against the JAX package, on the CPU, on inputs made from a seed with
numpy.

K2 (int8x2) is an exact-integer histogram: it must equal the JAX
package's ``prehot`` build bit for bit at every size, and the Pallas
int8x2 kernel (interpret mode) bit for bit while the rows fit one
2048-row block. Above that the Pallas kernel adds its blocks in f32, so
it is held to rtol (number of blocks) * 2^-24 there. K4 (int8x2 over rows
sorted by node) sums in int32 throughout, as the TPU's sorted kernel
does: it must equal that kernel (interpret mode) and ``prehot`` bit for
bit at any number of blocks. K3 (f32) sums exactly in int64 fixed point;
the JAX f32 builds sum in f32, so both are held at rtol/atol 1e-5 of the
histogram's scale (``tests/test_pallas_hist.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.ops.histogram import build_hist as jax_build_hist
from xgboost_tpu.ops.histogram import build_hist_segment
from xgboost_tpu.ops.pallas.histogram import (build_hist_pallas,
                                              scan_hist_pallas)
from xgboost_tpu.ops.partition import (
    counting_sort_by_node as jax_counting_sort)
from xgboost_tpu.tree.grow import auto_selects_coarse
from xgboost_tpu_torch.ops.histogram import (INT8X2_MAX_ROWS, build_hist,
                                             build_hist_f32_reference,
                                             build_hist_int8x2_reference,
                                             build_hist_scan_reference,
                                             counting_sort_by_node,
                                             fixed_point_scale,
                                             int8x2_fits,
                                             quantise_int8x2,
                                             resolve_hist_kernel)

F = 5


def _data(n, B, N, seed, inactive=0.1):
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if B <= 256 else np.uint16
    bins = rng.randint(0, B, (n, F)).astype(dtype)
    gpair = rng.randn(n, 2).astype(np.float32)
    gpair[:, 1] = np.abs(gpair[:, 1])           # hessians are positive
    rel = rng.randint(0, N, n).astype(np.int32)
    rel[rng.rand(n) < inactive] = N             # inactive rows
    return bins, gpair, rel


def _port(bins, gpair, rel, N, B, method):
    return build_hist(torch.from_numpy(bins), torch.from_numpy(gpair),
                      torch.from_numpy(rel), N, B, method=method).numpy()


CASES = [(1, 16), (4, 17), (64, 256), (128, 257), (1, 257), (128, 16)]


@pytest.mark.parametrize("N,B", CASES)
def test_k2_equals_prehot_bit_for_bit(N, B):
    n = 3001                                    # ragged, 2 Pallas blocks
    bins, gpair, rel = _data(n, B, N, seed=N * 1000 + B)
    want = np.asarray(jax_build_hist(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(rel), N, B,
        method="prehot"))
    for method in ("auto", "prehot", "pallas", "pallas:int8x2"):
        got = _port(bins, gpair, rel, N, B, method)
        assert got.shape == (N, F, B, 2)
        np.testing.assert_array_equal(got, want, err_msg=method)


@pytest.mark.parametrize("N,B", [(1, 256), (4, 17), (64, 16), (128, 257)])
def test_k2_equals_pallas_interpret_within_one_block(N, B):
    n = 2000                                    # one 2048-row block
    bins, gpair, rel = _data(n, B, N, seed=7 + N + B)
    want = np.asarray(build_hist_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        precision="int8x2", interpret=True))
    np.testing.assert_array_equal(_port(bins, gpair, rel, N, B, "pallas"),
                                  want)


def test_k2_against_pallas_interpret_across_blocks():
    """Pallas adds each 2048-row block's int32 sums to the output in f32,
    so above one block it may round once per block: held to rtol
    (number of blocks) * 2^-24. With 20,000 non-negative gradients in 4
    bins the per-bin sums pass 2^24 quanta and the block adds round."""
    n, N, B = 20000, 1, 4
    blocks = -(-n // 2048)
    bins, gpair, rel = _data(n, B, N, seed=3, inactive=0.0)
    gpair = np.abs(gpair)
    want = np.asarray(build_hist_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        precision="int8x2", interpret=True))
    got = _port(bins, gpair, rel, N, B, "pallas")
    assert (got != want).any()          # the block adds did round
    np.testing.assert_allclose(got, want, rtol=blocks * 2.0 ** -24, atol=0)
    prehot = np.asarray(jax_build_hist(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(rel), N, B,
        method="prehot"))
    np.testing.assert_array_equal(got, prehot)


def test_k2_is_order_independent():
    """Integer sums: any row order gives the same bits."""
    n, N, B = 5000, 4, 257
    bins, gpair, rel = _data(n, B, N, seed=11)
    perm = np.random.RandomState(12).permutation(n)
    a = _port(bins, gpair, rel, N, B, "auto")
    b = _port(bins[perm], gpair[perm], rel[perm], N, B, "auto")
    np.testing.assert_array_equal(a, b)


def test_k2_quantisation_matches_jax():
    """q = round(g * 32512 / max|g|) half to even, and the dequant factor
    as the JAX package's compiled program rounds it."""
    g = np.asarray([[0.5, 0.25], [-1.0, 0.125], [1.5e-5, 1e-30],
                    [0.3, 0.7]], np.float32)
    q, inv = quantise_int8x2(torch.from_numpy(g))
    scale = np.float32(32512.0) / np.abs(g).max(axis=0)
    np.testing.assert_array_equal(q.numpy(),
                                  np.round(g * scale).astype(np.int32))
    assert np.abs(q.numpy()).max() <= 32512
    assert inv.dtype == torch.float32 and inv.shape == (2,)


@pytest.mark.parametrize("N,B", CASES)
def test_k4_equals_sorted_pallas_and_prehot_bit_for_bit(N, B):
    """Across many 256-row blocks of the TPU's sorted kernel, whose int32
    accumulators never round: equal bits everywhere."""
    n = 3001
    bins, gpair, rel = _data(n, B, N, seed=N * 31 + B)
    fine, _ = scan_hist_pallas(jnp.asarray(bins).T, jnp.asarray(gpair),
                               jnp.asarray(rel), N, B, block_rows=256,
                               interpret=True)
    prehot = np.asarray(jax_build_hist(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(rel), N, B,
        method="prehot"))
    q, inv = quantise_int8x2(torch.from_numpy(gpair))
    args = (torch.from_numpy(bins), q, torch.from_numpy(rel), inv, N, B)
    got = build_hist_scan_reference(*args).numpy()
    assert got.shape == (N, F, B, 2)
    np.testing.assert_array_equal(got, np.asarray(fine))
    np.testing.assert_array_equal(got, prehot)
    np.testing.assert_array_equal(got, build_hist_int8x2_reference(
        *args).numpy())


@pytest.mark.parametrize("N", [1, 5, 128])
def test_counting_sort_matches_jax(N):
    """The port's sort is the JAX package's, inactive rows left out; an
    empty node gets an empty run."""
    rng = np.random.RandomState(N)
    rel = rng.randint(0, N, 4000).astype(np.int32)
    rel[rng.rand(4000) < 0.2] = N
    if N > 1:
        rel[rel == 1] = 0                        # node 1 is empty
    perm, offsets = counting_sort_by_node(torch.from_numpy(rel), N)
    want = np.asarray(jax_counting_sort(jnp.asarray(rel), N))
    m = int((rel < N).sum())
    assert int(offsets[-1]) == m
    np.testing.assert_array_equal(perm.numpy(), want[:m])
    np.testing.assert_array_equal(
        offsets.diff().numpy(), np.bincount(rel, minlength=N + 1)[:N])


def test_auto_takes_k4_where_the_tpu_takes_its_sorted_kernel():
    """``auto``'s choice against the JAX package's own promotion rule on a
    TPU (``auto_selects_coarse``), over rows, bin slots and the missing
    slot; K3 above 128 nodes, as the TPU's f32 build there."""
    for n in (1000, 65535, 65536, 1_000_000):
        for B in (16, 127, 128, 129, 256, 257, 258):
            for miss in (False, True):
                tpu = auto_selects_coarse(n, B, miss, numeric=True,
                                          col_split=False, backend="tpu")
                for N in (1, 128):
                    want = "scan" if tpu else "int8x2"
                    assert resolve_hist_kernel("auto", n, N, B, miss) == \
                        want, (n, B, miss, N)
                assert resolve_hist_kernel("auto", n, 256, B, miss) == "f32"


def test_k4_through_build_hist_at_its_size():
    """At 70,000 rows and 256 slots ``auto`` runs K4's plain version, and
    it gives ``prehot``'s bits."""
    n, N, B = 70_000, 8, 256
    bins, gpair, rel = _data(n, B, N, seed=17)
    assert resolve_hist_kernel("auto", n, N, B, False) == "scan"
    t = [torch.from_numpy(a) for a in (bins, gpair, rel)]
    got = build_hist(*t, N, B, method="auto", has_missing=False).numpy()
    want = np.asarray(jax_build_hist(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(rel), N, B,
        method="prehot"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,B", [(1, 16), (4, 17), (64, 256), (128, 257)])
def test_k3_matches_segment_and_pallas_f32(N, B):
    n = 1000
    bins, gpair, rel = _data(n, B, N, seed=21 + N + B)
    seg = np.asarray(build_hist_segment(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(rel), N, B))
    pal = np.asarray(build_hist_pallas(
        jnp.asarray(bins).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        precision="f32", block_rows=256, interpret=True))
    for method in ("segment", "onehot", "pallas:f32"):
        got = _port(bins, gpair, rel, N, B, method)
        for want in (seg, pal):
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got / scale, want / scale,
                                       rtol=1e-5, atol=1e-5, err_msg=method)


def test_k3_within_one_rounding_of_the_exact_sum():
    """K3 is deterministic and, up to its 2^-k quantum per row, one f32
    rounding from the float64 sum: no f32 summation order promises that."""
    n, N, B = 20000, 2, 8
    bins, gpair, rel = _data(n, B, N, seed=5)
    got = _port(bins, gpair, rel, N, B, "segment")
    exact = np.zeros((N, F, B, 2))
    act = rel < N
    for f in range(F):
        np.add.at(exact, (rel[act], f, bins[act, f].astype(np.int64)),
                  gpair[act].astype(np.float64))
    qscale, _ = fixed_point_scale(torch.from_numpy(gpair))
    quantum = n * 0.5 / qscale.numpy().astype(np.float64)   # per component
    bound = np.spacing(np.abs(exact).astype(np.float32)) / 2 + quantum
    assert (np.abs(got - exact) <= bound).all()
    perm = np.random.RandomState(6).permutation(n)
    np.testing.assert_array_equal(
        _port(bins[perm], gpair[perm], rel[perm], N, B, "segment"), got)


def test_k3_scale_never_overflows_int64():
    """Huge and tiny components: k is clamped to [-100, 100], so a
    component whose largest value is ~1e-20 still keeps ~50 bits."""
    g = np.asarray([[3e30, 1e-20], [-2.5, 0.0]], np.float32)
    qscale, inv = fixed_point_scale(torch.from_numpy(g))
    assert (qscale.numpy() * inv.numpy() == 1.0).all()
    q = np.round(np.abs(g).astype(np.float64) * qscale.numpy())
    assert (q.sum(axis=0) <= 2.0 ** 62).all()
    bins = np.zeros((2, 1), np.uint8)
    rel = np.zeros(2, np.int32)
    out = build_hist_f32_reference(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(rel),
        qscale, inv, 1, 1).numpy()
    np.testing.assert_allclose(out[0, 0, 0], g.sum(axis=0), rtol=1e-6)


def test_int8x2_overflow_guard():
    """int32 counters are exact while n * 128 < 2^31; checked through the
    predicate, without allocating 16.7M rows."""
    assert INT8X2_MAX_ROWS == 16_777_215
    assert int8x2_fits(INT8X2_MAX_ROWS) and not int8x2_fits(2 ** 24)
    assert resolve_hist_kernel("auto", INT8X2_MAX_ROWS, 128, 16) == "int8x2"
    assert resolve_hist_kernel("auto", INT8X2_MAX_ROWS, 128, 256) == "scan"
    for B in (16, 256):
        assert resolve_hist_kernel("auto", 2 ** 24, 1, B) == "f32"
        assert resolve_hist_kernel("prehot", 2 ** 24, 1, B) == "f32"
    for method in ("pallas", "pallas:int8x2"):
        with pytest.raises(ValueError, match="overflow"):
            resolve_hist_kernel(method, 2 ** 24, 1, 256)


def test_hist_method_map():
    k2 = ("auto", "pallas", "pallas:int8x2", "prehot", "auto+nosub")
    k3 = ("pallas:f32", "segment", "onehot")
    assert {resolve_hist_kernel(m, 1000, 128, 256) for m in k2} == \
        {"int8x2"}
    assert {resolve_hist_kernel(m, 1000, 4, 256) for m in k3} == {"f32"}
    assert resolve_hist_kernel("auto", 1000, 256, 256) == "f32"
    assert resolve_hist_kernel("auto+nosub", 10 ** 6, 4, 256) == "scan"
    for m in ("pallas:bf16x2", "pallas:bf16", "scan", "mega", "fused",
              "coarse", "auto+sub"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_hist_kernel(m, 1000, 4, 256)
    with pytest.raises(ValueError, match="unknown"):
        resolve_hist_kernel("magic", 1000, 4, 256)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CUDA tensor the kernel runs or the call raises; a CPU tensor
    never reaches the kernel wrappers."""
    from xgboost_tpu_torch.ops.cuda.hist import (hist_f32_cuda,
                                                 hist_int8x2_cuda,
                                                 hist_scan_cuda)

    bins = torch.zeros((4, 2), dtype=torch.uint8)
    rel = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        hist_int8x2_cuda(bins, g.int(), rel, torch.ones(2), 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hist_scan_cuda(bins, g.int(), rel, torch.ones(2), 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hist_f32_cuda(bins, g, rel, torch.ones(2), torch.ones(2), 1, 4)
    assert os.path.exists(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "xgboost_tpu_torch", "csrc", "hist.cu"))
