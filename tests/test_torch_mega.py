"""The ``mega`` schedule (ROADMAP A.6) and sibling subtraction (``+sub``)
in the port, on the CPU, against the JAX package's.

``hist_method="mega"`` runs one level body for every level of a
depthwise tree (``tree/grow.py MegaLevels``) and one split body for
every split of a leaf-wise tree (``tree/lossguide.py MegaPairs``), each
captured once per matrix as a CUDA graph on the card and replayed
(``ops/cuda/graphs.py CapturedLoop``); here the same bodies run eagerly
through the same cache. Neither reorders any arithmetic of ``scan``, so
the bar is the JAX package's own (``tests/test_mega.py``): the port's
``mega`` saves the port's ``scan`` bytes after the stored method string is
normalised, and the dumps with stats are equal. Against the JAX
package's ``mega`` the trees compare node by node under the near-tie
certificate of ``tests/test_torch_train.py`` (the split search's sums
run in another order than XLA's), the counts of trees equal in full as
measured. The JAX package's ``mega`` runs as its own tests run it, with
one change: its CPU scan builds (``ops/histogram.py _segment_hist_acc``,
f32 segment sums) go through its ``prehot`` int8x2 build, the integers
its TPU's sorted kernel sums and the port's K4 sums (as
``tests/test_torch_paged_two_level.py`` runs the JAX package's page
builds); with f32 sums its trees drift from the int8x2 ones past the
certificate within two rounds.

Also held: the gates (depth 7 and ``colsample_bynode`` 0.5 train as
``scan``), the lossguide tier's fall-backs, a 4-shard CPU row mesh, the
capture cache (one preparation a matrix, none in steady rounds, a tree
``max_depth`` or ``max_leaves - 1`` iterations), no host read in either
body, and ``+sub`` against the JAX package's ``+sub`` over a K2 and an
f32 method, its ``subtract_siblings`` bit for bit, and its limits (no
mesh, at least 8 rows).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.ops.histogram import (
    subtract_siblings as jax_subtract_siblings)
from xgboost_tpu_torch.context import Mesh
from xgboost_tpu_torch.obs import trace
from xgboost_tpu_torch.ops import histogram as H
from xgboost_tpu_torch.ops.cuda.graphs import CapturedLoop
from xgboost_tpu_torch.tree import grow as G
from xgboost_tpu_torch.tree import lossguide as L
from xgboost_tpu_torch.tree.shards import RowShards
from test_torch_train import LEAF_ATOL, compare_forests

CPU = {"device": "cpu"}
BIN = {"objective": "binary:logistic", "eta": 0.3, "max_bin": 64,
       "base_score": 0.5}
LOSSGUIDE = dict(BIN, grow_policy="lossguide", max_leaves=10, max_depth=0)


@pytest.fixture(scope="module", autouse=True)
def jax_scan_in_int8x2():
    """The JAX package's CPU scan histograms through its int8x2
    ``prehot`` build (module docstring)."""
    import jax

    from xgboost_tpu.ops import histogram as JH

    def int8x2(bins, gpair, rel_pos, n_nodes, max_nbins, acc="f32"):
        return JH.build_hist(bins, gpair, rel_pos, n_nodes, max_nbins,
                             method="prehot")

    mp = pytest.MonkeyPatch()
    mp.setattr(JH, "_segment_hist_acc", int8x2)
    jax.clear_caches()
    yield
    mp.undo()
    jax.clear_caches()


def _binary_data(n=2500, F=8, missing=False, seed=11):
    """``tests/test_mega.py``'s data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (np.nan_to_num(X) @ rng.randn(F) > 0).astype(np.float32)
    if missing:
        X[rng.rand(n, F) < 0.1] = np.nan
    return X, y


def _norm_raw(raw) -> bytes:
    """``save_raw`` stores the method string; the trees are the parity
    surface (``tools/validate_mega.py _norm_raw``)."""
    return bytes(raw).replace(b"i\x04mega", b"i\x04scan")


def _port(params, X, y, rounds, method, **kw):
    b = xt.train(dict(params, hist_method=method, **CPU, **kw),
                 xt.DMatrix(X, label=y), rounds, verbose_eval=False)
    return b, b.get_dump(with_stats=True), _norm_raw(b.save_raw("ubj"))


def _mega_loop(b):
    return b.gbm._grower._mega


def _check(params, X, y, rounds, full_min, **kw):
    """Port ``mega`` against port ``scan`` (bytes and dumps) and against
    JAX ``mega`` (trees, at least ``full_min`` equal in full); returns
    the port's mega booster."""
    bm, dm, rm = _port(params, X, y, rounds, "mega", **kw)
    _, ds, rs = _port(params, X, y, rounds, "scan", **kw)
    assert dm == ds
    assert rm == rs
    jb = xgb.train(dict(params, hist_method="mega", **kw),
                   xgb.DMatrix(X, label=y), rounds, verbose_eval=False)
    full, ties, drift = compare_forests(jb.gbm.trees, bm.gbm.trees, 0.3)
    print(f"{params} {kw}: {full} of {len(jb.gbm.trees)} trees equal to "
          f"the JAX package's mega in full, near ties {ties}, leaf drift "
          f"{drift:.3e}")
    assert full >= full_min
    whole = full // (len(jb.gbm.trees) // rounds)     # rounds in full
    if whole:       # (0, 0) would mean every round
        np.testing.assert_allclose(
            bm.predict(xt.DMatrix(X), iteration_range=(0, whole)),
            jb.predict(xgb.DMatrix(X), iteration_range=(0, whole)),
            rtol=1e-5, atol=LEAF_ATOL)
    return bm


# ---- depthwise --------------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
def test_mega_depthwise_matches_scan_and_jax(missing):
    X, y = _binary_data(missing=missing)
    bm = _check(dict(BIN, max_depth=4), X, y, 4, full_min=4)
    loop = _mega_loop(bm)
    # one preparation for the matrix, every level an iteration of it
    assert (loop.captures, loop.cache_size()) == (1, 1)
    assert loop.eager_runs == 4 * 4


@pytest.mark.parametrize("extra", [
    {"gamma": 0.5, "min_child_weight": 5.0},
    {"colsample_bytree": 0.6, "subsample": 0.8, "reg_alpha": 0.5,
     "max_delta_step": 0.7},
])
def test_mega_depthwise_option_grid(extra):
    """``tests/test_mega.py:90``'s two option sets."""
    X, y = _binary_data(n=1500, seed=12)
    _check(dict(BIN, max_depth=3, **extra), X, y, 3, full_min=3)


def test_mega_multiclass_replays_one_graph_a_class():
    rng = np.random.RandomState(13)
    X = rng.randn(1500, 6).astype(np.float32)
    y = ((np.abs(X @ rng.randn(6)) * 2).astype(np.int32) % 4).astype(
        np.float32)
    # the classes' softmax gradients differ by an ulp between the packages
    # (ROADMAP C): a certified near tie in the third tree
    bm = _check(dict(BIN, objective="multi:softprob", num_class=4,
                     max_depth=3), X, y, 3, full_min=2)
    loop = _mega_loop(bm)
    assert loop.captures == 1 and loop.eager_runs == 3 * 4 * 3


def test_mega_constraints_and_level_sampling():
    """Monotone plus interaction constraints, and ``colsample_bylevel``
    0.7 (its masks drawn on the host, one a level, indexed by the
    depth), stay inside the gate."""
    X, y = _binary_data(n=1500, seed=16)
    _check(dict(BIN, max_depth=4,
                monotone_constraints="(1,-1,0,0,0,0,0,0)",
                interaction_constraints="[[0, 1], [2, 3, 4]]"),
           X, y, 3, full_min=3)
    bm = _check(dict(BIN, max_depth=4, colsample_bylevel=0.7), X, y, 3,
                full_min=3)
    assert _mega_loop(bm).captures == 1


@pytest.mark.parametrize("extra", [{"max_depth": 7},
                                   {"max_depth": 4, "colsample_bynode": 0.5}])
def test_mega_gates_fall_back_to_scan(extra):
    """Outside the JAX package's gates (``2^max_depth <= 64``,
    ``colsample_bynode == 1``) ``mega`` trains as the unrolled ``scan``:
    its bytes, and no mega program made."""
    X, y = _binary_data(n=1500, seed=17)
    bm, dm, rm = _port(dict(BIN, **extra), X, y, 2, "mega")
    _, ds, rs = _port(dict(BIN, **extra), X, y, 2, "scan")
    assert (dm, rm) == (ds, rs)
    assert _mega_loop(bm) is None


def test_mega_steady_rounds_prepare_nothing():
    """A second tree and every later round reuse the matrix's program;
    a second matrix of the same shape gets its own (the graph reads the
    bins in place)."""
    X, y = _binary_data(n=1200, seed=18)
    dm = xt.DMatrix(X, label=y)
    bst = xt.Booster(dict(BIN, max_depth=3, hist_method="mega", **CPU))
    bst.update(dm, 0)
    loop = _mega_loop(bst)
    assert (loop.captures, loop.eager_runs) == (1, 3)
    for i in range(1, 4):
        bst.update(dm, i)
    assert (loop.captures, loop.cache_size(), loop.eager_runs) == (1, 1, 12)
    other = xt.DMatrix(X[::-1].copy(), label=y[::-1].copy())
    cpu = torch.device("cpu")
    assert G.mega_key(RowShards.of(other.binned(64, cpu).bins)) \
        != G.mega_key(RowShards.of(dm.binned(64, cpu).bins))


# ---- leaf-wise -------------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
def test_mega_lossguide_matches_scan_and_jax(missing):
    X, y = _binary_data(missing=missing, seed=14)
    bm = _check(LOSSGUIDE, X, y, 4, full_min=4)
    loop = _mega_loop(bm)
    # the root's search in the load, then max_leaves - 1 splits a tree
    assert loop.captures == 1 and loop.eager_runs == 4 * 9


@pytest.mark.parametrize("extra", [
    {"colsample_bylevel": 0.7},
    {"monotone_constraints": "(1,-1,0,0,0,0,0,0)"},
])
def test_mega_lossguide_fallback_tiers(extra):
    """The tiers the device loop does not cover run the host loop over
    scan's pair search: scan's bytes, no mega program."""
    X, y = _binary_data(n=1500, seed=15)
    p = dict(LOSSGUIDE, max_leaves=8, **extra)
    bm, dm, rm = _port(p, X, y, 3, "mega")
    _, ds, rs = _port(p, X, y, 3, "scan")
    assert (dm, rm) == (ds, rs)
    assert _mega_loop(bm) is None


def test_mega_lossguide_depth_limit_and_gamma():
    X, y = _binary_data(n=1500, seed=19)
    for extra in ({"max_depth": 3}, {"gamma": 0.3, "max_leaves": 24}):
        p = dict(LOSSGUIDE, **extra)
        assert _port(p, X, y, 3, "mega")[1:] == _port(p, X, y, 3, "scan")[1:]


# ---- a 4-shard row mesh -----------------------------------------------------

@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_mega_row_mesh(policy):
    """Every shard's advance and build and the reduction in one body
    (the JAX package's ``mega_row_axis``): the mesh's ``scan`` bytes."""
    X, y = _binary_data(n=4096, F=6, seed=20)
    p = (dict(BIN, max_depth=4) if policy == "depthwise"
         else dict(LOSSGUIDE, max_leaves=8))
    mesh = Mesh(["cpu"] * 4)
    bm, dm, rm = _port(p, X, y, 3, "mega", mesh=mesh)
    _, ds, rs = _port(p, X, y, 3, "scan", mesh=mesh)
    assert (dm, rm) == (ds, rs)
    loop = _mega_loop(bm)
    assert loop.captures == 1 and loop.eager_runs > 0


class _Comm:
    """A stand-in for a multi-rank host communicator."""

    def is_distributed(self):
        return True


def test_capture_needs_one_device_and_no_communicator():
    """A body is captured only where every shard sits on one device and
    no communicator joins the reduction; elsewhere it runs uncaptured,
    under its own span."""
    parts = [torch.zeros((8, 2), dtype=torch.uint8)] * 2
    assert G.captures_on_one_device(RowShards(parts))

    class M:
        comm = _Comm()

    assert not G.captures_on_one_device(RowShards(parts, M()))

    class Prog:
        n = 0

        def body(self):
            Prog.n += 1

    trace.enable()
    try:
        trace.reset()
        loop = CapturedLoop("t", "cpu")
        loop.run("k", Prog, 3)
        loop.run("k", Prog, 2, capture=False)
        names = [s.name for s in trace.tracer().spans()]
    finally:
        trace.disable()
    assert Prog.n == 5 and loop.captures == 1 and loop.cache_size() == 1
    assert names == ["graphs/eager", "graphs/uncaptured"]


# ---- no host read in a body -------------------------------------------------

class _NoHostReads(TorchDispatchMode):
    """Raises on any op that reads a device value on the host (what a
    CUDA graph capture refuses), outside the kernels' plain versions."""

    BANNED = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default,
              torch.ops.aten.item.default}

    def __init__(self):
        super().__init__()
        self.plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED and not self.plain:
            raise AssertionError(f"host read in a mega body: {func}")
        return func(*args, **(kwargs or {}))


def test_mega_bodies_read_nothing_on_the_host(monkeypatch):
    """Neither body reads the device on the host (``.item()``, a 0-d
    index, ``int(t)``, ``nonzero``), so each captures; the CPU's plain
    K4 (its sort reads a size) stands in for the kernel there."""
    mode = _NoHostReads()
    plain = H.scan_acc_reference

    def plain_k4(*a):
        mode.plain += 1
        try:
            return plain(*a)
        finally:
            mode.plain -= 1

    monkeypatch.setattr(H, "scan_acc_reference", plain_k4)
    calls = {"levels": 0, "pairs": 0}
    for cls, key in ((G.MegaLevels, "levels"), (L.MegaPairs, "pairs")):
        def checked(self, _orig=cls.body, _key=key):
            calls[_key] += 1
            with mode:
                _orig(self)

        monkeypatch.setattr(cls, "body", checked)
    X, y = _binary_data(n=800, missing=True, seed=21)
    _port(dict(BIN, max_depth=3, monotone_constraints="(1,0,0,0,0,0,0,0)",
               colsample_bylevel=0.8), X, y, 2, "mega")
    _port(dict(LOSSGUIDE, max_leaves=6, max_depth=3), X, y, 2, "mega")
    assert calls == {"levels": 6, "pairs": 10}


# ---- sibling subtraction ----------------------------------------------------

@pytest.mark.parametrize("method,full_min", [("prehot", 5), ("segment", 5)])
def test_sub_matches_jax_sub(method, full_min):
    """``"<kernel>+sub"`` over K2 (``prehot``) and an f32 method
    (``segment``, K3) against the JAX package's: each level past the
    root builds every parent's smaller child from its rows gathered into
    an ``n // 2`` buffer and subtracts it."""
    rng = np.random.RandomState(5)
    X = rng.randn(3000, 8).astype(np.float32)
    X[rng.rand(3000, 8) < 0.05] = np.nan
    y = (np.nan_to_num(X) @ rng.randn(8) > 0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 5, "eta": 0.3,
         "base_score": 0.5, "hist_method": method + "+sub"}
    jb = xgb.train(p, xgb.DMatrix(X, label=y), 5, verbose_eval=False)
    tb = xt.train(dict(p, **CPU), xt.DMatrix(X, label=y), 5,
                  verbose_eval=False)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3)
    print(f"{method}+sub: {full} trees equal in full, ties {ties}, drift "
          f"{drift:.3e}")
    assert full >= full_min
    assert max(t.max_depth() for t in tb.gbm.trees) == 5


def test_sub_builds_the_smaller_children(monkeypatch):
    """One ``+sub`` level: the port's compacted K2 build and subtraction
    against the JAX package's ``subtract_siblings`` over the same
    compacted build, bit for bit, and the built rows at most n // 2."""
    rng = np.random.RandomState(6)
    n, F, B = 1000, 5, 32
    bins = torch.from_numpy(rng.randint(0, B, (n, F)).astype(np.uint8))
    gp = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    pos = torch.from_numpy(rng.randint(3, 7, n).astype(np.int64))  # depth 2
    parent = H.build_hist(bins, gp, torch.from_numpy(
        (rng.randint(0, 2, n)).astype(np.int32)), 2, B, method="prehot")
    counts = torch.bincount(pos - 3, minlength=4)
    built_left = counts[0::2] <= counts[1::2]
    got = H.build_smaller_children(bins, gp, pos, 3, 4, built_left, parent,
                                   B, "prehot")
    built = ((pos - 3) & 1 == 0) == built_left[(pos - 3) >> 1]
    assert int(built.sum()) <= n // 2
    idx = torch.nonzero(built)[:, 0]
    cap = n // 2
    bc = torch.zeros((cap, F), dtype=torch.uint8)
    gc = torch.zeros((cap, 2))
    pc = torch.full((cap,), 2, dtype=torch.int32)
    bc[:len(idx)], gc[:len(idx)] = bins[idx], gp[idx]
    pc[:len(idx)] = ((pos[idx] - 3) >> 1).to(torch.int32)
    child = H.build_hist(bc, gc, pc, 2, B, method="prehot")
    jl, jr = jax_subtract_siblings(jnp.asarray(parent.numpy()),
                                   jnp.asarray(child.numpy()),
                                   jnp.asarray(built_left.numpy()))
    want = np.stack([np.asarray(jl), np.asarray(jr)], 1).reshape(
        got.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    tl, tr = H.subtract_siblings(parent, child, built_left)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_sub_is_ignored_on_a_mesh_and_below_8_rows():
    """The JAX package's limits: under a mesh, with fewer than 8 rows, and
    where ``auto`` takes the sorted build, ``+sub`` trains the method's
    own bytes; a two-level schedule ignores it too."""
    X, y = _binary_data(n=400, F=4, seed=22)
    rows = RowShards([torch.zeros((400, 4), dtype=torch.uint8)])
    assert G.sibling_subtraction("auto+sub", rows, 257, True, True)
    assert not G.sibling_subtraction("auto+nosub", rows, 257, True, True)
    assert not G.sibling_subtraction("scan+sub", rows, 257, True, True)
    big = RowShards([torch.zeros((1 << 16, 4), dtype=torch.uint8)])
    assert not G.sibling_subtraction("auto+sub", big, 257, True, True)
    assert G.sibling_subtraction("prehot+sub", big, 257, True, True)
    tiny = RowShards([torch.zeros((7, 4), dtype=torch.uint8)])
    assert not G.sibling_subtraction("auto+sub", tiny, 257, True, True)
    mesh = Mesh(["cpu"] * 4)
    for kw, n in (({"mesh": mesh}, 400), ({}, 7)):
        raws = []
        for m in ("auto", "auto+sub"):
            b = xt.train(dict(BIN, max_depth=3, hist_method=m, **CPU, **kw),
                         xt.DMatrix(X[:n], label=y[:n]), 2,
                         verbose_eval=False)
            b.set_param({"hist_method": "auto"})
            raws.append(bytes(b.save_raw("ubj")))
        assert raws[0] == raws[1], kw
