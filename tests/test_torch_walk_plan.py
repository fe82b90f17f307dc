"""K1's launch plan (``ops/cuda/walk.py walk_plan``) and its summation
order, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here the plan it is given is checked (chunks of tree
slots that cover the forest once, in order, each one contiguous span of
the pool that fits its shared-memory buffer; the spread schedule's
geometry; which schedule a batch takes), a torch emulation of the staged
schedule (chunk by chunk, chunk-local node indices, the kernel's routing)
is held against ``walk_packed_reference`` bit for bit, and the fold replica
``walk_fold_kernel_order`` against the plain walk and the JAX package's
``ops/walk.py walk_packed`` within the reassociation bound, and against a
scalar replay of the order it states. Inputs are made with numpy from a
seed.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.ops.walk import walk_packed as jax_walk_packed
from xgboost_tpu_torch.ops.cuda.walk import (CHUNK_MAX_SLOTS, META_BYTES,
                                             SMEM_MAX, SPREAD_MAX_ROWS,
                                             SPREAD_THREADS,
                                             SPREAD_X_FEATURES,
                                             STAGED_MAX_ROWS, slot_spans,
                                             staged_rows, walk_plan)
from xgboost_tpu_torch.ops.walk import (walk_fold_kernel_order,
                                        walk_packed_reference)
from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
from xgboost_tpu_torch.testing import make_forest

SMS = 132
U = 2.0 ** -24

# kind -> (trees, depth, features, groups, categorical features)
FORESTS = {
    "higgs": (500, 8, 28, 1, ()),     # the serving forest's shape, Tp 512
    "one": (70, 6, 7, 1, ()),
    "three": (45, 5, 7, 3, ()),
    "cat": (40, 6, 7, 2, (1, 4)),
    "single": (1, 8, 7, 1, ()),       # the training's eval walk, Tp 1
    "tp8": (5, 6, 7, 1, ()),          # Tp below 32
    "deep": (6, 15, 9, 1, ()),        # trees past a chunk buffer
    "wide": (33, 6, 1100, 1, ()),     # features read from global memory
}


@functools.lru_cache(maxsize=None)
def _forest(kind, seed=5):
    n_trees, depth, F, G, cats = FORESTS[kind]
    trees, info = make_forest(n_trees, depth, F, n_groups=G,
                              cat_features=cats, seed=seed)
    return PackedForest.from_trees(trees, info, G)


def _rows(kind, n, seed=6):
    """[n, F] f32 rows for a forest of ``kind``: N(0, 1), 10% NaN; the
    categorical features hold codes, edge codes and NaN."""
    F = FORESTS[kind][2]
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    for c in FORESTS[kind][4]:
        X[:, c] = rng.randint(-2, 20, n)
        X[rng.rand(n) < 0.2, c] = rng.choice([-0.5, 1e10, 15.7, 16.0], 1)
    X[rng.rand(n, F) < 0.1] = np.nan
    return X


def _plan(kind, n, schedule=None):
    pf = _forest(kind)
    return walk_plan(n, pf.tree_offsets.shape[0], pf.slot_spans(),
                     FORESTS[kind][2], pf.n_groups, SMS, schedule)


def _reference(pf, X, base):
    d = pf.device_arrays(torch.device("cpu"))
    return walk_packed_reference(
        d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
        d["group_onehot"], X, base, d.get("cat_words"),
        max_depth=pf.max_depth, tree_chunk=tree_step(X.shape[0]),
        leaf_index=True)


def _replica(pf, leaves, base):
    d = pf.device_arrays(torch.device("cpu"))
    return walk_fold_kernel_order(d["values"][leaves.long()],
                                  d["tree_weight"], d["tree_group"], base)


# ---- the plan ------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(FORESTS))
def test_slot_spans_hold_each_tree(kind):
    """A real slot's span is its tree's nodes (the last tree's also holds
    the inert leaf after it where no pad slot starts there); a pad slot's
    is that leaf."""
    pf = _forest(kind)
    spans = pf.slot_spans()
    T, Tp, N = pf.n_trees, pf.tree_offsets.shape[0], pf.words.shape[0]
    assert spans.shape == (Tp, 2)
    np.testing.assert_array_equal(spans[:T, 0], pf.tree_offsets[:T])
    ends = pf.tree_offsets[:T] + pf.n_nodes
    assert ends[-1] == N - 1
    if Tp == T:
        ends[-1] = N
    np.testing.assert_array_equal(spans[:T, 1], ends)
    assert (spans[T:] == [N - 1, N]).all()
    np.testing.assert_array_equal(slot_spans(pf.tree_offsets, N), spans)


@pytest.mark.parametrize("n", [SPREAD_MAX_ROWS + 1, 100_000, 1_000_000])
@pytest.mark.parametrize("kind", ["higgs", "one", "three", "cat", "single",
                                  "tp8", "wide"])
def test_staged_chunks_cover_every_slot_once_in_order(kind, n):
    """Chunks of consecutive slots cover [0, Tp) once, in order; each
    chunk's span is contiguous, starts on a 16-byte boundary, holds its
    slots' trees and fits its buffer; the block's shared memory adds up
    and fits the card."""
    pf = _forest(kind)
    F, G = FORESTS[kind][2], pf.n_groups
    plan = _plan(kind, n)
    assert plan.schedule == "staged"
    T = staged_rows(n, SMS)
    assert plan.threads == plan.rows == T and T % 32 == 0
    assert T <= STAGED_MAX_ROWS
    assert plan.n_chunks == len(plan.chunks)
    spans = pf.slot_spans()
    end = 0
    for first, stop, start, nodes in plan.chunks:
        assert first == end and stop > first
        assert stop - first <= CHUNK_MAX_SLOTS
        assert start % 2 == 0 and 0 < nodes <= plan.capacity
        assert spans[first:stop, 0].min() >= start
        assert spans[first:stop, 1].max() == start + nodes
        end = stop
    assert end == pf.tree_offsets.shape[0]
    assert plan.capacity % 2 == 0
    meta = 2 * min(pf.tree_offsets.shape[0], CHUNK_MAX_SLOTS) * META_BYTES
    x = T * F * 4 if plan.stage_x else 0
    acc = G * T * 4 if G > 1 else 0
    assert plan.smem == plan.capacity * 16 + meta + x + acc
    assert plan.smem <= SMEM_MAX == 232_448


@pytest.mark.parametrize("Tp", [1, 8, 32, 64, 512, 1024, 4096])
def test_spread_geometry(Tp):
    """The spread block: S slots a round (a multiple of 32, at most the
    block), rows x S threads, a row's features staged up to 1,024."""
    spans = np.zeros((Tp, 2), np.int64)
    spans[:, 1] = 1
    for F, G in ((28, 1), (7, 3), (1100, 1)):
        plan = walk_plan(1, Tp, spans, F, G, SMS)
        S = plan.slots
        assert plan.schedule == "spread" and S % 32 == 0
        assert S == min(SPREAD_THREADS, max(32, Tp))
        assert plan.threads == plan.rows * S <= SPREAD_THREADS
        assert plan.rows == SPREAD_THREADS // S
        assert plan.stage_x == int(F <= SPREAD_X_FEATURES)
        assert plan.smem == (plan.rows * S * 4
                             + (S * 4 + plan.rows * G * 4 if G > 1 else 0)
                             + (plan.rows * F * 4 if plan.stage_x else 0))
        assert plan.chunks == () and plan.n_chunks == 0


def test_plan_picks_the_schedule_by_rows():
    """Batches of up to SPREAD_MAX_ROWS rows take the spread schedule,
    larger ones the staged; a named schedule is taken as named."""
    for n, want in ((1, "spread"), (512, "spread"),
                    (SPREAD_MAX_ROWS, "spread"),
                    (SPREAD_MAX_ROWS + 1, "staged"), (100_000, "staged")):
        assert _plan("higgs", n).schedule == want, n
    assert _plan("higgs", 100_000, "spread").schedule == "spread"
    assert _plan("higgs", 1, "staged").schedule == "staged"
    with pytest.raises(ValueError, match="unknown walk schedule"):
        _plan("higgs", 1, "fast")


def test_a_tree_past_the_chunk_buffer_routes_to_spread():
    """The deep forest's trees (~20,000 nodes) overflow a chunk buffer:
    the plan sends even 100,000 rows to the spread schedule, and a
    staged walk asked for by name raises."""
    spans = _forest("deep").slot_spans()
    assert (spans[:, 1] - spans[:, 0]).max() * 8 > SMEM_MAX // 2
    assert _plan("deep", 100_000).schedule == "spread"
    with pytest.raises(ValueError, match="does not fit"):
        _plan("deep", 100_000, "staged")


@pytest.mark.parametrize("kind,staged_x", [("higgs", 1), ("wide", 0)])
def test_wide_batches_read_features_from_global_memory(kind, staged_x):
    """28 features are staged in both schedules; 1,100 in neither."""
    assert _plan(kind, 100_000).stage_x == staged_x
    assert _plan(kind, 1).stage_x == staged_x


@pytest.mark.parametrize("kind", ["higgs", "one", "three", "cat", "single",
                                  "tp8"])
def test_spread_and_eval_walk_plans_use_every_lane(kind):
    """Tp = 1 at 100,000 rows (the eval walk) lands on the staged
    schedule, a thread a row; small batches on the spread one."""
    assert _plan(kind, 100_000).schedule == "staged"
    assert _plan(kind, 64).schedule == "spread"


# ---- the staged schedule, emulated ---------------------------------------


def emulate_staged(pf, X, plan):
    """Leaf indices [n, Tp] of the staged schedule's walk in torch: chunk
    by chunk, each slot walked over the chunk's span alone with
    chunk-local indices (idx - span start), routed as ``csrc/walk.cu``
    routes (default left: right iff x > v; default right: iff
    !(x <= v); categorical codes through the node's global row of
    ``cat_words``). Asserts that no index leaves its chunk."""
    words = torch.from_numpy(pf.words.view(np.int32))
    values = torch.from_numpy(pf.values)
    cat = torch.from_numpy(pf.cat_words.view(np.int32)) if pf.has_cat \
        else None
    offs = torch.from_numpy(pf.tree_offsets).long()
    n, Tp = X.shape[0], offs.shape[0]
    out = torch.full((n, Tp), -1, dtype=torch.int64)
    for first, stop, start, nodes in plan.chunks:
        lw, lv = words[start:start + nodes], values[start:start + nodes]
        idx = (offs[first:stop] - start)[None, :].expand(n, -1).clone()
        for _ in range(pf.max_depth):
            assert bool(((idx >= 0) & (idx < nodes)).all())
            w = lw[idx]
            leaf = w < 0
            dl = ((w >> 29) & 1) == 1
            x = torch.gather(X, 1, ((w >> 16) & 0x1FFF).long())
            v = lv[idx]
            right = torch.where(dl, x > v, ~(x <= v))
            if cat is not None:
                is_cat = ((w >> 30) & 1) == 1
                xt = torch.trunc(x)
                ok = (xt >= 0) & (xt < cat.shape[1] * 32)
                code = torch.where(ok, xt, torch.zeros_like(xt)).long()
                word = cat[idx + start, code // 32]
                in_set = ((word >> (code % 32)) & 1) == 1
                right = torch.where(is_cat, torch.where(ok, ~in_set, ~dl),
                                    right)
            nxt = idx + (w & 0xFFFF).long() + right.long()
            idx = torch.where(leaf, idx, nxt)
        assert bool(((idx >= 0) & (idx < nodes)).all())
        out[:, first:stop] = idx + start
    return out


@pytest.mark.parametrize("kind", ["higgs", "one", "three", "cat", "single",
                                  "tp8", "wide"])
def test_staged_emulation_equals_the_plain_walk(kind):
    """The staged schedule's chunk-by-chunk walk reaches the plain walk's
    leaves, pad slots included, bit for bit."""
    pf = _forest(kind)
    X = torch.from_numpy(_rows(kind, 300))
    base = torch.zeros(pf.n_groups)
    _, want = _reference(pf, X, base)
    plan = _plan(kind, 100_000)
    assert plan.n_chunks >= 1
    got = emulate_staged(pf, X, plan)
    assert torch.equal(got, want.long())


def test_staged_emulation_with_small_chunks():
    """The same with the HIGGS-shape forest cut into many small chunks
    (the plan's buffer of a wider tile), pad chunk alone."""
    pf = _forest("higgs")
    X = torch.from_numpy(_rows("higgs", 200, seed=8))
    _, want = _reference(pf, X, torch.zeros(1))
    plan = _plan("higgs", 100_000)
    small = plan._replace(chunks=tuple(
        (t, t + 1, int(pf.slot_spans()[t, 0]) & ~1,
         int(pf.slot_spans()[t, 1]) - (int(pf.slot_spans()[t, 0]) & ~1))
        for t in range(pf.tree_offsets.shape[0])))
    assert torch.equal(emulate_staged(pf, X, small), want.long())


# ---- the summation order -------------------------------------------------


def _bound(pf, leaves, base, tree_chunk):
    """Per (row, group) bound on |replica - plain| from reassociating the
    f32 leaf sum (``chip_smoke.py sum_bound``)."""
    d = pf.device_arrays(torch.device("cpu"))
    Tp = pf.tree_offsets.shape[0]
    terms = (d["values"][leaves.long()] * d["tree_weight"][None, :]).abs()
    mag = terms.double() @ d["group_onehot"].double() \
        + base.abs().double()[None, :]
    k_plain = tree_chunk + math.ceil(Tp / tree_chunk) + 1
    k_kernel = (math.ceil(Tp / 32) + 6) if pf.n_groups == 1 else Tp + 1
    return (k_plain + k_kernel) * U * mag


@pytest.mark.parametrize("n_trees,G,cats", [
    (1, 1, ()), (3, 1, ()), (20, 1, ()), (33, 1, ()), (300, 1, ()),
    (500, 1, ()), (45, 3, ()), (40, 2, (1, 4))])
def test_fold_replica_within_the_bound_of_both_walks(n_trees, G, cats):
    """``walk_fold_kernel_order`` against the port's plain walk and the
    JAX package's ``walk_packed`` on the same numpy inputs: within the f32
    reassociation bound of each (Tp from 1 to 512, 1, 3 and 2 groups,
    categorical splits)."""
    trees, info = make_forest(n_trees, 6, 7, n_groups=G, cat_features=cats,
                              seed=n_trees)
    pf = PackedForest.from_trees(trees, info, G)
    kind = "cat" if cats else "one"
    X = _rows(kind, 257, seed=n_trees + 1)
    base = np.linspace(-0.3, 0.3, G).astype(np.float32)
    Xt, bt = torch.from_numpy(X), torch.from_numpy(base)
    want, leaves = _reference(pf, Xt, bt)
    got = _replica(pf, leaves, bt)
    tc = tree_step(X.shape[0])
    bound = _bound(pf, leaves, bt, tc)
    assert got.shape == want.shape == (257, G)
    assert bool(((got - want).abs().double() <= bound).all())
    jm = np.array(jax_walk_packed(
        jnp.asarray(pf.words), jnp.asarray(pf.values),
        jnp.asarray(pf.tree_offsets), jnp.asarray(pf.tree_weight),
        jnp.asarray(pf.group_onehot), jnp.asarray(X), jnp.asarray(base),
        jnp.asarray(pf.cat_words) if pf.has_cat else None,
        max_depth=pf.max_depth, tree_chunk=tc))
    assert bool(((got.double() - torch.from_numpy(jm).double()).abs()
                 <= bound).all())


@pytest.mark.parametrize("kind", ["higgs", "three", "cat"])
def test_fold_replica_does_not_depend_on_the_batch(kind):
    """A row's margin has the same bits alone and inside 1,000 rows."""
    pf = _forest(kind)
    X = torch.from_numpy(_rows(kind, 1000, seed=9))
    base = torch.linspace(-0.5, 0.5, pf.n_groups)
    _, leaves = _reference(pf, X, base)
    whole = _replica(pf, leaves, base)
    for row in (0, 17, 999):
        _, one = _reference(pf, X[row:row + 1], base)
        assert torch.equal(one, leaves[row:row + 1])
        assert torch.equal(_replica(pf, one, base)[0], whole[row])


@pytest.mark.parametrize("kind", ["higgs", "tp8", "three"])
def test_fold_replica_replays_the_stated_order(kind):
    """The replica against a scalar float32 replay of the order
    ``csrc/walk.cu`` states: one group, partial l folds slots l, l + 32,
    ... from 0, then a[l] += a[l + o] for o = 16 .. 1, then base; several
    groups, a left fold per group in slot order, then base."""
    pf = _forest(kind)
    X = torch.from_numpy(_rows(kind, 12, seed=10))
    base = torch.linspace(-0.5, 0.5, pf.n_groups)
    _, leaves = _reference(pf, X, base)
    got = _replica(pf, leaves, base).numpy()
    f32 = np.float32
    terms = (pf.values[leaves.numpy()] * pf.tree_weight[None, :]).astype(f32)
    for r in range(X.shape[0]):
        if pf.n_groups == 1:
            a = [f32(0)] * 32
            for t in range(terms.shape[1]):
                a[t % 32] = f32(a[t % 32] + terms[r, t])
            for o in (16, 8, 4, 2, 1):
                for lane in range(o):
                    a[lane] = f32(a[lane] + a[lane + o])
            want = [f32(a[0] + f32(base[0]))]
        else:
            acc = [f32(0)] * pf.n_groups
            for t, g in enumerate(pf.tree_group):
                acc[g] = f32(acc[g] + terms[r, t])
            want = [f32(acc[g] + f32(base[g])) for g in range(pf.n_groups)]
        np.testing.assert_array_equal(got[r], np.asarray(want, f32))


def test_a_schedule_names_the_cuda_kernel():
    """On the CPU the plain walk runs; naming a kernel schedule raises."""
    pf = _forest("one")
    X = torch.from_numpy(_rows("one", 4))
    with pytest.raises(ValueError, match="schedule"):
        pf.margin(X, torch.zeros(1), schedule="staged")
