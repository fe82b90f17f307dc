"""The histogram kernels' launch plan (``ops/cuda/hist.py``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here the plan they are given is checked, and a torch
emulation of their decomposition (node groups and tiles, the sort by node,
items of at most R rows, per-item integer tile sums, the integer combine
of split groups, one conversion) is held against the plain versions bit
for bit: ``build_hist_int8x2_reference`` and ``build_hist_f32_reference``
(K2, K3), ``coarse_fold`` taken from each group's integer tile as K4's
epilogue takes it, and ``fused_advance_coarse_reference`` from K5's
advance, coarse bin map and tiles. Inputs are made with numpy from a
seed, skewed levels included: one node with over half of the rows,
several empty nodes.
"""

import math
from typing import NamedTuple

import numpy as np
import pytest
import torch

from xgboost_tpu_torch.ops import histogram as H
from xgboost_tpu_torch.ops.cuda.hist import (ADVANCE_CHUNK, CELL_BYTES,
                                             FUSED_TILE_BYTES, MIN_ITEM_ROWS,
                                             SORT_MAX_NODES, TILE_BYTES,
                                             fold_fits, fused_plan,
                                             group_items,
                                             hist_partial_words, hist_plan,
                                             hist_work_ints, node_chunks,
                                             tile_geometry)
from xgboost_tpu_torch.ops.partition import (LevelSplits, advance_level,
                                             level_rel)
from xgboost_tpu_torch.ops.split import (COARSE_B, COARSE_SPAN,
                                         coarse_bin_ids)

SMS = 132


def _inputs(n, F, B, N, seed, skew=False):
    rng = np.random.RandomState(seed)
    dtype = torch.uint8 if B <= 256 else torch.uint16
    bins = torch.from_numpy(rng.randint(0, B, (n, F)).astype(np.int32)).to(
        dtype)
    g = rng.randn(n, 2).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1])
    rel = rng.randint(0, N, n).astype(np.int32)
    if skew:
        # node 1 (or 0) holds 60% of the rows; nodes 0, 2 and 5 are empty
        rel[np.isin(rel, (0, 2, 5))] = 3 % N
        rel[rng.rand(n) < 0.6] = 1 % N
    rel[rng.rand(n) < 0.1] = N                     # inactive rows
    return bins, torch.from_numpy(g), torch.from_numpy(rel)


def _items(rel, plan, n, nc):
    """(group, [(node in group, sorted rows)] ) of every item, as the
    kernel walks them, and the group_items tables."""
    if not plan.sorted:
        k = max(1, math.ceil(n / plan.R))
        rows = torch.arange(n)
        out = []
        for i in range(k):
            r = rows[i * plan.R:(i + 1) * plan.R]
            out.append((0, i, k, r))
        return out, None
    perm, offsets = H.counting_sort_by_node(rel, nc)
    off = offsets.tolist()
    starts, pslot, split = group_items(off, nc, plan.G, plan.R)
    assert starts[-1] <= plan.max_items
    assert len(split) <= plan.max_split
    assert sum(starts[g + 1] - starts[g] for g in split) <= plan.max_partials
    out = []
    for g in range(plan.n_groups):
        k0, k1 = g * plan.G, min((g + 1) * plan.G, nc)
        s_g = starts[g + 1] - starts[g]
        assert (pslot[g] >= 0) == (s_g > 1)
        for seg in range(s_g):
            s0 = off[k0] + seg * plan.R
            s1 = min(off[k1], s0 + plan.R)
            out.append((g, seg, s_g, perm[s0:s1]))
    return out, (starts, pslot, split)


class Emulated(NamedTuple):
    out: torch.Tensor       # [N, F, B, 2] f32
    writes: torch.Tensor    # writes of each (node, feature, bin)
    seen: torch.Tensor      # adds of each (row, feature)
    act: torch.Tensor       # the active rows
    coarse: torch.Tensor    # with a fold: [N, F, COARSE_B, 2] f32
    items: list             # items of each group that wrote


def tile_fold(total, B, missing, coarse_b=COARSE_B,
              shift=COARSE_SPAN.bit_length() - 1):
    """``csrc/hist.cu fold_task`` over one group's integer tile
    [G, fc, bs, P]: real slot k < coarse_b - 1 sums bins
    [k << shift, (k + 1) << shift) but the missing one; the last slot
    holds the missing bin."""
    G, fc, _, P = total.shape
    out = torch.zeros((G, fc, coarse_b, P), dtype=torch.int64)
    for b in range(min(B, (coarse_b - 1) << shift)):
        if b != missing:
            out[:, :, b >> shift] += total[:, :, b]
    if missing < B:
        out[:, :, coarse_b - 1] = total[:, :, missing]
    return out


def emulate(bins, vals, rel, N, B, convert, sms=SMS, plan_fn=hist_plan,
            fold=None, load=None):
    """The kernels' decomposition in torch. ``fold``: (missing bin, the
    conversion of the folded integers), K4's fold of each group's summed
    tile (one item's, or a split group's after the combine). ``load``:
    the elements' bin ids of rows and a feature slice (default: read
    from ``bins``)."""
    n, F = bins.shape
    P = vals.shape[1]
    out = torch.full((N, F, B, 2), float("nan"))
    coarse = torch.full((N, F, COARSE_B, 2), float("nan"))
    writes = torch.zeros((N, F, B), dtype=torch.int64)
    seen = torch.zeros((n, F), dtype=torch.int64)
    n_items = []
    tile_bytes = FUSED_TILE_BYTES if plan_fn is fused_plan else TILE_BYTES
    for n0, nc in node_chunks(F, B, N, tile_bytes):
        plan = plan_fn(n, F, B, nc, sms)
        assert plan.tile_cells * CELL_BYTES <= TILE_BYTES
        assert not plan.sorted or nc <= SORT_MAX_NODES
        r = rel - n0
        items, _ = _items(r, plan, n, nc)
        for t in range(plan.n_tiles):
            f0 = (t // plan.n_btiles) * plan.fc
            b0 = (t % plan.n_btiles) * plan.bc
            fs = slice(f0, min(F, f0 + plan.fc))
            partials = {}
            for g, seg, s_g, rows in items:
                nodes = r[rows].long() - g * plan.G
                keep = (nodes >= 0) & (nodes < plan.G) & (r[rows] >= 0) & \
                    (r[rows] < nc)
                rows, nodes = rows[keep], nodes[keep]
                b = (bins[rows][:, fs].long() if load is None
                     else load(rows, fs)) - b0
                inb = (b >= 0) & (b < plan.bc)
                seen[rows[:, None].expand_as(b)[inb],
                     torch.arange(fs.start, fs.stop).expand_as(b)[inb]] += 1
                cell = ((nodes[:, None] * plan.fc
                         + torch.arange(b.shape[1])[None, :]) * plan.bs + b)
                tile = torch.zeros((plan.tile_cells, P), dtype=torch.int64)
                tile.index_add_(0, cell[inb],
                                vals[rows][:, None, :].expand(-1, b.shape[1],
                                                              P)[inb])
                partials.setdefault(g, []).append(tile)
            for g, tiles in partials.items():
                total = torch.stack(tiles).sum(0).view(plan.G, plan.fc,
                                                       plan.bs, P)
                k0 = g * plan.G
                k1 = min(k0 + plan.G, nc)
                fb = slice(b0, min(B, b0 + plan.bc))
                blk = total[:k1 - k0, :fs.stop - fs.start, :fb.stop - fb.start]
                out[n0 + k0:n0 + k1, fs, fb] = convert(blk)
                writes[n0 + k0:n0 + k1, fs, fb] += 1
                n_items.append(len(tiles))
                if fold is not None:
                    assert plan.n_btiles == 1
                    folded = tile_fold(total, B, fold[0])
                    coarse[n0 + k0:n0 + k1, fs] = fold[1](
                        folded[:k1 - k0, :fs.stop - fs.start])
    act = (rel >= 0) & (rel < N)
    return Emulated(out, writes, seen, act, coarse, n_items)


CASES = [  # (n, F, B, N, skew)
    (5000, 28, 256, 1, False),        # the root: one group, row order
    (5000, 28, 256, 16, True),        # one node per group, a split node
    (20000, 28, 256, 128, True),
    (3000, 28, 257, 64, False),       # u16 with the missing slot
    (20000, 28, 36, 128, True),       # refine ids: 6 nodes a group
    (20000, 28, 20, 4, False),        # coarse ids: one group
    (20000, 28, 20, 128, True),
    (10, 28, 256, 512, False),        # a level of 10 rows
    (4000, 28, 256, 512, True),
    (6000, 5, 16, 5000, False),       # chunks of 4096 nodes
    (3000, 6, 1000, 4, True),         # feature tiles
    (2000, 3, 8000, 3, False),        # bin tiles
    (0, 28, 256, 4, False),           # no rows
]


@pytest.mark.parametrize("n,F,B,N,skew", CASES)
def test_plan_covers_every_row_and_cell_once(n, F, B, N, skew):
    """Every active (row, feature) is added in exactly one item of its
    tile, no inactive one is, and every (node, feature, bin) of the
    output is written exactly once: empty nodes, split groups and every
    node chunk included."""
    bins, g, rel = _inputs(n, F, B, N, seed=n + F + B + N, skew=skew)
    vals = torch.ones((n, 1), dtype=torch.int64)
    em = emulate(bins, vals, rel, N, B,
                 lambda t: t.float().expand(*t.shape[:-1], 2))
    assert bool((em.writes == 1).all())
    assert bool((em.seen[em.act] == 1).all())
    assert bool((em.seen[~em.act] == 0).all())


@pytest.mark.parametrize("n,F,B,N,skew", CASES)
def test_emulated_k2_equals_plain_bit_for_bit(n, F, B, N, skew):
    """K2's decomposition (int32 planes summed per item, split groups
    combined in integers, one dequantisation) equals the plain version."""
    bins, g, rel = _inputs(n, F, B, N, seed=3 * n + B + N, skew=skew)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, N, B)
    got = emulate(bins, H.int8x2_planes(q).long(), rel, N, B,
                  lambda t: H.dequant_int8x2(t.to(torch.int32), inv)).out
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,F,B,N,skew", CASES)
def test_emulated_k3_equals_plain_bit_for_bit(n, F, B, N, skew):
    """K3's decomposition (int64 fixed point summed per item, split groups
    combined in integers, one conversion) equals the plain version."""
    bins, g, rel = _inputs(n, F, B, N, seed=5 * n + B + N, skew=skew)
    qs, inv = H.fixed_point_scale(g)
    want = H.build_hist_f32_reference(bins, g, rel, qs, inv, N, B)
    q = torch.round(g * qs[None, :]).to(torch.int64)
    got = emulate(bins, q, rel, N, B,
                  lambda t: t.to(torch.float32) * inv).out
    assert torch.equal(got, want)


def u4_load(packed, F):
    """The kernels' element load from a u4-packed page (``csrc/hist.cu
    load_bin`` for ``U4``): feature f of a row is byte f >> 1 of the row
    (rows ceil(F/2) bytes apart), shifted right by 4 * (f & 1), its low
    nibble."""
    W = (F + 1) // 2
    flat = packed.reshape(-1).long()

    def load(rows, fs):
        f = torch.arange(fs.start, fs.stop)
        byte = flat[rows[:, None] * W + (f >> 1)[None, :]]
        return (byte >> (4 * (f & 1))[None, :]) & 0xF

    return load


U4_CASES = [  # (n, F, N, skew): 16 slots, odd and even F
    (5000, 28, 1, False), (5000, 27, 16, True), (20000, 28, 128, True),
    (20000, 27, 128, False), (4000, 27, 512, True), (6000, 5, 5000, False),
]


@pytest.mark.parametrize("n,F,N,skew", U4_CASES)
def test_emulated_u4_bodies_equal_plain_bit_for_bit(n, F, N, skew):
    """K2's and K3's ``packed_u4`` bodies: the same decomposition over the
    logical F, each element's id read as its nibble of the packed page,
    equal to the plain versions (unpack, then the plain build)."""
    from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

    B = 16
    bins, g, rel = _inputs(n, F, B, N, seed=7 * n + F + N, skew=skew)
    packed = torch.from_numpy(PagedBinnedMatrix._pack_host(bins.numpy()))
    load = u4_load(packed, F)
    if N <= 128:
        q, inv = H.quantise_int8x2(g)
        want = H.build_hist_int8x2_u4_reference(packed, F, q, rel, inv, N, B)
        got = emulate(bins, H.int8x2_planes(q).long(), rel, N, B,
                      lambda t: H.dequant_int8x2(t.to(torch.int32), inv),
                      load=load).out
        assert torch.equal(got, want)
    qs, inv3 = H.fixed_point_scale(g)
    want = H.build_hist_f32_u4_reference(packed, F, g, rel, qs, inv3, N, B)
    q3 = torch.round(g * qs[None, :]).to(torch.int64)
    got = emulate(bins, q3, rel, N, B, lambda t: t.to(torch.float32) * inv3,
                  load=load).out
    assert torch.equal(got, want)


def test_skewed_level_splits_its_big_node():
    """At 1M rows and 128 nodes with one node holding over half of the
    rows, that node's group is split and the others are not; the bounds
    the wrapper allocates by hold."""
    n, N = 1_000_000, 128
    plan = hist_plan(n, 28, 256, N, SMS)
    assert plan.sorted and plan.G == 1 and plan.n_groups == N
    counts = [0] * N
    counts[1] = 550_000
    for k in range(3, N):
        counts[k] = 350_000 // (N - 3)
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    starts, pslot, split = group_items(offsets, N, plan.G, plan.R)
    assert split == [1] and starts[2] - starts[1] == \
        math.ceil(550_000 / plan.R)
    assert pslot[0] == -1 and pslot[2] == -1 and pslot[1] == 0
    assert starts[-1] <= plan.max_items and len(split) <= plan.max_split
    assert starts[2] - starts[1] <= plan.max_partials


@pytest.mark.parametrize("F,B,N", [(28, 256, 1), (28, 256, 512), (28, 36, 128),
                                   (28, 20, 128), (28, 257, 64),
                                   (6, 1000, 4), (3, 8000, 3)])
def test_tile_geometry(F, B, N):
    """Groups fill the tile; feature and bin tiles cover F and B with
    balanced tiles; one node at 28 x 256 (K4's footprint, the odd stride
    257 included), six at the refine ids' 36 slots (stride 37)."""
    G, fc, bc, bs, nft, nbt = tile_geometry(F, B, N)
    assert G * fc * bs * CELL_BYTES <= TILE_BYTES
    assert bs % 2 == 1 and bc <= bs <= bc + 1
    assert nft * fc >= F > (nft - 1) * fc and nbt * bc >= B > (nbt - 1) * bc
    if nft == nbt == 1:
        assert G == min(N, TILE_BYTES // (F * bs * CELL_BYTES))
    if (F, B) == (28, 256):
        assert G == 1
    if (F, B, N) == (28, 36, 128):
        assert G == 6


def test_plan_sizes_and_chunks():
    """Items of at least MIN_ITEM_ROWS rows, about two a SM; the scratch
    sizes; node chunks of whole groups below the sort's limit."""
    plan = hist_plan(1_000_000, 28, 256, 1, SMS)
    assert not plan.sorted and plan.max_items == math.ceil(
        1_000_000 / plan.R) and plan.max_items <= 2 * SMS
    assert hist_work_ints(1_000_000, 1, plan) == 1
    assert plan.tile_cells == 28 * 257
    assert hist_partial_words(plan) == plan.max_items * 28 * 257 * 4
    small = hist_plan(50_000, 28, 256, 128, SMS)
    assert small.R == MIN_ITEM_ROWS and small.sorted
    assert hist_work_ints(50_000, 128, small) == \
        3 * 128 + 1 + 50_000 + 3 * 128 + 2
    chunks = node_chunks(28, 16, 10_000)
    G = tile_geometry(28, 16, 10_000)[0]
    assert chunks[0] == (0, (SORT_MAX_NODES // G) * G)
    assert sum(c for _, c in chunks) == 10_000
    assert all(n0 % G == 0 for n0, _ in chunks)
    assert node_chunks(28, 256, 4096) == [(0, 4096)]


# ---- K4: K2's plan, and the fold in the epilogue ---------------------------

def _missing_inputs(n, F, B, N, seed, skew):
    """``_inputs`` with the missing-slot layout at 257 slots (u16, 5% of
    the ids on slot 256) -> (bins, g, rel, missing bin)."""
    bins, g, rel = _inputs(n, F, B, N, seed, skew)
    if B != 257:
        return bins, g, rel, B
    rng = np.random.RandomState(seed + 1)
    b = bins.to(torch.int32).numpy() % 256
    b[rng.rand(n, F) < 0.05] = 256
    return torch.from_numpy(b).to(torch.uint16), g, rel, 256


@pytest.mark.parametrize("B", [256, 257])
@pytest.mark.parametrize("N", [1, 2, 16, 128])
def test_k4_plan_is_one_node_a_tile(B, N):
    """K4 at 28 features over 256 (u8, dense) or 257 slots (u16 with the
    missing slot) fills one tile with one node at the odd stride 257:
    K2's plan, with one bin tile so that the fold sees a feature's whole
    range; at the root no sort, above it rows sorted by node."""
    plan = hist_plan(1_000_000, 28, B, N, SMS)
    assert (plan.G, plan.fc, plan.bs, plan.n_btiles) == (1, 28, 257, 1)
    assert plan.tile_cells * CELL_BYTES <= TILE_BYTES
    assert plan.sorted == (N > 1) and plan.n_groups == N
    assert fold_fits(B, B - 1 if B == 257 else B)


def test_fold_fits_only_the_two_level_layouts():
    """The fold takes at most 256 real bins with the missing slot last;
    other layouts are refused before a launch."""
    assert fold_fits(256, 256) and fold_fits(256, 255) and fold_fits(17, 16)
    assert fold_fits(257, 256)
    assert not fold_fits(257, 257) and not fold_fits(257, 100)
    assert not fold_fits(300, 299)


FOLD_CASES = [  # (n, F, B, N, skew)
    (500, 28, 256, 1, False),         # the root, one item: fold in the tile
    (20000, 28, 256, 1, False),       # the root over many items: combined
    (20000, 28, 257, 16, True),       # split and one-item nodes, missing
    (20000, 28, 256, 128, True),
    (3000, 28, 257, 64, False),
    (20000, 5, 100, 8, True),         # missing slot 99 inside coarse slot 6
    (0, 28, 257, 4, False),           # no rows
]


@pytest.mark.parametrize("n,F,B,N,skew", FOLD_CASES)
def test_emulated_k4_fold_equals_coarse_fold_bit_for_bit(n, F, B, N, skew):
    """K4's fold, taken from each group's integer tile (the item's own for
    a node of one item, the combined partials for a split node) and
    dequantised once, equals ``coarse_fold`` of the plain accumulators
    bit for bit, and the fine histogram beside it the plain one."""
    bins, g, rel, missing = _missing_inputs(n, F, B, N, seed=7 * n + B + N,
                                            skew=skew)
    if B == 100:
        missing = 99
    q, inv = H.quantise_int8x2(g)
    acc = H.scan_acc_reference(bins, q, rel, N, B)
    want = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    em = emulate(bins, H.int8x2_planes(q).long(), rel, N, B,
                 lambda t: H.dequant_int8x2(t.to(torch.int32), inv),
                 fold=(missing, lambda t: H.dequant_int8x2(
                     t.to(torch.int32), inv)))
    assert torch.equal(em.coarse, want)
    assert torch.equal(em.out, H.dequant_int8x2(acc, inv))
    if (n, N) in ((20000, 16), (20000, 128)):
        assert 1 in em.items and max(em.items) > 1   # both kinds of node
    if (n, N) == (20000, 1):
        assert em.items == [math.ceil(20000 / MIN_ITEM_ROWS)]


# ---- K5: the advance, the coarse map and the plan at 20 slots -------------

def coarse_map(b, missing, shift=COARSE_SPAN.bit_length() - 1):
    """``csrc/hist.cu CoarseBin``: the slot a loaded bin id adds into."""
    return torch.where(b == missing, COARSE_B - 1, b >> shift)


def advance_step(bins, pos, prev, missing):
    """``csrc/hist.cu Advance::step`` over every row: a row at a node of
    the previous level that split reads its bin at the node's feature (the
    feature is read only there)."""
    n_prev = prev.feat.shape[0]
    j = pos - prev.lo
    inside = (j >= 0) & (j < n_prev)
    jc = torch.where(inside, j, torch.zeros_like(j))
    feat, thr, dleft, cs = (a.long()[jc] for a in (
        prev.feat, prev.thr, prev.dleft, prev.can_split))
    moves = inside & (cs != 0)
    feat = torch.where(moves, feat, torch.zeros_like(feat))
    b = bins.long()[torch.arange(pos.shape[0]), feat]
    right = torch.where(b == missing, dleft == 0, b > thr)
    return torch.where(moves, 2 * pos + 1 + right.long(), pos)


def _boundary(n, F, B, N, seed, skew):
    """Bins, gradients, positions at the previous level of N / 2 nodes
    (10% strays above it) and its splits (20% not splitting), as
    ``chip_smoke.py level_inputs``; ``skew``: every node splits, 55% of
    the rows at node 1, nodes 0 and 2 empty."""
    bins, g, _, missing = _missing_inputs(n, F, B, 1, seed, False)
    rng = np.random.RandomState(seed + 2)
    n_prev = N // 2
    lo_prev = n_prev - 1
    pos = rng.randint(lo_prev, lo_prev + n_prev, n)
    pos[rng.rand(n) < 0.1] = rng.randint(0, max(lo_prev, 1))
    cs = rng.rand(n_prev) < 0.8
    if skew:
        big = lo_prev + 1 % n_prev
        pos[(pos == lo_prev) | (pos == lo_prev + 2)] = big
        pos[rng.rand(n) < 0.55] = big
        cs[:] = True
    prev = LevelSplits(
        lo_prev, torch.from_numpy(np.where(cs, rng.randint(0, F, n_prev), -1)),
        torch.from_numpy(np.where(cs, rng.randint(0, min(B, 256) - 1,
                                                  n_prev), 0)),
        torch.from_numpy(cs & (rng.rand(n_prev) < 0.5)), torch.from_numpy(cs))
    return bins, g, torch.from_numpy(pos), prev, missing


def test_coarse_map_equals_coarse_bin_ids():
    """K5's bin map on load equals ``coarse_bin_ids`` for every id of the
    two-level layouts, with the missing slot and without one."""
    b = torch.arange(258, dtype=torch.int32)[None, :]
    for missing in (256, 255, 257):
        assert torch.equal(coarse_map(b, missing).to(torch.uint8),
                           coarse_bin_ids(b, missing))


K5_CASES = [  # (n, F, B, N, skew)
    (5000, 28, 256, 2, False),        # one group: advanced in the tiles
    (5000, 28, 257, 8, True),
    (20000, 28, 256, 16, False),      # one group, two feature tiles
    (20000, 28, 257, 16, True),
    (20000, 28, 256, 32, False),      # sorted: advanced in the count
    (20000, 28, 256, 128, True),
    (3000, 28, 257, 64, False),
    (10, 28, 256, 128, False),
    (0, 28, 256, 4, False),
]


@pytest.mark.parametrize("n,F,B,N,skew", K5_CASES)
def test_emulated_k5_advance_and_count_equal_plain(n, F, B, N, skew):
    """K5's advance from the split arrays equals ``advance_level``; its nodes
    and counts (the sort's input) equal ``level_rel`` and
    ``counting_sort_by_node``'s runs, bit for bit."""
    bins, g, pos, prev, missing = _boundary(n, F, B, N, seed=n + N + B,
                                            skew=skew)
    lo = 2 * prev.lo + 1
    got = advance_step(bins, pos, prev, missing)
    want = advance_level(bins, pos, prev, missing)
    assert torch.equal(got, want)
    node = torch.where((got >= lo) & (got < lo + N), got - lo,
                       torch.full_like(got, N))
    rel = level_rel(want, lo, N)
    assert torch.equal(node.to(torch.int32), rel)
    _, offsets = H.counting_sort_by_node(rel, N)
    counts = torch.bincount(node, minlength=N + 1)[:N]
    assert torch.equal(counts, offsets.diff())


@pytest.mark.parametrize("n,F,B,N,skew", K5_CASES)
def test_emulated_k5_equals_plain_bit_for_bit(n, F, B, N, skew):
    """K5's decomposition: the advanced rows' nodes, their bins through
    the coarse map, K2's tiles at 20 slots in the fused plan (one group up
    to 12 nodes at 28 features); every active (row, feature) added once,
    every output cell written once, and the result equal to
    ``fused_advance_coarse_reference`` bit for bit."""
    bins, g, pos, prev, missing = _boundary(n, F, B, N, seed=3 * n + N + B,
                                            skew=skew)
    lo = 2 * prev.lo + 1
    q, inv = H.quantise_int8x2(g)
    new_pos = advance_step(bins, pos, prev, missing)
    rel = level_rel(new_pos, lo, N)
    plan = fused_plan(n, F, COARSE_B, N, SMS)
    assert plan.sorted == (N > 24)
    assert plan.G == (N if N <= 24 else 12)
    assert plan.n_ftiles == (2 if 12 < N <= 24 else 1)
    em = emulate(coarse_map(bins.to(torch.int32), missing), H.int8x2_planes(
        q).long(), rel, N, COARSE_B, lambda t: H.dequant_int8x2(
            t.to(torch.int32), inv), plan_fn=fused_plan)
    want_pos, want = H.fused_advance_coarse_reference(bins, q, inv, pos, prev,
                                                      lo, N, missing)
    assert torch.equal(new_pos, want_pos)
    assert torch.equal(em.out, want)
    assert bool((em.writes == 1).all())
    assert bool((em.seen[em.act] == 1).all())
    assert bool((em.seen[~em.act] == 0).all())


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 5000, 1_000_000])
def test_k5_one_group_route_advances_each_row_once(n):
    """At a level of one group the items cover the rows once, and each
    item's chunks of ``ADVANCE_CHUNK`` rows (the node ids kept beside the
    tile) cover its rows once; the tile and the chunk fit the tile budget
    at 20 slots for up to 12 nodes."""
    plan = fused_plan(n, 28, COARSE_B, 8, SMS)
    assert not plan.sorted and plan.n_tiles == 1
    assert plan.tile_cells * CELL_BYTES + ADVANCE_CHUNK <= TILE_BYTES
    hits = np.zeros(n, np.int64)
    for item in range(plan.max_items):
        a, e = item * plan.R, min((item + 1) * plan.R, n)
        for c0 in range(a, e, ADVANCE_CHUNK):
            hits[c0:min(c0 + ADVANCE_CHUNK, e)] += 1
    assert bool((hits == 1).all())
    two = fused_plan(n, 28, COARSE_B, 16, SMS)   # two feature tiles
    assert (two.sorted, two.G, two.fc, two.n_ftiles) == (0, 16, 14, 2)
    assert two.tile_cells * CELL_BYTES + ADVANCE_CHUNK <= TILE_BYTES
    assert fused_plan(n, 28, COARSE_B, 24, SMS).n_ftiles == 2
    assert fused_plan(n, 28, COARSE_B, 25, SMS).sorted == 1


def test_k5_work_holds_the_advanced_nodes():
    """The sorted route's scratch adds the advanced rows' nodes [n] after
    the sort's tables."""
    plan = fused_plan(1_000_000, 28, COARSE_B, 128, SMS)
    assert plan.sorted and plan.G == 12 and plan.n_groups == 11
    assert hist_work_ints(1_000_000, 128, plan, fused=True) == \
        hist_work_ints(1_000_000, 128, plan) + 1_000_000


@pytest.mark.parametrize("F,B,N,fused", [(28, 256, 1, False),
                                         (28, 256, 128, False),
                                         (28, 20, 8, True), (28, 20, 16, True),
                                         (28, 20, 128, True),
                                         (5, 16, 5000, False)])
def test_launches_carry_the_plans(F, B, N, fused):
    """The host arrays the wrappers pass to the kernels are the plans the
    tests check: ``fused_plan`` for K5, ``hist_plan`` otherwise, one per
    node chunk, with scratch for their work and partial tiles."""
    from xgboost_tpu_torch.ops.cuda.hist import _launches

    n = 100_000
    for n0, nc, host, work, total in _launches(n, F, B, N, SMS, fused):
        plan = (fused_plan if fused else hist_plan)(n, F, B, nc, SMS)
        assert list(host) == list(plan[:11])
        assert work >= hist_work_ints(n, nc, plan, fused) and work % 4 == 0
        assert total - work == hist_partial_words(plan)
