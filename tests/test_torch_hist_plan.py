"""K2 and K3's launch plan (``ops/cuda/hist.py``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here the plan they are given is checked, and a torch
emulation of their decomposition (node groups and tiles, the sort by node,
items of at most R rows, per-item integer tile sums, the integer combine
of split groups, one conversion) is held against the plain versions
``build_hist_int8x2_reference`` and ``build_hist_f32_reference`` bit for
bit. Inputs are made with numpy from a seed, skewed levels included: one
node with over half of the rows, several empty nodes.
"""

import math

import numpy as np
import pytest
import torch

from xgboost_tpu_torch.ops import histogram as H
from xgboost_tpu_torch.ops.cuda.hist import (CELL_BYTES, MIN_ITEM_ROWS,
                                             SORT_MAX_NODES, TILE_BYTES,
                                             group_items, hist_partial_words,
                                             hist_plan, hist_work_ints,
                                             node_chunks, tile_geometry)

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


def emulate(bins, vals, rel, N, B, convert, sms=SMS):
    """The kernels' decomposition in torch: [N, F, B, 2] f32 and the
    number of times each (node, feature, bin) was written."""
    n, F = bins.shape
    P = vals.shape[1]
    out = torch.full((N, F, B, 2), float("nan"))
    writes = torch.zeros((N, F, B), dtype=torch.int64)
    seen = torch.zeros((n, F), dtype=torch.int64)
    for n0, nc in node_chunks(F, B, N):
        plan = hist_plan(n, F, B, nc, sms)
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
                b = bins[rows][:, fs].long() - b0
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
    act = (rel >= 0) & (rel < N)
    return out, writes, seen, act


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
    _, writes, seen, act = emulate(bins, vals, rel, N, B,
                                   lambda t: t.float().expand(
                                       *t.shape[:-1], 2))
    assert bool((writes == 1).all())
    assert bool((seen[act] == 1).all())
    assert bool((seen[~act] == 0).all())


@pytest.mark.parametrize("n,F,B,N,skew", CASES)
def test_emulated_k2_equals_plain_bit_for_bit(n, F, B, N, skew):
    """K2's decomposition (int32 planes summed per item, split groups
    combined in integers, one dequantisation) equals the plain version."""
    bins, g, rel = _inputs(n, F, B, N, seed=3 * n + B + N, skew=skew)
    q, inv = H.quantise_int8x2(g)
    want = H.build_hist_int8x2_reference(bins, q, rel, inv, N, B)
    got, _, _, _ = emulate(bins, H.int8x2_planes(q).long(), rel, N, B,
                           lambda t: H.dequant_int8x2(t.to(torch.int32),
                                                      inv))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,F,B,N,skew", CASES)
def test_emulated_k3_equals_plain_bit_for_bit(n, F, B, N, skew):
    """K3's decomposition (int64 fixed point summed per item, split groups
    combined in integers, one conversion) equals the plain version."""
    bins, g, rel = _inputs(n, F, B, N, seed=5 * n + B + N, skew=skew)
    qs, inv = H.fixed_point_scale(g)
    want = H.build_hist_f32_reference(bins, g, rel, qs, inv, N, B)
    q = torch.round(g * qs[None, :]).to(torch.int64)
    got, _, _, _ = emulate(bins, q, rel, N, B,
                           lambda t: t.to(torch.float32) * inv)
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
