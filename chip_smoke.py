#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xgboost_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --levels-of DIR

Builds the CUDA kernels from ``xgboost_tpu_torch/csrc/`` with nvcc (one
nvcc per source, all at once) and holds each kernel against its plain
PyTorch version on the card. K1 (the forest walk): leaf indices equal to
the plain walk's, margins within its reassociation bound and equal bit
for bit to the kernel-order fold of its leaves
(``walk_fold_kernel_order``), on the HIGGS-shape forest at every server
bucket (1, 2, ..., 512 rows), 100,000 and 1,000,000 rows, on both
schedules at 512 and 100,000 rows (one row's margin the same bits in all
of them), a 3-group and a categorical forest on both schedules, the
one-tree eval walk at 100,000 rows, a forest of 1,100 features, a
depth-15 forest that the plan sends to the spread schedule, and the
trained 7-group Covertype forest on both schedules. K2 (int8x2
histogram), K3 (f32 histogram, exact int64 fixed point; and its bf16 and
bf16x2 precisions, each row rounded to bfloat16 first), K2's and K3's
``packed_u4`` bodies over u4-packed pages (against their plain versions
and the same kernels on the unpacked ids, at a 1M-row page), K4 (K2's
function over the sorted build, with its coarse fold taken in the
kernel) and K5 (the level advance fused with the next level's coarse
histogram) bit for bit and twice each, at the shapes the training runs
below give them: K2, K3 and K4 over 256/257 bin slots,
also at skewed levels (one node with 55% of the rows, three empty), and
over the two-level schedules' 20-slot coarse ids and 36-slot refine ids
(a window of 32 fine bins chosen per node and feature, the rest on slot
35); K4's fold and K5 at one-group and sorted levels, skewed ones
included. Then it drives the port's main paths, each with the launch
counts set to 0 just before and read just after:

- serving at the HIGGS shape (500 trees of depth 8 over 28 features,
  ``binary:logistic``, made from a seed): ``Booster.predict`` on 100,000
  rows (K1's staged schedule) and a ``Server`` answering 200 requests of
  1/8/64/512 rows from 4 threads (the spread schedule), every answer
  equal to ``Booster.predict`` bit for bit;
- training at the HIGGS shape: ``xgboost_tpu_torch.train`` on 1,000,000 x
  28 N(0, 1) features with labels from a fixed linear rule plus noise
  (seed 0), ``max_depth`` 8, 20 rounds, evaluated on the training rows
  and 100,000 held-out rows. Every level's histogram goes through K4, as
  the TPU's ``auto`` takes its sorted kernel at this size; logloss must
  fall, held-out AUC pass 0.6, and a ``save_raw`` round trip predict the
  same bits;
- training at ``max_depth`` 10 on 200,000 rows for 3 rounds, so that the
  levels of 256 and 512 nodes run K3 through ``hist_method="auto"``, and
  K3's share of the device time of such rounds;
- training at ``max_depth`` 8 on 50,000 rows for 5 rounds, below the
  sorted kernel's 65,536 rows, so that every level runs K2;
- the two-level schedules on the HIGGS-shape training: ``hist_method``
  ``coarse``, ``fused`` and ``scan``, 10 rounds each, whose models must be
  the same bytes (K2 twice a level; K5 at every level boundary and K2 for
  the coarse root and the refines; K4 with its fold at every level);
- ``fused`` and ``scan`` at ``max_depth`` 10 on 200,000 rows for 2 rounds,
  where the levels of 256 and 512 nodes take the plain advance and K3;
- multiclass at the Covertype shape (``covtype_like``: 581,012 x 54 with
  covtype's 7 class counts, 100,000 held-out rows, made from a seed):
  ``multi:softprob``, depth 8, ``subsample`` / ``colsample_bytree`` /
  ``colsample_bynode`` 0.8, up to 30 rounds with early stopping after 5
  on the held-out mlogloss, twice: K4 at every level of every class tree
  (56 launches a round), K1 staged for the held-out walk (once a round),
  the two runs' model bytes the same sha256, every round's sampled masks
  and row draws drawn on the card equal to the same draws on the CPU,
  held-out mlogloss and merror falling; then seconds a round and three
  profiled rounds, ``Booster.predict`` on the held-out rows, a 7-group
  ``Server`` answering 1/8/64/512-row requests (each answer equal to
  ``Booster.predict``), one ``num_parallel_tree`` 4 round, a
  ``gradient_based`` run with ``subsample`` 0.5, and one round each
  through ``hist_method`` ``pallas:bf16x2`` and ``pallas:bf16`` (K3's
  rounded precisions at every level);
- BASELINE config #4 in full (``covertype_categorical_dart``): the same
  Covertype draws with the wilderness area (4 categories) and the soil
  type (40) as category codes beside the 10 continuous columns (581,012
  x 12, ``enable_categorical``), ``booster="dart"`` (``rate_drop`` 0.1,
  ``skip_drop`` 0.5, uniform, tree), up to 30 rounds with early stopping
  twice: K2 at every level of every class tree (56 launches a round), K4
  never, K1 for the held-out walk once a round, the two runs' model
  bytes the same sha256, both split kinds in the forest (one-hot on the
  area, sorted partition on the soil), the drops and ``weight_drop``
  range a round, held-out mlogloss falling beside the one-hot gbtree
  run's, a save/load round trip and a ``Server`` predicting the same
  bits, K1 on the trained weighted forest on both schedules, seconds a
  round and three profiled rounds, K2 over the codes against its plain
  version (and timed), and one round at depth 10 on 200,000 rows (K3 at
  256 and 512 nodes over the codes, against its plain version);
- external memory at the HIGGS-11M shape (``external_memory``): a
  ``QuantileDMatrix`` from a ``DataIter`` of 11 batches of 1,000,000 x
  28 rows (``higgs_batch``, made from a seed batch by batch) with a
  ``cache_prefix``, its bins a memmap streamed in 11 pages of 1,000,000
  rows with 4 in the page cache (``XTPU_PAGE_CACHE_BYTES``,
  ``XTPU_PAGED_COLLAPSE=0``): 10 rounds at depth 8 with 100,000 held-out
  rows (K4 on every page and level, 88 launches a round; held-out
  logloss falling every round), seconds, ring uploads, H2D bytes and
  overlap a round, three profiled rounds, the same model bytes under
  budgets of 0, 4 and 11 pages and in two runs; the u4 run (``max_bin``
  16, pages packed two ids a byte: K2-u4 on every page and level) equal
  in bytes to the same with ``XTPU_PAGE_PACK=0``, 2 rounds at depth 10
  on the first 2,000,000 rows (K3-u4 at 256 and 512 nodes) and a round
  each through ``pallas:bf16x2`` / ``pallas:bf16`` on packed pages;
  ``Booster.predict`` on the paged matrix against the walk over its
  bins; and the default budget, which collapses the matrix to the
  resident tier;
- BASELINE config #3 in full (``mslr_ranking``): ``rank:ndcg``
  LambdaMART at the MSLR-WEB30K Fold1 shape (``mslr_like``: 136 N(0, 1)
  features, 18,919 training queries of log-normal sizes with MSLR's
  mean, the longest 1,251 documents, 6,306 held-out queries; labels
  0-4 from a hidden score's rank within the query, made from a seed):
  ``lambdarank_pair_method`` ``mean`` with one rival a document,
  exponential gains, depth 6, ``eta`` 0.3, ``max_bin`` 256, held-out
  ``ndcg@10`` and ``map@10``, 30 rounds twice: K4 at every level (6
  launches a round), K1 once a round, one sha256 in both runs,
  held-out ``ndcg@10`` rising, ``Booster.predict`` agreeing with the
  eval line; seconds a round, three profiled rounds, the LambdaRank
  gradient's own device time and its padded layout's pad share; K2,
  K3 and K4 over the training bins at 136 features against their plain
  versions (1 to 32 nodes, uniform and skewed) and timed at 1 and 32
  nodes; K1 on the ranking forest against its fold replica; and at
  bench.py's 200,000 x 136 in 800 queries of 250, two rounds each of
  ``topk`` (0 and 8 anchors), unbiased ``mean`` and ``topk`` (ti+ /
  tj- printed), ``rank:pairwise`` and ``rank:map`` on binary labels,
  and a save/load round trip of the unbiased model;
- BASELINE config #1 as XGBoost's agaricus demos run it
  (``agaricus_walkthrough``): ``agaricus_like`` writes
  ``agaricus.txt.train`` / ``.test`` (6,513 and 1,611 rows of 22 one-hot
  attributes, 127 columns, column 0 never present) as libsvm, read back
  through ``DMatrix(path)`` (timed, and the parse rate on a 200,000-row
  file); K2 over their bins (F = 127, B = 2, N = 1 and 2) against its
  plain version and timed; ``binary:logistic`` with ``error`` and
  ``reg:squarederror`` with ``rmse`` (depth 2, ``eta`` 1, 2 rounds, both
  eval sets) twice each (one sha256; K2 twice and K1 once a round); then
  save/load, ``dump_model``, ``save_binary``, CSR / CSC / numpy input,
  boost from prediction, ``iteration_range``, ``pred_leaf`` (against the
  CPU), the demo's custom objective and metric, ``process_type=update``
  (against the CPU) and the reference-schema writer; seconds a round,
  three profiled rounds, and K1 on the trained forest at the 1,611 test
  rows against its plain version and timed.

It times each kernel, its plain version, one PyTorch library call for
the same function where there is one, and the kernel's bound, at the
main paths' shapes: K2 at the categorical run's levels of 128 nodes and
at the agaricus bins (6,513 x 127, two slots, N = 2); K1 on the agaricus
forest at its 1,611 test rows; K1
at 1, 512, 100,000 and 1,000,000 rows and the
one-tree walk at 100,000, and both of its schedules from 1 to 100,000
rows; K1 on the Covertype forest (7 groups) at 1, 512 and 100,000 rows
and its one-round eval walk; K4 at every level width of the HIGGS run (N = 1, 2,
..., 128 on 1,000,000 rows) and K5 at every level boundary (N = 2, ...,
128), each split into its phases (sort or advance, tiles, combine and
fold) with CUDA events; seconds per boosting round on the host clock;
and the device's idle share of the same rounds under ``torch.profiler``.

``--levels-of DIR`` times only K4's and K5's levels (and K2 beside them)
and K1's main-path shapes with the ``xgboost_tpu_torch`` package found in
DIR, through the calls every version of the port has, so that two trees
compare in one run; it prints them as a JSON line and exits.

Prints the card (``nvidia-smi`` name and power limit) and a JSON line
of kernel numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
U = 2.0 ** -24                 # f32 unit roundoff
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sum_bound(pf, leaves, base, tree_chunk):
    """Per-(row, group) bound on |kernel - plain| from reassociating the
    f32 leaf sum: (adds on the longer path of both) * u * sum |terms|.
    The plain walk folds chunks of ``tree_chunk`` (any order inside a
    chunk); the kernel sums 32 lane partials of Tp/32 trees and reduces
    them in 5 shuffle steps (one group), or folds every tree of a group
    in tree order (several groups)."""
    d = pf.device_arrays(leaves.device)
    Tp = pf.tree_offsets.shape[0]
    terms = (d["values"][leaves.long()] * d["tree_weight"][None, :]).abs()
    mag = terms @ d["group_onehot"] + base.abs()[None, :]
    k_plain = tree_chunk + math.ceil(Tp / tree_chunk) + 1
    k_kernel = (math.ceil(Tp / 32) + 6) if pf.n_groups == 1 else Tp + 1
    return (k_plain + k_kernel) * U * mag


PLAIN_ROWS = 100_000           # rows of one plain-walk call in a check


def check_kernel(name, pf, X, base, schedule=None):
    """K1 (on ``schedule``, else the plan's) against the plain walk on the
    same device tensors: leaf indices equal, margins within the
    reassociation bound, and equal bit for bit to the kernel-order fold of
    the plain walk's leaves (``walk_fold_kernel_order``). The plain walk
    runs on 100,000 rows at a time (its rows are independent). Returns
    (max |kernel - plain|, the kernel's margins, the schedule launched)."""
    from xgboost_tpu_torch.ops.cuda import walk as W
    from xgboost_tpu_torch.ops.walk import (walk_fold_kernel_order,
                                            walk_packed_reference)
    from xgboost_tpu_torch.serve.packed import tree_step

    d = pf.device_arrays(X.device)
    before = dict(W.SCHEDULE_LAUNCHES)
    got, got_leaf = pf.margin(X, base, leaf_index=True, schedule=schedule)
    took = [k for k, v in W.SCHEDULE_LAUNCHES.items() if v != before[k]]
    if len(took) != 1 or (schedule is not None and took != [schedule]):
        raise AssertionError(f"{name}: launched {took}, asked {schedule}")
    err = ratio = 0.0
    for lo in range(0, X.shape[0], PLAIN_ROWS):
        hi = min(lo + PLAIN_ROWS, X.shape[0])
        tc = tree_step(hi - lo)
        want, want_leaf = walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], X[lo:hi], base, d.get("cat_words"),
            max_depth=pf.max_depth, tree_chunk=tc, leaf_index=True)
        replica = walk_fold_kernel_order(
            d["values"][want_leaf.long()], d["tree_weight"],
            d["tree_group"], base)
        torch.cuda.synchronize()
        if not torch.equal(got_leaf[lo:hi], want_leaf):
            bad = int((got_leaf[lo:hi] != want_leaf).sum())
            raise AssertionError(f"{name}: {bad} leaf indices differ")
        if not torch.equal(got[lo:hi], replica):
            bad = int((got[lo:hi] != replica).sum())
            raise AssertionError(f"{name}: {bad} margins differ from the "
                                 "kernel-order fold")
        e = (got[lo:hi] - want).abs()
        bound = sum_bound(pf, want_leaf, base, tc)
        if not bool(torch.isfinite(got[lo:hi]).all()) or \
                bool((e > bound).any()):
            raise AssertionError(
                f"{name}: margin off by {float(e.max())} "
                f"(bound {float(bound.min())}..{float(bound.max())})")
        err = max(err, float(e.max()))
        ratio = max(ratio, float((e / bound).max()))
    log(f"check {name}: rows={X.shape[0]} trees={pf.n_trees} "
        f"groups={pf.n_groups} cat={pf.has_cat} features={X.shape[1]} "
        f"schedule={took[0]}: leaf_index equal, margins equal the "
        f"kernel-order fold bit for bit, max_abs_err={err} "
        f"max_err/bound={ratio}")
    return err, got, took[0]


def event_ms(fn, reps, flush=None):
    """Mean device time of ``fn`` over ``reps`` calls, one CUDA event pair
    around each (the L2 flushed before each call when ``flush`` is
    given), after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def node_depths(pf):
    """Depth of every flat node of the pack (root 0)."""
    depth = np.zeros(pf.words.shape[0], np.int64)
    leaf = (pf.words >> np.uint32(31)) == 1
    delta = (pf.words & np.uint32(0xFFFF)).astype(np.int64)
    for t in range(pf.n_trees):          # BFS order: parents come first
        lo = int(pf.tree_offsets[t])
        for i in range(lo, lo + int(pf.n_nodes[t])):
            if not leaf[i]:
                depth[i + delta[i]] = depth[i + delta[i] + 1] = depth[i] + 1
    return depth


def walk_bound_ms(pf, n, n_features, visits):
    """(ms, "bytes"|"operations"): the least time for the walk of n rows.
    Bytes: the pool once (word + value per node), X once, the output
    once. Operations: one f32 comparison per internal node visited
    (counted from this run's leaf indices), one multiply and one add per
    (row, tree)."""
    nbytes = (pf.words.shape[0] * 8 + n * n_features * 4
              + n * pf.n_groups * 4)
    ops = visits + 2 * n * pf.tree_offsets.shape[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def auc(y: np.ndarray, p: np.ndarray) -> float:
    """Area under the ROC curve (ties share their average rank)."""
    _, inv, counts = np.unique(p, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


# (rows, nodes, bin slots, skewed): the levels the training runs below
# give the kernels, and the missing-slot layout (257 slots, u16). K3 runs
# at every case, K2 and K4 at the cases of at most 128 nodes. Skewed: one
# node holds 55% of the rows and three are empty, as in real trees, so
# that K2 and K3 split a node's run over several blocks.
HIST_CASES = ((1_000_000, 1, 256, False), (1_000_000, 4, 256, False),
              (1_000_000, 16, 256, False), (1_000_000, 128, 256, False),
              (1_000_000, 64, 257, False), (200_000, 256, 256, False),
              (200_000, 512, 256, False), (50_000, 1, 256, False),
              (50_000, 128, 256, False), (1_000_000, 128, 256, True),
              (200_000, 512, 256, True))


# (rows, nodes, id slots): the builds of the two-level schedules that go
# through ``build_hist``: coarse ids (20 slots) and refine ids (36 slots),
# K2 at the HIGGS run's root and deepest level, K3 at the depth-10 runs'
# levels of 256 and 512 nodes
TWO_LEVEL_CASES = ((1_000_000, 1, 20), (1_000_000, 1, 36),
                   (1_000_000, 128, 36), (200_000, 256, 20),
                   (200_000, 256, 36), (200_000, 512, 20),
                   (200_000, 512, 36))


def hist_inputs(n, F, B, N, dev, seed, skew=False):
    """bins [n, F] (uint8, or uint16 with a missing slot at B-1 for
    B = 257), gpair [n, 2] f32 and rel [n] int32 with 10% inactive rows,
    made on the card from ``seed``. ``skew``: node 1 holds 55% of the
    rows and nodes 0, 2 and 5 none."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if B > 256:
        bins = torch.randint(0, B - 1, (n, F), generator=g, device=dev,
                             dtype=torch.int32)
        miss = torch.rand((n, F), generator=g, device=dev) < 0.05
        bins = torch.where(miss, torch.full_like(bins, B - 1), bins)
        bins = bins.to(torch.uint16)
    else:
        bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    gpair = torch.stack([torch.randn(n, generator=g, device=dev),
                         torch.rand(n, generator=g, device=dev)], dim=1)
    rel = torch.randint(0, N, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if skew:
        rel = torch.where((rel == 0) | (rel == 2) | (rel == 5),
                          torch.full_like(rel, 3 % N), rel)
        rel = torch.where(torch.rand(n, generator=g, device=dev) < 0.55,
                          torch.full_like(rel, 1 % N), rel)
    rel = torch.where(torch.rand(n, generator=g, device=dev) < 0.1,
                      torch.full_like(rel, N), rel)
    return bins.contiguous(), gpair.contiguous(), rel.contiguous()


def two_level_inputs(n, F, N, B, dev, seed):
    """``hist_inputs``' u8 bins (256 slots, no missing slot) as the
    two-level schedules hand them to ``build_hist``: their coarse ids for
    B = 20; for B = 36 their refine ids, each row's window that of its
    node and feature, chosen from the level's coarse histogram as
    ``tree/grow.py`` chooses it (rows outside the level take window 0)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.split import (COARSE_B, WINDOW,
                                             choose_refine_window,
                                             coarse_bin_ids, refine_bin_ids)
    from xgboost_tpu_torch.tree.param import TrainParam

    bins, gpair, rel = hist_inputs(n, F, 256, N, dev, seed)
    cb = coarse_bin_ids(bins, 256)
    if B == COARSE_B:
        return cb, gpair, rel
    if B != WINDOW + 4:
        raise ValueError(f"no two-level build has {B} slots")
    q, inv = H.quantise_int8x2(gpair)
    hist_c = H.build_hist_int8x2_reference(cb, q, rel, inv, N, COARSE_B)
    span = choose_refine_window(
        hist_c, hist_c[:, 0].sum(dim=1),
        torch.full((F,), 256, dtype=torch.int64, device=dev), TrainParam(),
        False)
    span_row = torch.cat([span, torch.zeros_like(span[:1])]).to(
        torch.int32)[rel.long()]
    return refine_bin_ids(bins, span_row, 256).contiguous(), gpair, rel


def hist_totals_ok(name, out, gpair, rel, N, quantum):
    """Every feature's bins add up to its node's gradient sums: within
    half a quantum per row (0.51: K2's dequant factor is itself rounded)
    plus one f32 rounding per bin."""
    act = rel < N
    exact = torch.zeros((N, 2), dtype=torch.float64, device=out.device)
    exact.index_add_(0, rel[act].long(), gpair[act].double())
    count = torch.bincount(rel[act].long(), minlength=N).double()
    o = out.double()                                   # [N, F, B, 2]
    tot = o.sum(dim=2)                                  # [N, F, 2]
    ulp = torch.abs(out).double() * 2.0 ** -24
    bound = (count[:, None, None] * 0.51 * quantum.double()[None, None, :]
             + ulp.sum(dim=2) + exact.abs()[:, None, :] * 2.0 ** -22)
    err = (tot - exact[:, None, :]).abs()
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: totals off by {float(err.max())}")
    # an empty node's bound is 0 and so is its error
    return float(torch.where(bound > 0, err / bound, err).max())


def k3_precisions():
    """K3's kernels -> their precisions (``ops/cuda/hist.py K3_KERNELS``)."""
    from xgboost_tpu_torch.ops.cuda.hist import K3_KERNELS
    return {name: prec for prec, name in K3_KERNELS.items()}


def hist_kernels(N):
    """The kernels that run at a level of N nodes, with their plain
    versions: (name, kernel(args), plain(args), maker of the args). K3
    in its three precisions at every level (``pallas:bf16x2`` /
    ``pallas:bf16`` build every level with it)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    def int8x2_args(bins, gpair, rel):
        q, inv = H.quantise_int8x2(gpair)
        return bins, q, rel, inv

    def f32_args(bins, gpair, rel):
        qs, inv = H.fixed_point_scale(gpair)
        return bins, gpair, rel, qs, inv

    def k3(prec):
        return (lambda *a: K.hist_f32_cuda(*a, precision=prec),
                lambda *a: H.build_hist_f32_reference(*a, precision=prec))

    out = [(name, *k3(prec), f32_args)
           for name, prec in k3_precisions().items()]
    if N <= 128:
        out += [("hist_int8x2", K.hist_int8x2_cuda,
                 H.build_hist_int8x2_reference, int8x2_args),
                ("hist_scan", K.hist_scan_cuda, H.build_hist_scan_reference,
                 int8x2_args)]
    return out


def check_hist(bins, gpair, rel, N, B, label, only=None):
    """Each kernel (of ``only``, when given) against its plain version on
    the same card tensors: equal bit for bit on two launches; totals
    against the row sums. Returns {kernel: max |kernel - plain|}."""
    from xgboost_tpu_torch.ops.histogram import bf16_parts

    errs = {}
    ratios = []
    for name, kernel, plain, make in hist_kernels(N):
        if only is not None and name not in only:
            continue
        args = make(bins, gpair, rel)
        runs = [kernel(*args, N, B) for _ in range(2)]
        want = plain(*args, N, B)
        torch.cuda.synchronize()
        errs[name] = max(float((r - want).abs().max()) for r in runs)
        if not all(torch.equal(r, want) for r in runs):
            raise AssertionError(f"{name} {label}: a launch differs from the "
                                 f"plain version (max {errs[name]})")
        # the totals of what the rows add: K3's rounded precisions add
        # each row's bfloat16 parts, each rounded to the fixed point
        parts = bf16_parts(gpair, k3_precisions().get(name, "f32"))
        ratios.append(hist_totals_ok(f"{name} {label}", runs[0],
                                     sum(p.double() for p in parts), rel, N,
                                     args[-1] * len(parts)))
    log(f"check hist {label}: rows={bins.shape[0]} features={bins.shape[1]} "
        f"nodes={N} bins={B} ({bins.dtype}): {sorted(errs)} equal their "
        f"plain versions bit for bit on two launches; totals at "
        f"{max(ratios):.3f} of their bound at most")
    return errs


def hist_bound_ms(bins, N, B, n_active, planes, coarse=False, F=None):
    """(ms, "bytes"|"operations", ops): bins, the gradients (q or gpair,
    8 B a row) and rel read once, the [N, F, B, 2] f32 histogram (and
    with ``coarse`` the [N, F, 20, 2] coarse one) written once, over
    3.35 TB/s; against one integer add per (active row, feature, plane)
    over the f32 lane rate (the table has no scalar integer rate). ``F``:
    the features of a u4-packed page (``bins`` [n, ceil(F/2)] bytes)."""
    n, W = bins.shape
    F = F or W
    nbytes = (n * W * bins.element_size() + n * 8 + n * 4
              + N * F * (B + (20 if coarse else 0)) * 8)
    ops = n_active * F * planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", ops
    return t_ops, "operations", ops


def time_hist(bins, gpair, rel, N, B, flush, only=None):
    """{kernel: (ms, plain_ms, library_ms)} for the kernels of a level of
    N nodes (of ``only``, when given): CUDA-event times of each kernel
    (L2 flushed), its plain version, and the nearest single PyTorch call,
    one ``index_add_`` of the four int32 planes (K2, K4) or of the f32
    (g, h) pairs (K3), with the (row, feature) cells and values prepared
    beforehand. Also the active row count."""
    from xgboost_tpu_torch.ops import histogram as H

    F = bins.shape[1]
    seg, active = H._segments(bins, rel, N, B)
    q, _ = H.quantise_int8x2(gpair)
    vals = H.int8x2_planes(q)[active][:, None, :].expand(-1, F, 4).reshape(
        -1, 4)
    acc = torch.zeros((N * F * B, 4), dtype=torch.int32, device=bins.device)
    lib_int = event_ms(lambda: acc.index_add_(0, seg, vals), reps=10,
                       flush=flush)
    del vals, acc
    gv = gpair[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    accf = torch.zeros((N * F * B, 2), dtype=torch.float32,
                       device=bins.device)
    lib_f32 = event_ms(lambda: accf.index_add_(0, seg, gv), reps=10,
                       flush=flush)
    del seg, gv, accf
    out = {}
    for name, kernel, plain, make in hist_kernels(N):
        if only is not None and name not in only:
            continue
        args = make(bins, gpair, rel)
        out[name] = (
            event_ms(lambda: kernel(*args, N, B), reps=20, flush=flush),
            event_ms(lambda: plain(*args, N, B), reps=5),
            lib_f32 if name in k3_precisions() else lib_int)
    return out, int(active.sum())


# (rows, nodes of the new level, bin slots, skewed): K5 at the level
# boundaries the fused runs give it (read in row order up to 16 nodes, in
# two feature tiles at 16; sorted above), with the missing-slot layout,
# and below skewed levels
K5_CASES = ((1_000_000, 2, 256, False), (1_000_000, 8, 256, False),
            (1_000_000, 16, 256, False), (1_000_000, 32, 256, False),
            (1_000_000, 128, 256, False), (1_000_000, 64, 257, False),
            (1_000_000, 8, 257, True), (1_000_000, 16, 257, True),
            (1_000_000, 128, 256, True))


def level_inputs(n, F, B, N, dev, seed, skew=False):
    """A level boundary made on the card from ``seed``: ``hist_inputs``'s
    bins and gradients; int64 positions at the previous level of N / 2
    nodes, 10% of them strays above it; that level's splits, 20% of its
    nodes not splitting. ``skew``: every node splits, 55% of the rows sit
    at its node 1 and its nodes 0 and 2 hold none."""
    from xgboost_tpu_torch.ops.partition import LevelSplits

    bins, gpair, _ = hist_inputs(n, F, B, 1, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n_prev = N // 2
    lo_prev = n_prev - 1
    pos = lo_prev + torch.randint(0, n_prev, (n,), generator=g, device=dev)
    stray = torch.randint(0, max(lo_prev, 1), (n,), generator=g, device=dev)
    pos = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, stray,
                      pos)
    cs = torch.rand(n_prev, generator=g, device=dev) < 0.8
    if skew:
        big = lo_prev + 1 % n_prev
        pos = torch.where((pos == lo_prev) | (pos == lo_prev + 2),
                          torch.full_like(pos, big), pos)
        pos = torch.where(torch.rand(n, generator=g, device=dev) < 0.55,
                          torch.full_like(pos, big), pos)
        cs = torch.ones_like(cs)
    feat = torch.randint(0, F, (n_prev,), generator=g, device=dev)
    thr = torch.randint(0, B - 1, (n_prev,), generator=g, device=dev)
    dleft = torch.rand(n_prev, generator=g, device=dev) < 0.5
    prev = LevelSplits(lo_prev, torch.where(cs, feat, -1),
                       torch.where(cs, thr, 0), cs & dleft, cs)
    return bins, gpair, pos.contiguous(), prev


def check_fused(n_rows, N, B, skew, dev, seed):
    """K5 against its plain version on the same card tensors: positions
    and coarse histogram equal bit for bit on two launches, and the
    histogram equal to K2 over the coarse ids of the advanced rows.
    Returns max |kernel - plain| of the histogram."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, pos, prev = level_inputs(n_rows, 28, B, N, dev, seed, skew)
    missing = B - 1 if B > 256 else B
    lo = 2 * prev.lo + 1
    q, inv = H.quantise_int8x2(gpair)
    runs = [K.fused_advance_coarse_cuda(bins, q, inv, pos, prev, lo, N,
                                        missing) for _ in range(2)]
    want_pos, want = H.fused_advance_coarse_reference(bins, q, inv, pos,
                                                      prev, lo, N, missing)
    k2 = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q,
                            level_rel(want_pos, lo, N), inv, N, COARSE_B)
    torch.cuda.synchronize()
    err = max(float((h - want).abs().max()) for _, h in runs)
    for p, h in runs:
        if not (torch.equal(p, want_pos) and torch.equal(h, want)):
            raise AssertionError(f"fused_advance_coarse n={n_rows} N={N} "
                                 f"B={B} skew={skew}: a launch differs from "
                                 f"the plain version (max {err})")
    if not torch.equal(k2, want):
        raise AssertionError("K5's coarse histogram differs from K2's")
    moved = int((want_pos != pos).sum())
    log(f"check fused_advance_coarse n={n_rows} F=28 N={N} B={B}"
        f"{' skewed' if skew else ''} ({bins.dtype}): positions ({moved} "
        f"rows moved) and the coarse "
        f"histogram equal the plain version bit for bit on two launches, "
        f"and K2 over the coarse ids")
    return err


# (rows, nodes, bin slots, skewed): K4's fold at the scan schedule's
# levels: the root (one item a node's tile split over the card), one node
# a group (16, 128), the missing-slot layout, and a skewed level
FOLD_CASES = ((1_000_000, 1, 256, False), (1_000_000, 16, 256, False),
              (1_000_000, 128, 256, False), (1_000_000, 64, 257, False),
              (1_000_000, 128, 256, True), (10_000, 16, 257, True))


def check_fold(n_rows, N, B, skew, dev, seed):
    """K4 with its fold against the plain versions on the same card
    tensors, bit for bit on two launches: the fine histogram against
    ``build_hist_scan_reference``, the coarse one against the plain fold
    of the plain accumulators and against K2's direct build over the
    coarse ids. Returns max |kernel - plain| of the coarse histogram."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, rel = hist_inputs(n_rows, 28, B, N, dev, seed, skew)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(gpair)
    runs = [K.hist_scan_cuda(bins, q, rel, inv, N, B, with_coarse=True,
                             missing_bin=missing) for _ in range(2)]
    acc = H.scan_acc_reference(bins, q, rel, N, B)
    want_fine = H.dequant_int8x2(acc, inv)
    want = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    direct = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q, rel, inv,
                                N, COARSE_B)
    torch.cuda.synchronize()
    err = max(float((c - want).abs().max()) for _, c in runs)
    label = f"n={n_rows} N={N} B={B}{' skewed' if skew else ''}"
    for fine, coarse in runs:
        if not (torch.equal(fine, want_fine) and torch.equal(coarse, want)):
            raise AssertionError(f"K4 with its fold {label}: a launch "
                                 f"differs from the plain version (max "
                                 f"{err})")
    if not torch.equal(want, direct):
        raise AssertionError("K4's folded coarse histogram differs from "
                             "K2's direct build")
    log(f"check coarse fold {label}: K4's fine and folded coarse "
        f"histograms equal the plain versions bit for bit on two launches, "
        f"and K2's direct coarse build")
    return err


def fused_bound_ms(bins, N, n_active):
    """(ms, "bytes"|"operations", ops) of K5: bins, q (8 B a row) and the
    int64 positions read once, the positions written once and the
    [N, F, 20, 2] f32 histogram written once, over 3.35 TB/s; against one
    integer add per (row in the new level, feature, plane) over the f32
    lane rate."""
    n, F = bins.shape
    nbytes = n * F * bins.element_size() + n * 8 + 2 * n * 8 + N * F * 20 * 8
    ops = n_active * F * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", ops
    return t_ops, "operations", ops


QUEUE_CYCLES = 2_000_000     # ~1 ms of device sleep ahead of each call


def queued_ms(fn, reps, flush):
    """Mean device time of ``fn`` with no host gap inside it: before each
    call the L2 is flushed (unless ``flush`` is None) and the device sleeps
    ~1 ms, so that the host has queued the whole call before its start
    event runs. ``event_ms`` instead lets a wrapper's host work show where
    the device waits."""
    return phase_ms(lambda ev: fn(), reps, flush, phases=False)[0]


def phase_ms(fn, reps, flush, phases=True):
    """Mean device time of each phase of ``fn(events)`` (a kernel wrapper
    taking ``phase_events``): start -> sort, -> tiles, -> combine and
    fold, over ``reps`` calls queued as in :func:`queued_ms`, after three
    warm-up calls (the events made and recorded once beforehand). With
    ``phases`` False: [start -> end]."""
    for _ in range(3):
        fn(None)
    k = 4 if phases else 2
    runs = [[torch.cuda.Event(enable_timing=True) for _ in range(k)]
            for _ in range(reps)]
    for ev in runs:
        for e in ev:
            e.record()
    torch.cuda.synchronize()
    for ev in runs:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(QUEUE_CYCLES)
        ev[0].record()
        if phases:
            fn(ev[1:])
        else:
            fn(None)
            ev[1].record()
    torch.cuda.synchronize()
    return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in runs) / reps
            for i in range(k - 1)]


# the level widths of the HIGGS run (depth 8): K4 at each, K5 at each
# boundary
LEVEL_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)


def time_levels(dev, flush, current=True):
    """K4 at every level width (1M x 28, 256 slots) and K5 at every level
    boundary, through the calls every version of the port has: K4 as
    ``auto`` calls it (``hist_scan_cuda``) and as ``scan`` does
    (``scan_level_hists``: K4 and its coarse fold), K5
    (``fused_advance_coarse_cuda``), and K2 on K4's inputs. ``current``:
    also K4 with its fold alone, the plain versions, one ``index_add_``,
    the bounds and the phase split of this tree's kernels. Returns
    {name: {N: {...}}} and logs each level."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    F = 28
    out = {"hist_scan": {}, "fused_advance_coarse": {}}
    for i, N in enumerate(LEVEL_WIDTHS):
        bins, gpair, rel = hist_inputs(1_000_000, F, 256, N, dev,
                                       seed=200 + i)
        q, inv = H.quantise_int8x2(gpair)
        k4 = lambda: K.hist_scan_cuda(bins, q, rel, inv, N, 256)
        scan = lambda: H.scan_level_hists(bins, gpair, rel, N, 256, 256)
        k2 = lambda: K.hist_int8x2_cuda(bins, q, rel, inv, N, 256)
        r = {"ms": event_ms(k4, reps=20, flush=flush),
             "queued_ms": queued_ms(k4, 20, flush),
             "scan_level_queued_ms": queued_ms(scan, 20, flush),
             "k2_queued_ms": queued_ms(k2, 20, flush)}
        if current:
            seg, active = H._segments(bins, rel, N, 256)
            vals = H.int8x2_planes(q)[active][:, None, :].expand(
                -1, F, 4).reshape(-1, 4)
            acc = torch.zeros((N * F * 256, 4), dtype=torch.int32,
                              device=dev)
            r["library_ms"] = event_ms(lambda: acc.index_add_(0, seg, vals),
                                       reps=10, flush=flush)
            n_active = int(active.sum())
            del seg, vals, acc
            r["coarse_queued_ms"] = queued_ms(lambda: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, with_coarse=True, missing_bin=256),
                20, flush)
            r["plain_ms"] = event_ms(lambda: H.build_hist_scan_reference(
                bins, q, rel, inv, N, 256), reps=5)
            r["plain_coarse_ms"] = event_ms(lambda: H.dequant_int8x2(
                H.coarse_fold(H.scan_acc_reference(bins, q, rel, N, 256),
                              256), inv), reps=5)
            r["bound"] = hist_bound_ms(bins, N, 256, n_active, 4)
            r["coarse_bound"] = hist_bound_ms(bins, N, 256, n_active, 4,
                                              coarse=True)
            r["phases"] = phase_ms(lambda ev: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, phase_events=ev), 20, flush)
            r["coarse_phases"] = phase_ms(lambda ev: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, with_coarse=True, missing_bin=256,
                phase_events=ev), 20, flush)
        out["hist_scan"][N] = r
        log(f"level K4 n=1000000 N={N} x {F} u8 256 slots (L2 flushed): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
        del bins, gpair, rel, q, inv
    for i, N in enumerate(LEVEL_WIDTHS[1:]):
        bins, gpair, pos, prev = level_inputs(1_000_000, F, 256, N, dev,
                                              seed=220 + i)
        lo = 2 * prev.lo + 1
        q, inv = H.quantise_int8x2(gpair)
        k5 = lambda: K.fused_advance_coarse_cuda(bins, q, inv, pos, prev, lo,
                                                 N, 256)
        r = {"ms": event_ms(k5, reps=20, flush=flush),
             "queued_ms": queued_ms(k5, 20, flush)}
        if current:
            new_pos, _ = H.fused_advance_coarse_reference(
                bins, q, inv, pos, prev, lo, N, 256)
            cb = coarse_bin_ids(bins, 256)
            seg, active = H._segments(cb, level_rel(new_pos, lo, N), N,
                                      COARSE_B)
            vals = H.int8x2_planes(q)[active][:, None, :].expand(
                -1, F, 4).reshape(-1, 4)
            acc = torch.zeros((N * F * COARSE_B, 4), dtype=torch.int32,
                              device=dev)
            r["library_ms"] = event_ms(lambda: acc.index_add_(0, seg, vals),
                                       reps=10, flush=flush)
            n_active = int(active.sum())
            del seg, vals, acc, cb, new_pos
            r["plain_ms"] = event_ms(lambda: H.fused_advance_coarse_reference(
                bins, q, inv, pos, prev, lo, N, 256), reps=5)
            r["bound"] = fused_bound_ms(bins, N, n_active)
            r["phases"] = phase_ms(lambda ev: K.fused_advance_coarse_cuda(
                bins, q, inv, pos, prev, lo, N, 256, phase_events=ev), 20,
                flush)
        out["fused_advance_coarse"][N] = r
        log(f"level K5 n=1000000 N={N} x {F} u8 (L2 flushed): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
        del bins, gpair, pos, prev, q, inv
    return out


# K1's main-path shapes, timed through ``PackedForest.margin`` (the call
# every version of the port has): the HIGGS-shape forest at 1 and 512 rows
# (L2 warm: a server bucket), 100,000 and 1,000,000 rows (L2 flushed: a
# batch predict), and a one-tree forest at 100,000 rows (the eval walk of
# a training round, L2 flushed)
WALK_SHAPES = (("1", 1), ("512", 512), ("100000", 100_000),
               ("1000000", 1_000_000), ("Tp=1 100000", 100_000))
# both schedules, device-only, across the crossover: the server's buckets,
# 2k, 8k and 32k rows, 100,000 rows
CROSSOVER_ROWS = (1, 8, 64, 512, 2048, 8192, 32768, 100_000)


def walk_forests(dev):
    """(booster, its packed forest, its base margin, one-tree forest,
    X [1M, 28] on the card): ``make_forest_model(500, 8, 28)`` through
    ``Booster``, and ``make_forest(1, 8, 28)``, with the calls every
    version has."""
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.serve.packed import PackedForest
    from xgboost_tpu_torch.testing import make_forest, make_forest_model

    b = xt.Booster(model_file=make_forest_model(500, 8, 28, seed=0))
    trees, info = make_forest(1, 8, 28, seed=3)
    g = torch.Generator(device=dev).manual_seed(300)
    X = torch.randn(1_000_000, 28, generator=g, device=dev)
    return (b, b.packed_forest(), torch.tensor(b._base_np(), device=dev),
            PackedForest.from_trees(trees, info, 1), X)


def time_walk(dev, flush, current=True):
    """K1 at ``WALK_SHAPES`` through ``PackedForest.margin``: CUDA-event
    time (the wrapper's host work included, as a caller sees it) and
    device-only time (``queued_ms``); at 1 and 512 rows also the host
    clock of the call alone (``host_ms``, until it returns) and of the
    call and a sync (``host_sync_ms``), medians of 500. ``current``: also both schedules at
    ``CROSSOVER_ROWS`` (device-only), the plain walk at 512 and 100,000
    rows, each shape's bound, and at 100,000 and 1,000,000 rows the staged
    walk stopped at the roots (``max_depth`` 0: X staged, every chunk
    copied, every root read, no node visited), the part of its time that
    is not the walk itself. Also ``Booster.predict`` on 100,000 and
    1,000,000 rows (host clock, numpy in and out, median of 5). Returns
    {"shapes": {name: {...}}, "predict": {rows: {...}}, "schedules":
    {schedule: {rows: ms}}}."""
    import xgboost_tpu_torch as xt

    booster, pf, base, one, X = walk_forests(dev)
    zero = torch.zeros(1, device=dev)
    out = {"shapes": {}, "predict": {}}
    for label, n in WALK_SHAPES:
        f, b = (one, zero) if label.startswith("Tp=1") else (pf, base)
        Xn = X[:n].contiguous()
        cold = flush if n >= 100_000 else None
        fn = lambda: f.margin(Xn, b)
        r = {"ms": event_ms(fn, reps=10 if n >= 1_000_000 else
                            20 if cold is not None else 200, flush=cold),
             "queued_ms": queued_ms(fn, 10 if n >= 1_000_000 else 20, cold)}
        if cold is None:
            host, full = [], []
            for _ in range(500):
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append(t1 - t0)
                full.append(time.perf_counter() - t0)
            r["host_ms"] = float(np.median(host)) * 1e3
            r["host_sync_ms"] = float(np.median(full)) * 1e3
        if current:
            _, leaves = f.margin(Xn, b, leaf_index=True)
            depth = torch.from_numpy(node_depths(f)).to(dev)
            r["bound"] = walk_bound_ms(f, n, 28, int(
                depth[leaves.long()].sum()))
            del leaves
        out["shapes"][label] = r
        l2 = "L2 flushed" if cold is not None else "L2 warm"
        log(f"walk {label} rows ({l2}): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
    if current:
        from xgboost_tpu_torch.ops.walk import walk_packed_reference
        from xgboost_tpu_torch.serve.packed import tree_step

        from xgboost_tpu_torch.ops.cuda.walk import walk_packed_cuda

        d = pf.device_arrays(dev)
        for n in (100_000, 1_000_000):
            Xn = X[:n].contiguous()
            r = out["shapes"][str(n)]
            r["roots_ms"] = queued_ms(lambda: walk_packed_cuda(
                d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
                d["tree_group"], Xn, base, max_depth=0,
                max_feature=pf.max_feature, nodes=d["nodes"],
                spans=pf.slot_spans(), plans=pf.walk_plans(dev),
                schedule="staged"), 10, flush)
            log(f"walk {n} rows, staged, stopped at the roots (device-only, "
                f"L2 flushed): {r['roots_ms']:.6f} ms of "
                f"{r['queued_ms']:.6f} ms")
        for n in (512, 100_000):
            Xn = X[:n].contiguous()
            out["shapes"][str(n)]["plain_ms"] = event_ms(
                lambda: walk_packed_reference(
                    d["words"], d["values"], d["tree_offsets"],
                    d["tree_weight"], d["group_onehot"], Xn, base,
                    max_depth=pf.max_depth, tree_chunk=tree_step(n)),
                reps=5 if n > 512 else 20)
        out["schedules"] = {}
        for sch in ("spread", "staged"):
            row = {}
            for n in CROSSOVER_ROWS:
                Xn = X[:n].contiguous()
                row[n] = queued_ms(lambda: pf.margin(Xn, base, schedule=sch),
                                   20, flush if n >= 100_000 else None)
            out["schedules"][sch] = row
            log(f"walk schedule {sch} (device-only; L2 flushed from 100000 "
                f"rows): " + ", ".join(f"{n} rows {ms:.6f} ms"
                                       for n, ms in row.items()))
    Xh = X.cpu().numpy()
    for n in (100_000, 1_000_000):
        dm = xt.DMatrix(Xh[:n])
        booster.predict(dm)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            booster.predict(dm)
            ts.append(time.perf_counter() - t0)
        s = float(np.median(ts))
        out["predict"][n] = {"s": s, "rows_per_s": n / s}
        log(f"Booster.predict {n} rows: {s * 1e3:.3f} ms (median of 5, host "
            f"clock, numpy in and out) = {n / s:.1f} rows/s")
    return out


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6f} ms"
    if isinstance(v, tuple) and len(v) == 2:     # K1's bound
        return f"{v[0]:.6f} ms ({v[1]})"
    if isinstance(v, tuple):               # a bound
        return f"{v[0]:.6f} ms ({v[1]}; {v[2]} integer adds)"
    return "[" + ", ".join(f"{x:.6f}" for x in v) + "] ms"


# ---- the Covertype shape (BASELINE.json config #4) ---------------------------

# UCI Covertype (covtype): 581,012 rows of 54 features (10 continuous, a
# one-hot wilderness area of 4 and a one-hot soil type of 40), 7 cover
# types with these row counts; the held-out rows are extra draws
COVTYPE_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                        20_510)
COVTYPE_TEST_ROWS = 100_000
COVTYPE_PARAMS = {"objective": "multi:softprob", "num_class": 7,
                  "max_depth": 8, "eta": 0.1, "max_bin": 256,
                  "subsample": 0.8, "colsample_bytree": 0.8,
                  "colsample_bynode": 0.8, "eval_metric": "mlogloss"}
COVTYPE_ROUNDS = 30
COVTYPE_EARLY_STOP = 5


def covtype_like(seed):
    """(X [581,012 + 100,000, 54] f32, labels) with covtype's structure:
    10 continuous N(0, 1) columns, a one-hot wilderness area (4 columns,
    skewed areas) and a one-hot soil type (40 columns, Zipf-like), made
    from ``seed``. The label comes from a fixed rule plus noise: a score
    linear in the continuous columns plus an effect per area and per soil
    type, cut at covtype's class counts over the first 581,012 rows (the
    cut points then label the held-out rows), the score's 7 bands mapped
    to the classes in a fixed order."""
    rng = np.random.default_rng(seed)
    n = sum(COVTYPE_CLASS_COUNTS) + COVTYPE_TEST_ROWS
    cont = rng.standard_normal((n, 10), dtype=np.float32)
    area = rng.choice(4, n, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = 1.0 / np.arange(1, 41) ** 1.1
    soil = rng.choice(40, n, p=soil_p / soil_p.sum())
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    score = (cont @ rng.standard_normal(10).astype(np.float32)
             + rng.standard_normal(4)[area] + rng.standard_normal(40)[soil]
             + 0.5 * rng.standard_normal(n))
    n_train = sum(COVTYPE_CLASS_COUNTS)
    order = (1, 0, 6, 2, 5, 4, 3)            # class of each score band
    cuts = np.sort(score[:n_train])[np.cumsum(
        [COVTYPE_CLASS_COUNTS[c] for c in order])[:-1]]
    y = np.asarray(order, np.float32)[np.searchsorted(cuts, score,
                                                      side="right")]
    return X, y


def round_masks(params, iterations, base_mask, device):
    """Every feature mask and the first tree's row sample of the Covertype
    rounds ``iterations``, drawn on ``device`` as ``train`` draws them
    (``Booster.update``'s round key, ``GBTree.do_boost``'s tree keys),
    over the features with real bins (``base_mask``) -> sha256 of their
    bytes."""
    from xgboost_tpu_torch.context import Context
    from xgboost_tpu_torch.tree.grow import draw_feature_masks
    from xgboost_tpu_torch.tree.param import TrainParam
    from xgboost_tpu_torch.utils import random as xrandom

    tp = TrainParam()
    tp.update_allow_unknown(dict(params))
    ctx = Context(device="cpu")
    h = hashlib.sha256()
    base = torch.from_numpy(base_mask).to(device)
    K = params["num_class"]
    for it in iterations:
        key = xrandom.fold_in(ctx.make_key(it), it)
        tkeys = [xrandom.fold_in(key, k) for k in range(K)]
        for tree in draw_feature_masks(tkeys, base, tp, tp.max_depth):
            for m in tree:
                h.update(m.cpu().numpy().tobytes())
        rows = xrandom.bernoulli(xrandom.fold_in(tkeys[0], 0x5AB),
                                 tp.subsample, (sum(COVTYPE_CLASS_COUNTS),),
                                 device)
        h.update(rows.cpu().numpy().tobytes())
    return h.hexdigest()


def multi_logloss(p, y):
    return float(-np.mean(np.log(np.clip(p[np.arange(len(y)),
                                           y.astype(np.int64)], 1e-16, 1))))


def merror(p, y):
    return float(np.mean(p.argmax(axis=1) != y))


def saved_bytes(bst):
    """``save_raw`` bytes with the ``hist_method`` the booster records set
    to one value, so that models of different schedules compare."""
    bst.set_param({"hist_method": "scan"})
    return bytes(bst.save_raw("ubj"))


# ---- BASELINE.json config #4 in full: categorical codes and dart ------------

# ``covtype_like``'s draws with the two qualitative attributes as codes;
# XGBoost's DART tutorial settings; the categorical defaults (area: 4
# categories, one-hot; soil: 40, sorted partition)
COVDART_PARAMS = dict(COVTYPE_PARAMS, booster="dart", sample_type="uniform",
                      normalize_type="tree", rate_drop=0.1, skip_drop=0.5,
                      max_cat_to_onehot=4, max_cat_threshold=64,
                      eval_metric=["merror", "mlogloss"])
COVDART_TYPES = ["q"] * 10 + ["c", "c"]
COVDART_DEEP_ROWS = 200_000


def covtype_codes(X):
    """``covtype_like``'s rows with the wilderness area (0-3) and soil
    type (0-39) as the codes they were drawn as, in place of their one-hot
    columns: UCI Covertype's 12 attributes, [n, 12] f32."""
    area = X[:, 10:14].argmax(axis=1)
    soil = X[:, 14:54].argmax(axis=1)
    return np.concatenate([X[:, :10], area[:, None], soil[:, None]],
                          axis=1).astype(np.float32)


def split_kinds(bst):
    """(one-hot, partition) splits in the forest: the categorical splits
    on ``area`` (4 categories) and on ``soil`` (40)."""
    onehot = part = 0
    for t in bst.gbm.trees:
        onehot += int((t.is_cat_split & (t.split_feature == 10)).sum())
        part += int((t.is_cat_split & (t.split_feature == 11)).sum())
    return onehot, part


def covertype_categorical_dart(xt, dev, Xc, yc, gbtree_quality):
    """The ``covertype_categorical_dart`` phase (module docstring):
    returns (the main-path runs' launch counts, {kernel: max |kernel -
    plain|}, K1's errors, K2's times at the categorical levels of 128
    nodes, seconds a round, device busy over three rounds)."""
    from xgboost_tpu_torch.boosting.dart import Dart
    from xgboost_tpu_torch.callback import TrainingCallback
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.serve import Server

    class WeightLog(TrainingCallback):
        """Each round's drop count and weight_drop range."""

        def __init__(self):
            self.rows = []

        def after_iteration(self, model, epoch, evals_log):
            w = model.gbm.weight_drop
            self.rows.append((drops[-1], min(w), max(w)))
            return False

    n_cov = sum(COVTYPE_CLASS_COUNTS)
    Xk = covtype_codes(Xc)
    kw = dict(feature_types=COVDART_TYPES, enable_categorical=True)
    dtr = xt.DMatrix(Xk[:n_cov], label=yc[:n_cov], **kw)
    dte = xt.DMatrix(Xk[n_cov:], label=yc[n_cov:], **kw)
    yte = yc[n_cov:]
    drops = []
    select = Dart._select_drop

    def counted(self):
        out = select(self)
        drops.append(len(out))
        return out

    Dart._select_drop = counted
    runs, raws, logs = [], [], []
    try:
        for run in range(2):
            res = {}
            wl = WeightLog()
            t0 = time.perf_counter()
            bst, c = train_launches(
                f"Covertype categorical dart run {run}",
                lambda r=res, w=wl: xt.train(
                    COVDART_PARAMS, dtr, COVTYPE_ROUNDS,
                    evals=[(dte, "test")], evals_result=r, verbose_eval=10,
                    early_stopping_rounds=COVTYPE_EARLY_STOP,
                    callbacks=[w]))
            t_run = time.perf_counter() - t0
            rounds = bst.num_boosted_rounds()
            want = {k: 0 for k in K.LAUNCHES}
            want["hist_int8x2"] = 56 * rounds
            if {k: c[k] for k in K.LAUNCHES} != want:
                raise AssertionError(f"categorical dart launched {c}, "
                                     f"expected {want}: K2 at every level "
                                     "of every class tree, K4 never")
            if c["walk_packed"] != rounds or c["walk_staged"] != rounds:
                raise AssertionError(f"categorical dart's held-out walks: "
                                     f"{c}, expected K1 once a round")
            runs.append(c)
            raws.append(bytes(bst.save_raw("ubj")))
            logs.append(wl.rows)
            log(f"train Covertype categorical dart run {run}: {rounds} "
                f"rounds in {t_run:.3f} s (host clock, sketch and binning "
                f"included on run 0); launches a round: K2 "
                f"{c['hist_int8x2'] / rounds:g}, K4 {c['hist_scan']}, K1 "
                f"{c['walk_packed'] / rounds:g}")
    finally:
        Dart._select_drop = select
    if logs[0] != logs[1]:
        raise AssertionError("two dart runs drew other drops")
    log("Covertype categorical dart drops and weight_drop range a round: "
        + "; ".join(f"[{i}] {k} dropped, w {lo:.6f}..{hi:.6f}"
                    for i, (k, lo, hi) in enumerate(logs[0])))
    digests = [hashlib.sha256(r).hexdigest() for r in raws]
    if digests[0] != digests[1]:
        raise AssertionError(f"two categorical dart runs saved different "
                             f"models: {digests}")
    log(f"Covertype categorical dart model sha256 (two runs): {digests[0]} "
        f"{digests[1]}")
    onehot, part = split_kinds(bst)
    if not (onehot > 0 and part > 0):
        raise AssertionError(f"one-hot splits {onehot}, partition splits "
                             f"{part}: both kinds must appear")
    # held-out quality, beside the one-hot gbtree phase at the same round
    mll, mer = res["test"]["mlogloss"], res["test"]["merror"]
    p = bst.predict(dte)
    if not (mll[-1] < mll[0] and np.isfinite(p).all()
            and p.shape == (COVTYPE_TEST_ROWS, 7)):
        raise AssertionError(f"categorical dart held-out mlogloss {mll[0]} "
                             f"-> {mll[-1]}")
    if abs(multi_logloss(p, yte) - mll[-1]) > 1e-5:
        raise AssertionError("Booster.predict disagrees with the eval line")
    g_mll, g_me = gbtree_quality
    last = len(mll) - 1
    log(f"Covertype categorical dart held-out: mlogloss {mll[0]} -> "
        f"{mll[-1]}, merror {mer[0]} -> {mer[-1]} (round {last}); the "
        f"one-hot gbtree phase at round {min(last, len(g_mll) - 1)}: "
        f"mlogloss {g_mll[0]} -> {g_mll[min(last, len(g_mll) - 1)]}, "
        f"merror {g_me[0]:.6f} -> {g_me[1]:.6f} (its last round); splits: "
        f"{onehot} one-hot (area), {part} partition (soil)")
    # a save/load round trip, a Server, and K1 against its plain version on
    # the trained forest (weights from 1 down, 8 left-set words)
    again = xt.Booster(model_file=raws[1])
    if not np.array_equal(again.predict(dte), p):
        raise AssertionError("the dart model's round trip predicts other "
                             "bits")
    Xte = Xk[n_cov:]
    reset_counts()
    with Server(models={"covdart": raws[1]}, max_batch=512) as srv:
        srv.warmup()
        for i in range(40):
            n = (1, 8, 64, 512)[i % 4]
            lo = (i * 1237) % (COVTYPE_TEST_ROWS - n)
            if not np.array_equal(np.asarray(srv.predict(Xte[lo:lo + n])),
                                  p[lo:lo + n]):
                raise AssertionError(f"a dart Server answer ({n} rows at "
                                     f"{lo}) differs from Booster.predict")
    serve_counts = read_counts()
    log(f"Covertype categorical dart serve: 40 requests of 1/8/64/512 rows, "
        f"every answer equal to Booster.predict; K1 "
        f"{serve_counts['walk_packed']}; save_raw round trip predicts the "
        f"same bits")
    pf = bst.packed_forest()
    if not (pf.has_cat and pf.cat_words.shape[1] == 8
            and float(pf.tree_weight[:pf.n_trees].min()) < 1.0):
        raise AssertionError("the trained dart forest packs no categorical "
                             "node or no tree weight below 1")
    Xte_dev = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    base = torch.tensor(bst._base_np(), device=dev)
    k1_errs = []
    for n in (512, 100_000):
        for sch in ("spread", "staged"):
            k1_errs.append(check_kernel(f"Covertype dart n={n}", pf,
                                        Xte_dev[:n].contiguous(), base,
                                        sch)[0])
    # seconds a round and three profiled rounds
    timer, per, s_round = seconds_per_round(COVDART_PARAMS, dtr)
    log(f"Covertype categorical dart seconds per round (update + sync, host "
        f"clock): {['%.6f' % t for t in per]}; median of rounds 1-5 "
        f"{s_round:.6f} s")
    busy, _ = profile_rounds("Covertype categorical dart", timer, dtr,
                             top=14)
    del timer
    # K2 over the category-code bins against its plain version, and its
    # time at the levels of 128 nodes
    errs = {}
    bins = dtr.binned(256, dev).bins
    g = torch.Generator(device=dev).manual_seed(140)
    gpair = torch.stack([torch.randn(n_cov, generator=g, device=dev),
                         torch.rand(n_cov, generator=g, device=dev)], dim=1)
    for N in (1, 128):
        rel = torch.randint(0, N + 1, (n_cov,), generator=g, device=dev,
                            dtype=torch.int32)
        for k, e in check_hist(bins, gpair, rel, N, 256,
                               f"category codes n={n_cov} N={N}").items():
            errs[k] = max(errs.get(k, 0.0), e)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    t, n_active = time_hist(bins, gpair, rel, 128, 256, flush)
    k2_ms, k2_plain, k2_lib = t["hist_int8x2"]
    k2_bound = hist_bound_ms(bins, 128, 256, n_active, 4)
    k2 = (k2_ms, k2_plain, k2_lib, k2_bound)
    log(f"hist hist_int8x2 category codes n={n_cov} N=128 B=256 x 12 u8 "
        f"(L2 flushed): {k2_ms:.6f} ms, plain {k2_plain:.6f} ms, "
        f"index_add_ {k2_lib:.6f} ms, bound {k2_bound[0]:.6f} ms "
        f"({k2_bound[1]})")
    del flush, gpair, rel
    # depth 10 on the first 200,000 rows, one round: K3 at the levels of
    # 256 and 512 nodes over the category codes, held to its plain version
    d10 = xt.DMatrix(Xk[:COVDART_DEEP_ROWS], label=yc[:COVDART_DEEP_ROWS],
                     **kw)
    deep, c10 = train_launches("Covertype categorical dart depth 10",
                               lambda: xt.train(dict(COVDART_PARAMS,
                                                     max_depth=10),
                                                d10, 1, verbose_eval=False))
    want = {k: 0 for k in K.LAUNCHES}
    want.update(hist_int8x2=56, hist_f32=14)
    if {k: c10[k] for k in K.LAUNCHES} != want:
        raise AssertionError(f"categorical depth 10 launched {c10}, expected "
                             f"{want}")
    if max(t.max_depth() for t in deep.gbm.trees) != 10:
        raise AssertionError("no categorical tree reached depth 10")
    bins10 = d10.binned(256, dev).bins
    g10 = torch.stack([torch.randn(COVDART_DEEP_ROWS, generator=g,
                                   device=dev),
                       torch.rand(COVDART_DEEP_ROWS, generator=g,
                                  device=dev)], dim=1)
    for N in (256, 512):
        rel = torch.randint(0, N + 1, (COVDART_DEEP_ROWS,), generator=g,
                            device=dev, dtype=torch.int32)
        for k, e in check_hist(bins10, g10, rel, N, 256,
                               f"category codes n={COVDART_DEEP_ROWS} "
                               f"N={N}").items():
            errs[k] = max(errs.get(k, 0.0), e)
    log(f"Covertype categorical dart depth 10 on {COVDART_DEEP_ROWS} rows: "
        f"launches {c10}; {sum(split_kinds(deep))} categorical splits")
    return runs + [c10], errs, k1_errs, k2, s_round, busy


# the HIGGS-shape training of the main path (``main`` and ``model_digests``)
# ---- BASELINE.json config #3: rank:ndcg LambdaMART at the MSLR-WEB30K shape --

# MSLR-WEB30K: 3,771,125 documents x 136 features in 31,531 queries (the
# longest 1,251 documents); Fold1 trains on 18,919 queries and holds out
# 6,306 for validation and 6,306 for test. Labels 0-4, most 0 and 1.
MSLR_FEATURES = 136
MSLR_TRAIN_QUERIES = 18_919
MSLR_TEST_QUERIES = 6_306
MSLR_MEAN_DOCS = 3_771_125 / 31_531
MSLR_MAX_DOCS = 1_251
MSLR_LABEL_SHARE = (0.514, 0.325, 0.134, 0.019, 0.008)
# the repo's MSLR-shape settings (bench.py bench_rank_unbiased, BASELINE.md
# row #3) with the reference's pair defaults
MSLR_PARAMS = {"objective": "rank:ndcg", "tree_method": "hist",
               "max_bin": 256, "lambdarank_pair_method": "mean",
               "lambdarank_num_pair_per_sample": 1, "ndcg_exp_gain": True,
               "max_depth": 6, "eta": 0.3,
               "eval_metric": ["ndcg@10", "map@10"]}
MSLR_ROUNDS = 30
MSLR_LEVELS = ((1, False), (2, False), (4, False), (8, False), (16, False),
               (32, False), (16, True), (32, True))
# bench.py's rank shape: 200,000 x 136 in 800 queries of 250
RANK_BENCH_ROWS = 200_000
RANK_BENCH_QUERIES = 800
HIST_KERNEL_NAMES = ("scan_count", "scan_scatter", "level_plan", "hist_tiles",
                     "combine_partials", "fold_partials")


def mslr_like(seed):
    """Features [n, 136] f32 N(0, 1), labels [n] and query sizes of
    18,919 + 6,306 queries (MSLR-WEB30K Fold1's training and test
    queries), made from ``seed``: sizes log-normal with MSLR's mean
    (~119.6), at most 1,251, the longest training query exactly 1,251;
    labels 0-4 in ``MSLR_LABEL_SHARE`` by the rank of a hidden linear
    score plus noise within each query."""
    rng = np.random.default_rng(seed)
    G = MSLR_TRAIN_QUERIES + MSLR_TEST_QUERIES
    sigma = 0.7
    sizes = np.clip(np.rint(rng.lognormal(
        np.log(MSLR_MEAN_DOCS) - sigma * sigma / 2, sigma, G)), 1,
        MSLR_MAX_DOCS).astype(np.int64)
    sizes[int(np.argmax(sizes[:MSLR_TRAIN_QUERIES]))] = MSLR_MAX_DOCS
    n = int(sizes.sum())
    X = rng.standard_normal((n, MSLR_FEATURES), dtype=np.float32)
    w = rng.standard_normal(MSLR_FEATURES).astype(np.float32)
    score = X @ w + 4.0 * rng.standard_normal(n).astype(np.float32)
    qid = np.repeat(np.arange(G), sizes)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    order = np.lexsort((score, qid))        # by query, score ascending
    frac = (np.arange(n) - ptr[qid] + 0.5) / sizes[qid]
    y = np.empty(n, np.float32)
    y[order] = np.searchsorted(np.cumsum(MSLR_LABEL_SHARE)[:-1], frac)
    return X, y, sizes


def rank_bench_like(seed):
    """bench.py's rank inputs: [200,000, 136] f32 N(0, 1), labels 0-4 at
    the 0.55 / 0.75 / 0.9 / 0.97 quantiles of a linear score, 800 queries
    of 250 rows."""
    rng = np.random.RandomState(seed)
    X = rng.randn(RANK_BENCH_ROWS, MSLR_FEATURES).astype(np.float32)
    score = X @ rng.randn(MSLR_FEATURES).astype(np.float32)
    y = np.digitize(score, np.quantile(score, [0.55, 0.75, 0.9, 0.97]))
    qid = np.repeat(np.arange(RANK_BENCH_QUERIES),
                    RANK_BENCH_ROWS // RANK_BENCH_QUERIES)
    return X, y.astype(np.float32), qid


def mslr_ranking(xt, dev):
    """The ``mslr_ranking`` phase (module docstring): returns (the
    main-path runs' launch counts, {kernel: max |kernel - plain|}, K1's
    errors, the histogram kernels' times at 136 features, a summary)."""
    from xgboost_tpu_torch.metric import get_metric
    from xgboost_tpu_torch.objective.ranking import MEAN_DRAWS
    from xgboost_tpu_torch.serve.packed import PackedForest

    t0 = time.perf_counter()
    X, y, sizes = mslr_like(seed=5)
    sz_tr = sizes[:MSLR_TRAIN_QUERIES]
    n_tr = int(sz_tr.sum())
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr], group=sz_tr)
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:],
                     group=sizes[MSLR_TRAIN_QUERIES:])
    if int(sz_tr.max()) != MSLR_MAX_DOCS or \
            dtr.get_group().shape != (MSLR_TRAIN_QUERIES,):
        raise AssertionError("the MSLR-shape queries miss Fold1's shape")
    log(f"mslr_ranking: {n_tr} training rows x {MSLR_FEATURES} in "
        f"{MSLR_TRAIN_QUERIES} queries (mean {sz_tr.mean():.2f}, median "
        f"{np.median(sz_tr):.0f}, longest {sz_tr.max()}), {len(y) - n_tr} "
        f"held out in {MSLR_TEST_QUERIES}; label counts "
        f"{np.bincount(y.astype(np.int64)).tolist()}; made in "
        f"{time.perf_counter() - t0:.2f} s (host)")

    # K2, K3 and K4 over the training matrix's bins at 136 features: the
    # levels of 1 to 32 nodes, uniform and skewed, bit for bit
    t0 = time.perf_counter()
    bins = dtr.binned(MSLR_PARAMS["max_bin"], dev).bins
    if bins.shape != (n_tr, MSLR_FEATURES) or bins.dtype != torch.uint8:
        raise AssertionError(f"MSLR bins {bins.shape} {bins.dtype}")
    log(f"MSLR sketch and bins: {time.perf_counter() - t0:.2f} s (host "
        f"clock)")
    hist_errs = {}
    for i, (N, skew) in enumerate(MSLR_LEVELS):
        _, gpair, rel = hist_inputs(n_tr, 1, 256, N, dev, seed=200 + i,
                                    skew=skew)
        label = f"MSLR n={n_tr} N={N} F=136{' skewed' if skew else ''}"
        for k, e in check_hist(bins, gpair, rel, N, 256, label).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del gpair, rel
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    hist_times = {}
    for N in (1, 32):
        _, gpair, rel = hist_inputs(n_tr, 1, 256, N, dev, seed=220 + N)
        t, n_active = time_hist(bins, gpair, rel, N, 256, flush)
        for name, (ms, plain_ms, lib_ms) in t.items():
            planes = 2 if name in k3_precisions() else 4
            bound = hist_bound_ms(bins, N, 256, n_active, planes)
            hist_times[(name, N)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n={n_tr} N={N} B=256 x 136 u8 (L2 flushed): "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
                f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), "
                f"kernel at {bound[0] / ms * 100:.4f}% of it")
        del gpair, rel
    del bins, flush

    # the main path, twice: 30 rounds with the held-out queries evaluated
    # every round
    runs, raws = [], []
    for run in range(2):
        res = {}
        t0 = time.perf_counter()
        bst, c = train_launches(f"train MSLR run {run}", lambda r=res:
                                xt.train(MSLR_PARAMS, dtr, MSLR_ROUNDS,
                                         evals=[(dte, "test")],
                                         evals_result=r, verbose_eval=10))
        t_run = time.perf_counter() - t0
        depth = MSLR_PARAMS["max_depth"]
        if c["hist_scan"] != depth * MSLR_ROUNDS or c["hist_int8x2"] != 0 \
                or c["hist_f32"] != 0 or c["fused_advance_coarse"] != 0:
            raise AssertionError(f"MSLR training launched {c}, expected K4 "
                                 f"{depth} times a round")
        if c["walk_packed"] != MSLR_ROUNDS or \
                c["walk_staged"] != MSLR_ROUNDS:
            raise AssertionError(f"MSLR's held-out walks launched {c}, "
                                 "expected K1 staged once a round")
        runs.append(c)
        raws.append(saved_bytes(bst))
        log(f"train MSLR run {run}: {MSLR_ROUNDS} rounds in {t_run:.3f} s "
            f"(host clock, sketch and binning included on run 0); launches "
            f"a round: K4 {c['hist_scan'] / MSLR_ROUNDS:g}, K2 "
            f"{c['hist_int8x2'] / MSLR_ROUNDS:g}, K1 "
            f"{c['walk_packed'] / MSLR_ROUNDS:g}")
    digests = [hashlib.sha256(r).hexdigest() for r in raws]
    if digests[0] != digests[1]:
        raise AssertionError(f"two MSLR runs saved different models: "
                             f"{digests}")
    nd, mp = res["test"]["ndcg@10"], res["test"]["map@10"]
    if not nd[-1] > nd[0]:
        raise AssertionError(f"held-out ndcg@10 did not rise: {nd}")
    p_te = bst.predict(dte)
    if p_te.shape != (len(y) - n_tr,) or not np.isfinite(p_te).all() or \
            abs(get_metric("ndcg@10")(p_te, dte.info) - nd[-1]) > 1e-6:
        raise AssertionError("Booster.predict disagrees with the eval line")
    log(f"MSLR held-out: ndcg@10 {nd[0]} (round 1) -> {nd[-1]} (round "
        f"{MSLR_ROUNDS}), map@10 {mp[0]} -> {mp[-1]}; model sha256 (two "
        f"runs) {digests[0]} {digests[1]}")

    # seconds a round, three profiled rounds, and the gradient alone
    timer, per, mslr_s = seconds_per_round(MSLR_PARAMS, dtr)
    log(f"MSLR seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per]}; median of rounds 1-5 {mslr_s:.6f} s")
    busy, rows = profile_rounds("MSLR rank:ndcg", timer, dtr, top=16)
    hist_ms = sum(e.self_device_time_total for e in rows
                  if any(k in e.key for k in HIST_KERNEL_NAMES)) / 1e3
    st = timer._state_of(dtr, is_train=True)
    margin = timer._cached_margin(dtr, is_train=True)

    def gradient(it):
        return timer.obj.get_gradient(margin, st["labels"], st["weights"],
                                      it, group_ptr=dtr.info.group_ptr)

    host = []
    for it in range(9, 15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gradient(it)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(15, 18):
            gradient(it)
        torch.cuda.synchronize()
    grad_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 3e3
    G, L = MSLR_TRAIN_QUERIES, MSLR_MAX_DOCS
    chunk = max(1, min(G, MEAN_DRAWS // L))
    slots = -(-G // chunk) * chunk * L
    pad = 1.0 - n_tr / slots
    host_ms = float(np.median(host[1:])) * 1e3
    log(f"MSLR LambdaRank gradient: device {grad_ms:.3f} ms a round (3 "
        f"calls under torch.profiler), host {host_ms:.3f} ms a call "
        f"(median of 5, ending in a sync); [{-(-G // chunk)} x "
        f"{chunk} queries, {L}] padded layout, {slots} slots for {n_tr} "
        f"rows: pad share {pad:.4f}; histogram kernels {hist_ms / 3:.3f} ms "
        f"a round; device busy {busy / 3:.3f} ms a round")

    # K1 on the ranking forest, held to its fold replica
    Xte = torch.from_numpy(np.ascontiguousarray(X[n_tr:])).to(dev)
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    k1_errs = [check_kernel(f"MSLR forest n={n}", pf, Xte[:n].contiguous(),
                            base, sch)[0]
               for n, sch in ((512, "spread"), (100_000, "staged"))]
    del Xte, X, dtr, dte

    # bench.py's rank shape: the other pair methods, unbiased, the other
    # two objectives, two rounds each
    Xb, yb, qid = rank_bench_like(seed=0)
    db = xt.DMatrix(Xb, label=yb, qid=qid)
    dbin = xt.DMatrix(Xb, label=(yb >= 2).astype(np.float32), qid=qid)
    variants = (("topk k=0", {"lambdarank_pair_method": "topk",
                              "lambdarank_num_pair_per_sample": 0}, db),
                ("topk k=8", {"lambdarank_pair_method": "topk",
                              "lambdarank_num_pair_per_sample": 8}, db),
                ("unbiased mean", {"lambdarank_unbiased": True}, db),
                ("unbiased topk k=8", {"lambdarank_pair_method": "topk",
                                       "lambdarank_num_pair_per_sample": 8,
                                       "lambdarank_unbiased": True}, db),
                ("rank:pairwise", {"objective": "rank:pairwise"}, db),
                ("rank:map", {"objective": "rank:map"}, dbin))
    unbiased = None
    for label, extra, dm in variants:
        r = {}
        b, c = train_launches(f"rank {label}", lambda e=extra, d=dm, r=r:
                              xt.train(dict(MSLR_PARAMS, **e), d, 2,
                                       evals=[(d, "train")], evals_result=r,
                                       verbose_eval=False))
        runs.append(c)
        if c["hist_scan"] != 12:
            raise AssertionError(f"rank {label} launched {c}")
        nd2 = r["train"]["ndcg@10"]
        if not (np.isfinite(nd2).all() and nd2[1] >= nd2[0] - 1e-3):
            raise AssertionError(f"rank {label}: ndcg@10 {nd2}")
        msg = f"rank {label} at 200,000 x 136, 800 queries: ndcg@10 {nd2}"
        if extra.get("lambdarank_unbiased"):
            ti, tj = b.obj.ti_plus, b.obj.tj_minus
            if not (np.isfinite(ti).all() and np.isfinite(tj).all()
                    and ti[0] == 1.0 and not np.allclose(ti, 1.0)):
                raise AssertionError(f"rank {label}: ti+ {ti}")
            msg += (f"; after round 2 ti+[:6] {np.round(ti[:6], 6).tolist()}"
                    f" tj-[:6] {np.round(tj[:6], 6).tolist()} ({len(ti)} "
                    f"positions)")
            if unbiased is None:
                unbiased = b
        log(msg)
    again = xt.Booster(model_file=unbiased.save_raw("ubj"))
    if not (np.array_equal(again.predict(db), unbiased.predict(db))
            and np.array_equal(again.obj.ti_plus, unbiased.obj.ti_plus)
            and np.array_equal(again.obj.tj_minus, unbiased.obj.tj_minus)):
        raise AssertionError("the unbiased model's save/load round trip "
                             "differs")
    log("the unbiased model's save_raw round trip predicts the same bits "
        "and keeps ti+ / tj-")
    summary = {"s_round": mslr_s, "busy_ms": busy, "grad_ms": grad_ms,
               "pad": pad, "ndcg": (nd[0], nd[-1]), "hist_ms": hist_ms / 3}
    return runs, hist_errs, k1_errs, hist_times, summary


AGARICUS_TRAIN_ROWS = 6_513
AGARICUS_TEST_ROWS = 1_611
AGARICUS_PARSE_ROWS = 200_000
# the agaricus demos' settings (demo/guide-python basic_walkthrough.py);
# BASELINE config #1 is reg:squarederror with rmse
AGARICUS_PARAMS = {"max_depth": 2, "eta": 1.0}
AGARICUS_RUNS = (("binary:logistic", "error"), ("reg:squarederror", "rmse"))
AGARICUS_ROUNDS = 2


def agaricus_like(seed, directory):
    """Writes ``agaricus.txt.train`` (6,513 rows) and ``agaricus.txt.test``
    (1,611 rows) into ``directory`` as XGBoost's demo files have them: a
    label and 22 sorted ``idx:1`` entries a line, one a UCI Mushroom
    attribute (``testing.MUSHROOM_CARDINALITIES``: 6, 4, 10, 2, 9, 4, 3,
    2, 12, 2, 7, 4, 4, 9, 9, 2, 4, 3, 8, 9, 6, 7, summing to 126), so
    indices run 1-126 and column 0 is never present; labels from a hidden
    rule on the odor and the spore-print color with 2% flipped
    (``testing.agaricus_rows``), made from ``seed``. Returns the two
    paths."""
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    y, idx = agaricus_rows(AGARICUS_TRAIN_ROWS + AGARICUS_TEST_ROWS, seed)
    paths = []
    for name, rows in (("train", slice(0, AGARICUS_TRAIN_ROWS)),
                       ("test", slice(AGARICUS_TRAIN_ROWS, None))):
        path = os.path.join(directory, f"agaricus.txt.{name}")
        write_libsvm(path, y[rows], idx[rows])
        paths.append(path)
    return paths


def same_structure(a, b, label):
    """The tests' ``compare_tree`` rule where no near tie is allowed: the
    same nodes, splits (feature, bin, default direction), leaves within
    rtol 1e-5 plus 1e-4 and gains within 2e-4 of their scale."""
    if a.num_nodes() != b.num_nodes() or not (
            np.array_equal(a.is_leaf, b.is_leaf)
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.split_bin, b.split_bin)
            and np.array_equal(a.default_left[~a.is_leaf],
                               b.default_left[~b.is_leaf])):
        raise AssertionError(f"{label}: the trees split differently")
    if not (np.allclose(a.leaf_value, b.leaf_value, rtol=1e-5, atol=1e-4)
            and np.allclose(a.gain, b.gain, rtol=2e-4, atol=2e-4)):
        raise AssertionError(f"{label}: leaves or gains differ")


def card_cpu_gap(card, cpu, label):
    """The card's trees against the CPU port's from the same inputs: the
    same structure (``same_structure``) and every float field within
    rtol 1e-5 plus 1e-5 (the f32 sums over rows run in another order on
    each device); returns {field: largest |difference|} of the fields
    (and the base margin) that differ."""
    gaps = {}
    pairs = list(zip(card.gbm.trees, cpu.gbm.trees))
    for r, (a, b) in enumerate(pairs):
        same_structure(a, b, f"{label} tree {r}")
    fields = [(f, [(getattr(a, f), getattr(b, f)) for a, b in pairs])
              for f in ("leaf_value", "split_value", "sum_hess", "gain",
                        "base_weight")]
    fields.append(("base_score", [(card._base_np(), cpu._base_np())]))
    for f, arrays in fields:
        if not all(np.allclose(x, y, rtol=1e-5, atol=1e-5)
                   for x, y in arrays):
            raise AssertionError(f"{label}: {f} differs on the card")
        g = max(float(np.max(np.abs(x.astype(np.float64) - y)))
                for x, y in arrays)
        if g > 0:
            gaps[f] = g
    return gaps


def agaricus_walkthrough(xt, dev, tmp):
    """The ``agaricus_walkthrough`` phase (BASELINE config #1 and the
    agaricus demos, module docstring): returns (the main-path runs'
    launch counts, K2's max |kernel - plain|, K1's errors, the K2 and K1
    timings, a summary)."""
    import scipy.sparse

    train_path, test_path = agaricus_like(seed=6, directory=tmp)
    t0 = time.perf_counter()
    dtr = xt.DMatrix(train_path + "?format=libsvm")
    load_s = time.perf_counter() - t0
    dte = xt.DMatrix(test_path + "?format=libsvm")
    if dtr.shape != (AGARICUS_TRAIN_ROWS, 127) or \
            dte.shape != (AGARICUS_TEST_ROWS, 127) or \
            not np.isnan(dtr.X[:, 0]).all() or \
            dtr.num_nonmissing() != 22 * AGARICUS_TRAIN_ROWS:
        raise AssertionError(f"agaricus shape: {dtr.shape} {dte.shape}")
    # the parse rate on a 200,000-row file of the same widths
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    big = os.path.join(tmp, "agaricus_200k.txt")
    write_libsvm(big, *agaricus_rows(AGARICUS_PARSE_ROWS, seed=7))
    t0 = time.perf_counter()
    dbig = xt.DMatrix(big + "?format=libsvm")
    parse_s = time.perf_counter() - t0
    if dbig.shape != (AGARICUS_PARSE_ROWS, 127):
        raise AssertionError(f"200k-row file: {dbig.shape}")
    del dbig
    log(f"agaricus_walkthrough: DMatrix(path) {load_s:.6f} s for the "
        f"{AGARICUS_TRAIN_ROWS}-row file (host clock); {AGARICUS_PARSE_ROWS}"
        f"-row file of the same widths in {parse_s:.6f} s = "
        f"{AGARICUS_PARSE_ROWS / parse_s:.1f} rows/s; positive share "
        f"{float(dtr.get_label().mean()):.4f} (train), "
        f"{float(dte.get_label().mean()):.4f} (test)")

    # K2 over the training bins at F = 127, B = 2 and the levels N = 1, 2
    bins = dtr.binned(256, dev).bins
    B = dtr.binned(256, dev).max_nbins
    if bins.shape != (AGARICUS_TRAIN_ROWS, 127) or B != 2:
        raise AssertionError(f"agaricus bins {bins.shape}, {B} slots")
    k2_err = 0.0
    for N in (1, 2):
        _, gpair, rel = hist_inputs(AGARICUS_TRAIN_ROWS, 1, B, N, dev,
                                    seed=300 + N)
        errs = check_hist(bins, gpair, rel, N, B, f"agaricus n="
                          f"{AGARICUS_TRAIN_ROWS} N={N} F=127",
                          only=("hist_int8x2",))
        k2_err = max(k2_err, errs["hist_int8x2"])
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    _, gpair, rel = hist_inputs(AGARICUS_TRAIN_ROWS, 1, B, 2, dev, seed=310)
    t, n_active = time_hist(bins, gpair, rel, 2, B, flush,
                            only=("hist_int8x2",))
    ms, plain_ms, lib_ms = t["hist_int8x2"]
    bound = hist_bound_ms(bins, 2, B, n_active, 4)
    k2_time = (ms, plain_ms, lib_ms, bound)
    log(f"hist hist_int8x2 n={AGARICUS_TRAIN_ROWS} N=2 B={B} x 127 u8 (L2 "
        f"flushed): {ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
        f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), kernel at "
        f"{bound[0] / ms * 100:.4f}% of it")
    del gpair, rel

    # runs 1 and 2, twice each: the demo's settings, both eval sets
    runs, models, results, digests = [], {}, {}, {}
    for objective, metric in AGARICUS_RUNS:
        p = dict(AGARICUS_PARAMS, objective=objective, eval_metric=metric)
        raws = []
        for run in range(2):
            res = {}
            bst, c = train_launches(
                f"train agaricus {objective} run {run}", lambda r=res, p=p:
                xt.train(p, dtr, AGARICUS_ROUNDS,
                         evals=[(dtr, "train"), (dte, "eval")],
                         evals_result=r, verbose_eval=False))
            if c["hist_int8x2"] != 2 * AGARICUS_ROUNDS or \
                    c["hist_scan"] != 0 or c["hist_f32"] != 0 or \
                    c["walk_packed"] != AGARICUS_ROUNDS:
                raise AssertionError(f"agaricus {objective} launched {c}, "
                                     "expected K2 twice and K1 once a round")
            runs.append(c)
            raws.append(saved_bytes(bst))
        digests[objective] = [hashlib.sha256(r).hexdigest() for r in raws]
        if digests[objective][0] != digests[objective][1]:
            raise AssertionError(f"two agaricus {objective} runs saved "
                                 f"different models: {digests[objective]}")
        ev = res["eval"][metric]
        if not (np.isfinite(ev).all() and ev[-1] < ev[0]):
            raise AssertionError(f"agaricus {objective}: held-out {metric} "
                                 f"{ev}")
        models[objective], results[objective] = bst, res
        cpu = xt.train(dict(p, device="cpu"), dtr, AGARICUS_ROUNDS,
                       verbose_eval=False)
        gaps = card_cpu_gap(bst, cpu, f"agaricus {objective}")
        cpu_sha = hashlib.sha256(saved_bytes(cpu)).hexdigest()
        same = "equal" if cpu_sha == digests[objective][0] else "differ"
        log(f"agaricus {objective}: the card's trees are the CPU port's "
            f"node for node; fields that differ (largest |difference|): "
            f"{gaps or 'none'}; CPU model sha256 {cpu_sha} (the card's "
            f"bytes {same})")
        log(f"agaricus {objective}: train-{metric} {res['train'][metric]}, "
            f"eval-{metric} {ev}; model sha256 (two runs) "
            f"{digests[objective][0]} {digests[objective][1]}")
    bst = models["binary:logistic"]

    # 3. predict, save_model and a Booster from the file
    preds = bst.predict(dte)
    model_path = os.path.join(tmp, "0001.model.json")
    bst.save_model(model_path)
    if preds.shape != (AGARICUS_TEST_ROWS,) or \
            not np.isfinite(preds).all() or not np.array_equal(
                xt.Booster(model_file=model_path).predict(dte), preds):
        raise AssertionError("the saved agaricus model predicts otherwise")
    err = float(np.mean((preds > 0.5) != dte.get_label()))
    if abs(err - results["binary:logistic"]["eval"]["error"][-1]) > 1e-6:
        raise AssertionError(f"predict's error {err} is not the eval line's")
    # 4. dump_model, text and json
    bst.dump_model(os.path.join(tmp, "dump.raw.txt"))
    bst.dump_model(os.path.join(tmp, "dump.json"), dump_format="json",
                   with_stats=True)
    with open(os.path.join(tmp, "dump.raw.txt")) as fh:
        text = fh.read()
    with open(os.path.join(tmp, "dump.json")) as fh:
        dumped = json.load(fh)
    if text.count("booster[") != AGARICUS_ROUNDS or \
            len(dumped) != AGARICUS_ROUNDS or "cover" not in dumped[0]:
        raise AssertionError("agaricus dump_model")
    # 5. the test matrix through save_binary
    dte.save_binary(os.path.join(tmp, "dtest.buffer"))
    if not np.array_equal(bst.predict(xt.DMatrix(
            os.path.join(tmp, "dtest.buffer"))), preds):
        raise AssertionError("DMatrix(binary) predicts otherwise")
    # 6. scipy CSR, CSC and numpy
    Xte = dte.X
    csr = scipy.sparse.csr_matrix(np.nan_to_num(Xte))
    csr.eliminate_zeros()
    for label, data in (("CSR", csr), ("CSC", csr.tocsc()),
                        ("numpy", Xte.copy())):
        if not np.array_equal(bst.predict(xt.DMatrix(data)), preds):
            raise AssertionError(f"agaricus from {label} predicts otherwise")
    # 7. boost from prediction: one round from the 2-round margins, against
    # the third round of a 3-round model
    p1 = dict(AGARICUS_PARAMS, objective="binary:logistic",
              eval_metric="error")
    res3 = {}
    xt.train(p1, dtr, 3, evals=[(dtr, "train"), (dte, "eval")],
             evals_result=res3, verbose_eval=False)
    dtr_m = xt.DMatrix(train_path + "?format=libsvm")
    dte_m = xt.DMatrix(test_path + "?format=libsvm")
    dtr_m.set_base_margin(bst.predict(dtr, output_margin=True))
    dte_m.set_base_margin(bst.predict(dte, output_margin=True))
    res1 = {}
    xt.train(p1, dtr_m, 1, evals=[(dtr_m, "train"), (dte_m, "eval")],
             evals_result=res1, verbose_eval=False)
    for data in ("train", "eval"):
        if abs(res1[data]["error"][0] - res3[data]["error"][2]) > 1e-6:
            raise AssertionError(f"boost from prediction: {res1} vs {res3}")
    # 8. the first round alone
    first = bst.predict(dte, iteration_range=(0, 1))
    if not np.array_equal(first, bst[0:1].predict(dte)) or \
            np.array_equal(first, preds):
        raise AssertionError("iteration_range=(0, 1)")
    # 9. leaf indices, against the CPU port on the same model
    leaf = bst.predict(dte, pred_leaf=True)
    cpu_bst = xt.Booster({"device": "cpu"}, model_file=model_path)
    if leaf.shape != (AGARICUS_TEST_ROWS, AGARICUS_ROUNDS) or \
            leaf.dtype != np.int32 or not all(
                bst.gbm.trees[t].is_leaf[leaf[:, t]].all()
                for t in range(AGARICUS_ROUNDS)) or \
            not np.array_equal(leaf, cpu_bst.predict(dte, pred_leaf=True)):
        raise AssertionError("pred_leaf")

    # 10. the demo's custom logistic objective and metric
    def logregobj(margin, dm):
        prob = 1.0 / (1.0 + np.exp(-margin))
        return prob - dm.get_label(), prob * (1.0 - prob)

    def evalerror(margin, dm):
        return "my-error", float(np.mean((margin > 0.0) != dm.get_label()))

    res_c = {}
    custom, c = train_launches(
        "train agaricus custom objective", lambda:
        xt.train(dict(p1), dtr, AGARICUS_ROUNDS, obj=logregobj,
                 custom_metric=evalerror,
                 evals=[(dtr, "train"), (dte, "eval")], evals_result=res_c,
                 verbose_eval=False))
    runs.append(c)
    for r, (a, b) in enumerate(zip(bst.gbm.trees, custom.gbm.trees)):
        same_structure(a, b, f"custom objective round {r}")
    if res_c["eval"]["my-error"] != results["binary:logistic"]["eval"][
            "error"]:
        raise AssertionError(f"custom metric {res_c}")
    # 11. process_type=update: run 1's model refreshed and pruned against
    # the CPU port's (host float64 sums of gradients from margins walked by
    # K1 on the card, by the plain walk on the CPU), run 2's refreshed
    refreshed = {}
    for objective, updater in (("binary:logistic", "refresh,prune"),
                               ("reg:squarederror", "refresh")):
        raw = saved_bytes(models[objective])
        p = dict(AGARICUS_PARAMS, objective=objective,
                 process_type="update", updater=updater)
        out = {}
        for device in ("cuda", "cpu"):
            start = xt.Booster({"device": device}, model_file=raw)
            out[device] = xt.train(dict(p, device=device), dtr,
                                   AGARICUS_ROUNDS, xgb_model=start,
                                   verbose_eval=False)
        a, b = out["cuda"], out["cpu"]
        if a.num_boosted_rounds() != AGARICUS_ROUNDS:
            raise AssertionError(f"update: {a.num_boosted_rounds()} rounds")
        gap = max(float(np.max(np.abs(x.sum_hess - y.sum_hess)
                               / np.maximum(np.abs(y.sum_hess), 1e-30)))
                  for x, y in zip(a.gbm.trees, b.gbm.trees))
        exact = objective == "reg:squarederror"
        if (exact and saved_bytes(a) != saved_bytes(b)) or gap > 1e-6:
            raise AssertionError(f"update {updater} on {objective}: sum_hess "
                                 f"{gap} from the CPU's")
        refreshed[objective] = gap
    # 12. the reference-schema writer and reader
    ref_path = os.path.join(tmp, "agaricus.ubj")
    xt.save_xgboost_model(bst, ref_path)
    if not np.allclose(xt.load_xgboost_model(ref_path).predict(dte), preds,
                       rtol=1e-6, atol=1e-7):
        raise AssertionError("save_xgboost_model / load_xgboost_model")
    log(f"agaricus runs 3-12: save/load, dump_model ({len(text)} bytes of "
        f"text), DMatrix(binary), CSR / CSC / numpy the same predictions; "
        f"boost from prediction eval-error {res1['eval']['error'][0]} = the "
        f"3-round model's {res3['eval']['error'][2]}; iteration_range (0, 1)"
        f"; pred_leaf {leaf.shape} equal to the CPU's; the custom objective's"
        f" trees are run 1's; process_type=update refresh,prune sum_hess "
        f"within {refreshed['binary:logistic']:.3e} of the CPU's, refresh on"
        f" the rmse model the CPU's bytes; the reference-schema file "
        f"predicts the same")

    # seconds a round and three profiled rounds (binary:logistic)
    timer, per, s_round = seconds_per_round(
        dict(AGARICUS_PARAMS, objective="binary:logistic"), dtr)
    log(f"agaricus seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per]}; median of rounds 1-5 {s_round:.6f} s")
    busy, _ = profile_rounds("agaricus binary:logistic", timer, dtr)

    # K1 on the agaricus forest at the 1,611 test rows
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    Xd = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    k1_err, _, schedule = check_kernel(
        f"agaricus forest n={AGARICUS_TEST_ROWS}", pf, Xd, base)
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
    from xgboost_tpu_torch.serve.packed import tree_step

    d = pf.device_arrays(dev)
    _, leaves = pf.margin(Xd, base, leaf_index=True)
    depth = torch.from_numpy(node_depths(pf)).to(dev)
    k1_time = {
        "ms": event_ms(lambda: pf.margin(Xd, base), reps=200),
        "plain_ms": event_ms(lambda: walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], Xd, base, max_depth=pf.max_depth,
            tree_chunk=tree_step(AGARICUS_TEST_ROWS)), reps=50),
        "bound": walk_bound_ms(pf, AGARICUS_TEST_ROWS, 127, int(
            depth[leaves.long()].sum())),
        "schedule": schedule}
    log(f"K1 agaricus forest {AGARICUS_TEST_ROWS} rows ({schedule}, L2 "
        f"warm): {k1_time['ms']:.6f} ms, plain {k1_time['plain_ms']:.6f} "
        f"ms, bound {k1_time['bound'][0]:.6f} ms ({k1_time['bound'][1]})")
    per_round = {k: runs[0][k] / AGARICUS_ROUNDS
                 for k in ("hist_int8x2", "walk_packed")}
    summary = {"load_s": load_s, "parse_rows_per_s":
               AGARICUS_PARSE_ROWS / parse_s, "s_round": s_round,
               "busy_ms": busy, "error": results["binary:logistic"]["eval"][
                   "error"][-1],
               "rmse": results["reg:squarederror"]["eval"]["rmse"][-1],
               "digests": digests, "per_round": per_round}
    log(f"agaricus_walkthrough: held-out error {summary['error']} and rmse "
        f"{summary['rmse']} at {AGARICUS_ROUNDS} rounds; K2 "
        f"{per_round['hist_int8x2']:g} and K1 {per_round['walk_packed']:g} "
        f"launches a round")
    return runs, k2_err, k1_err, k2_time, k1_time, summary


HIGGS_PARAMS = {"objective": "binary:logistic", "max_depth": 8, "eta": 0.1,
                "max_bin": 256}


def digest(bst) -> str:
    """sha256 of :func:`saved_bytes`."""
    return hashlib.sha256(saved_bytes(bst)).hexdigest()


def model_digests():
    """:func:`digest` of the HIGGS-shape models the main path trains
    (``auto`` 20 rounds, ``scan`` 10 rounds, evaluated on the training and
    100,000 held-out rows), through the calls every version has, so that
    two trees' model bytes compare in one run."""
    import xgboost_tpu_torch as xt

    X, y = higgs_like(1_100_000, 28, seed=0)
    dtr = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    dte = xt.DMatrix(X[1_000_000:], label=y[1_000_000:])
    out = {}
    for method, rounds in (("auto", 20), ("scan", 10)):
        p = dict(HIGGS_PARAMS) if method == "auto" else \
            dict(HIGGS_PARAMS, hist_method=method)
        out[method] = digest(xt.train(p, dtr, rounds,
                                      evals=[(dtr, "train"), (dte, "test")],
                                      verbose_eval=False))
    log(f"model digests: {out}")
    return out


def seconds_per_round(params, dtr):
    """Six ``update`` calls between device syncs on a new booster (host
    clock); returns (the booster, all six times, the median of rounds
    1-5)."""
    import xgboost_tpu_torch as xt

    timer = xt.Booster(params)
    per_round = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.update(dtr, i)
        torch.cuda.synchronize()
        per_round.append(time.perf_counter() - t0)
    return timer, per_round, float(np.median(per_round[1:]))


def profile_rounds(label, timer, dtr, top=12):
    """Three more ``update`` rounds of ``timer`` (after its six timed ones)
    under ``torch.profiler``, timed on the host clock: the device's busy
    time from the kernel rows (an operator's row counts the kernels it
    launched a second time), its idle share, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(6, 9):
            timer.update(dtr, i)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if dev_ms <= 0:
        raise AssertionError("torch.profiler saw no device time")
    log(f"profile of 3 {label} rounds: {wall_prof * 1e3:.3f} ms on the host "
        f"clock (profiler on), device busy {dev_ms:.3f} ms, device idle "
        f"{(1 - dev_ms / (wall_prof * 1e3)) * 100:.2f}% of those rounds; "
        f"kernels by device time:")
    for e in rows[:top]:
        log(f"  {e.key[:70]:70s} n={e.count:5d} device "
            f"{e.self_device_time_total / 1e3:.3f} ms")
    return dev_ms, rows


def higgs_like(n, F, seed):
    """[n, F] f32 N(0, 1) features and 0/1 labels from a fixed linear rule
    plus noise, made from ``seed``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F), dtype=np.float32)
    w = rng.standard_normal(F).astype(np.float32)
    logit = X @ w + rng.standard_normal(n).astype(np.float32) * 1.5
    return X, (logit > 0).astype(np.float32)


# the external-memory phase (``external_memory``): BASELINE.json's
# HIGGS-11M shape streamed from an iterator, 11 batches and pages of
# 1,000,000 rows, four of them in the page cache
EXT_ROWS = 11_000_000
EXT_BATCH_ROWS = 1_000_000
EXT_TEST_ROWS = 100_000
EXT_ROUNDS = 10
EXT_U4_ROUNDS = 5
EXT_DEEP_ROWS = 2_000_000
EXT_DEEP_DEPTH = 10
EXT_CACHED_PAGES = 4
EXT_SEED = 11


def higgs_batch(seed, i, m, F):
    """Batch ``i`` of ``m`` rows of ``higgs_like``'s rule (N(0, 1)
    features, labels from a fixed linear rule plus noise), the rule's
    weights from ``seed`` and the batch's draws from (seed, i)."""
    w = np.random.default_rng(seed).standard_normal(F).astype(np.float32)
    rng = np.random.default_rng([seed, i])
    X = rng.standard_normal((m, F), dtype=np.float32)
    logit = X @ w + rng.standard_normal(m).astype(np.float32) * 1.5
    return X, (logit > 0).astype(np.float32)


def higgs_batches(xt, n_rows, F, cache_prefix, seed=EXT_SEED):
    """A ``DataIter`` over the first ``n_rows`` rows of ``higgs_batch``'s
    stream, ``EXT_BATCH_ROWS`` a batch, made anew on every pass (the raw
    matrix never exists whole)."""

    class Batches(xt.DataIter):
        def __init__(self):
            super().__init__(cache_prefix)
            self.i = 0

        def next(self, input_data):
            s = self.i * EXT_BATCH_ROWS
            if s >= n_rows:
                return 0
            X, y = higgs_batch(seed, self.i, min(EXT_BATCH_ROWS, n_rows - s),
                               F)
            input_data(data=X, label=y)
            self.i += 1
            return 1

        def reset(self):
            self.i = 0

    return Batches()


def xtpu_env():
    """The ``XTPU_*`` settings in force."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("XTPU_")}


def paged_rounds(xt, params, dm, paged, rounds=6):
    """``rounds`` ``update`` calls of a new booster on the paged matrix
    between device syncs (host clock), each with the ring's statistics
    and the kernels' launches reset before it -> (the booster, [(seconds,
    uploads, H2D bytes, overlap, launches)], the launches of all)."""
    timer = xt.Booster(params)
    per, total = [], {}
    for i in range(rounds):
        paged.reset_ring_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.update(dm, i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        st = paged.ring_stats
        per.append((dt, st["uploads"], st["bytes"], paged.streaming_overlap(),
                    {k: v for k, v in c.items() if v}))
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return timer, per, total


def u4_inputs(n, F, N, dev, seed, skew=False):
    """``hist_inputs``' 16-slot ids, u4-packed as the paged tier packs them
    (``PagedBinnedMatrix._pack_host``) -> (packed, ids, gpair, rel)."""
    from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

    bins, gpair, rel = hist_inputs(n, F, 16, N, dev, seed, skew)
    packed = torch.from_numpy(PagedBinnedMatrix._pack_host(
        bins.cpu().numpy())).to(dev)
    return packed, bins, gpair, rel


def u4_kernels(N, F):
    """K2's and K3's ``packed_u4`` bodies at a level of N nodes: (name,
    kernel(packed args), plain version(packed args), the unpacked
    kernel(ids args), maker of the args)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    def int8x2_args(bins, gpair, rel):
        q, inv = H.quantise_int8x2(gpair)
        return q, rel, inv

    def f32_args(bins, gpair, rel):
        qs, inv = H.fixed_point_scale(gpair)
        return gpair, rel, qs, inv

    out = [(f"{name}_u4",
            lambda p, *a, N=N, prec=prec: K.hist_f32_cuda(
                p, *a, N, 16, precision=prec, packed_u4=F),
            lambda p, *a, N=N, prec=prec: H.build_hist_f32_u4_reference(
                p, F, *a, N, 16, precision=prec),
            lambda b, *a, N=N, prec=prec: K.hist_f32_cuda(
                b, *a, N, 16, precision=prec), f32_args)
           for name, prec in k3_precisions().items()]
    if N <= 128:
        out.append((
            "hist_int8x2_u4",
            lambda p, *a: K.hist_int8x2_cuda(p, *a, N, 16, packed_u4=F),
            lambda p, *a: H.build_hist_int8x2_u4_reference(p, F, *a, N, 16),
            lambda b, *a: K.hist_int8x2_cuda(b, *a, N, 16), int8x2_args))
    return out


# (rows, features, nodes, skewed): a 1M-row page at the u4 run's levels
U4_CASES = ((1_000_000, 28, 1, False), (1_000_000, 28, 16, True),
            (1_000_000, 28, 128, False), (1_000_000, 28, 128, True),
            (1_000_000, 28, 512, False), (1_000_000, 28, 512, True),
            (1_000_000, 27, 128, True), (1_000_000, 27, 256, False))


def check_u4(n, F, N, skew, dev, seed):
    """K2-u4 and K3-u4 (three precisions) on a packed page: equal bit for
    bit on two launches to their plain versions and to the same kernel on
    the unpacked ids. Returns {kernel: max |kernel - plain|}."""
    packed, bins, gpair, rel = u4_inputs(n, F, N, dev, seed, skew)
    errs = {}
    for name, kernel, plain, flat, make in u4_kernels(N, F):
        args = make(bins, gpair, rel)
        runs = [kernel(packed, *args) for _ in range(2)]
        want = plain(packed, *args)
        unpacked = flat(bins, *args)
        torch.cuda.synchronize()
        errs[name] = max(float((r - want).abs().max()) for r in runs)
        if not all(torch.equal(r, want) for r in runs) or \
                not torch.equal(unpacked, want):
            raise AssertionError(f"{name} n={n} F={F} N={N}: differs from "
                                 f"its plain version or the unpacked kernel")
    log(f"check u4 n={n} F={F} N={N}{' skewed' if skew else ''}: "
        f"{sorted(errs)} equal their plain versions and the unpacked-page "
        f"kernels bit for bit on two launches")
    return errs


def time_u4(n, F, N, dev, flush, seed):
    """{kernel: (ms, plain_ms, library_ms, bound)} of the u4 bodies at a
    page of n rows and N nodes (L2 flushed): the library call is one
    ``unpack_u4`` and one ``index_add_`` over the unpacked ids (the
    cells prepared beforehand), the decode counted."""
    from xgboost_tpu_torch.ops import histogram as H

    packed, bins, gpair, rel = u4_inputs(n, F, N, dev, seed)
    seg, active = H._segments(bins, rel, N, 16)
    q, _ = H.quantise_int8x2(gpair)
    vals = H.int8x2_planes(q)[active][:, None, :].expand(-1, F, 4).reshape(
        -1, 4)
    acc = torch.zeros((N * F * 16, 4), dtype=torch.int32, device=dev)
    lib_int = event_ms(lambda: (H.unpack_u4(packed, F),
                                acc.index_add_(0, seg, vals)), reps=10,
                       flush=flush)
    del vals, acc
    gv = gpair[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    accf = torch.zeros((N * F * 16, 2), dtype=torch.float32, device=dev)
    lib_f32 = event_ms(lambda: (H.unpack_u4(packed, F),
                                accf.index_add_(0, seg, gv)), reps=10,
                       flush=flush)
    del seg, gv, accf
    out = {}
    for name, kernel, plain, _, make in u4_kernels(N, F):
        args = make(bins, gpair, rel)
        planes = 4 if name == "hist_int8x2_u4" else 2
        out[name] = (
            event_ms(lambda: kernel(packed, *args), reps=20, flush=flush),
            event_ms(lambda: plain(packed, *args), reps=5),
            lib_int if planes == 4 else lib_f32,
            hist_bound_ms(packed, N, 16, int(active.sum()), planes, F=F))
    return out


def external_memory(xt, dev, F, tmp):
    """The external-memory phase: ``xt.train`` on a ``QuantileDMatrix``
    built from an iterator with a ``cache_prefix`` at the HIGGS-11M shape
    (the bins a memmap under ``tmp``, 11 pages of 1,000,000 rows, four in
    the page cache), 10 rounds at depth 8 with K4 on every page and
    level; its ring, launches, seconds and profile a round; model bytes
    under budgets of 0, 4 and 11 pages and across two runs; the u4 run
    (max_bin 16, packed pages, K2-u4) against the same with
    ``XTPU_PAGE_PACK=0``, depth 10 on 2,000,000 rows (K3-u4 at 256 and
    512 nodes) and a round each through ``pallas:bf16x2`` / ``:bf16``;
    ``Booster.predict`` on a paged matrix; the default budget's collapse
    to the resident tier. Returns (the main-path launch counts of every
    run, the device's busy ms over three profiled rounds, seconds a
    round)."""
    from xgboost_tpu_torch.data.binned import BinnedMatrix

    page = EXT_BATCH_ROWS * F                  # u8 bytes of a page
    os.environ.update({"XTPU_PAGED_COLLAPSE": "0",
                       "XTPU_PAGE_CACHE_BYTES": str(EXT_CACHED_PAGES * page)})
    params = dict(HIGGS_PARAMS)
    depth = params["max_depth"]
    t0 = time.perf_counter()
    dm = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b256"),
                            max_bin=256)
    t_build = time.perf_counter() - t0
    paged = dm.binned(256, dev)
    n_pages = -(-EXT_ROWS // EXT_BATCH_ROWS)
    n_streamed = n_pages - EXT_CACHED_PAGES
    if not (dm.is_paged and paged.n_pages() == n_pages and not paged.packed
            and isinstance(paged.bins_host, np.memmap)
            and paged.page_nbytes() == page):
        raise AssertionError("the iterator matrix is not the paged tier")
    Xte, yte = higgs_batch(EXT_SEED, 10_000, EXT_TEST_ROWS, F)
    dte = xt.DMatrix(Xte, label=yte)
    log(f"external memory: iterator matrix of {EXT_ROWS} x {F} built in "
        f"{t_build:.3f} s (sketch of {n_pages} batches, then binning into a "
        f"{paged.bins_host.nbytes} B memmap); {paged.n_pages()} pages of "
        f"{paged.page_nbytes()} B; settings {xtpu_env()}")
    runs = []

    def run(label, p, d, rounds, **kw):
        b, c = train_launches(label, lambda: xt.train(p, d, rounds,
                                                      verbose_eval=False,
                                                      **kw))
        runs.append(c)
        return b, c

    res = {}
    bst, c = run("external memory run 1", params, dm, EXT_ROUNDS,
                 evals=[(dte, "test")], evals_result=res)
    want = {k: 0 for k in c if k.startswith("hist") or k.startswith("fused")}
    want["hist_scan"] = n_pages * depth * EXT_ROUNDS
    if {k: c[k] for k in want} != want or c["walk_packed"] < EXT_ROUNDS:
        raise AssertionError(f"external memory launched {c}, expected K4 "
                             f"{n_pages * depth} times a round (pages x "
                             "levels) and K1 for the held-out evaluation")
    if bst._caches[id(dm)]["binned"] is not paged:
        raise AssertionError("the paged matrix collapsed to the resident tier")
    cached, streamed = paged.cached_split(dev)
    if len(cached) != EXT_CACHED_PAGES or len(streamed) != n_streamed:
        raise AssertionError(f"{len(cached)} pages cached, {len(streamed)} "
                             "streamed")
    ll = res["test"]["logloss"]
    if not (all(b < a for a, b in zip(ll, ll[1:]))):
        raise AssertionError(f"held-out logloss did not fall: {ll}")
    p_te = bst.predict(dte)
    auc_paged = auc(yte, p_te)
    auc_first = auc(yte, bst.predict(dte, iteration_range=(0, 1)))
    log(f"external memory: tier paged (not collapsed), {len(cached)} pages "
        f"cached and {len(streamed)} streamed; held-out logloss {ll[0]} -> "
        f"{ll[-1]}, AUC {auc_first:.6f} -> {auc_paged:.6f} (rounds 1 and "
        f"{EXT_ROUNDS})")
    digests = {"4 pages": digest(bst)}

    # a round: seconds, the ring's uploads and bytes, launches; then three
    # profiled rounds for the device's busy time and idle share
    timer, per, total = paged_rounds(xt, params, dm, paged)
    runs.append(total)
    for i, (dt, ups, nbytes, ov, cnt) in enumerate(per):
        log(f"external memory round {i}: {dt:.6f} s (update + sync, host "
            f"clock), ring uploads {ups}, H2D {nbytes} B, overlap "
            f"{ov if ov is None else round(ov, 6)}, launches {cnt}")
        if ups != (depth + 1) * n_streamed or \
                nbytes != ups * page or \
                cnt.get("hist_scan") != n_pages * depth:
            raise AssertionError(
                f"a warm round did not upload the {n_streamed} streamed pages "
                f"once a pass ({depth + 1} passes) or launch K4 "
                f"{n_pages * depth} times")
    s_round = float(np.median([p[0] for p in per[1:]]))
    ups = (depth + 1) * n_streamed
    log(f"external memory: {s_round:.6f} s a round (median of rounds 1-5); "
        f"{ups} uploads and {ups * page} B of H2D a round")
    reset_counts()
    busy, _ = profile_rounds("external memory", timer, dm, top=12)
    runs.append(read_counts())

    # model bytes under budgets of 0 and 11 pages, and a second run at 4
    for pages in (0, n_pages, EXT_CACHED_PAGES):
        paged.set_cache_budget(pages * page)
        b, _ = run(f"external memory budget {pages} pages", params, dm,
                   EXT_ROUNDS)
        if paged.cached_pages(dev) != pages:
            raise AssertionError(f"budget {pages}: "
                                 f"{paged.cached_pages(dev)} pages cached")
        digests[f"{pages} pages" if pages != EXT_CACHED_PAGES
                else "4 pages, run 2"] = digest(b)
    log(f"external memory model sha256: {digests}")
    if len(set(digests.values())) != 1:
        raise AssertionError("budgets or runs saved different models")

    # the u4 run: max_bin 16, pages packed two ids a byte
    p16 = dict(params, max_bin=16)
    t0 = time.perf_counter()
    dm16 = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b16"),
                              max_bin=16)
    t16 = time.perf_counter() - t0
    paged16 = dm16.binned(16, dev)
    if not paged16.packed or paged16.page_nbytes() != page // 2:
        raise AssertionError("the 16-bin pages are not u4-packed")
    paged16.reset_ring_stats()
    b16, c16 = run("external memory u4", p16, dm16, EXT_U4_ROUNDS)
    if c16["hist_int8x2_u4"] != n_pages * depth * EXT_U4_ROUNDS or \
            c16["hist_int8x2"] or c16["hist_scan"]:
        raise AssertionError(f"the u4 run launched {c16}, expected K2-u4 "
                             f"{n_pages * depth} times a round")
    u4_bytes = paged16.ring_stats["bytes"]
    _, per16, tot16 = paged_rounds(xt, p16, dm16, paged16, rounds=4)
    runs.append(tot16)
    for i, (dt, ups, nbytes, ov, cnt) in enumerate(per16):
        log(f"external memory u4 round {i}: {dt:.6f} s (update + sync, "
            f"host clock), ring uploads {ups}, H2D {nbytes} B, overlap "
            f"{ov if ov is None else round(ov, 6)}, launches {cnt}")
    os.environ["XTPU_PAGE_PACK"] = "0"
    dm16u = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b16u"),
                               max_bin=16, ref=dm16)
    paged16u = dm16u.binned(16, dev)
    del os.environ["XTPU_PAGE_PACK"]
    paged16u.reset_ring_stats()
    b16u, c16u = run("external memory u4, XTPU_PAGE_PACK=0", p16, dm16u,
                     EXT_U4_ROUNDS)
    if paged16u.packed or \
            c16u["hist_int8x2"] != n_pages * depth * EXT_U4_ROUNDS:
        raise AssertionError(f"the unpacked run launched {c16u}")
    if digest(b16) != digest(b16u):
        raise AssertionError("packed and unpacked transport saved different "
                             "models")
    log(f"external memory u4 (max_bin 16, built in {t16:.3f} s, pages of "
        f"{paged16.page_nbytes()} B, {paged16.cached_pages(dev)} cached): "
        f"model sha256 {digest(b16)} equal with XTPU_PAGE_PACK=0 (pages of "
        f"{paged16u.page_nbytes()} B, {paged16u.cached_pages(dev)} cached); "
        f"H2D {u4_bytes} B packed against {paged16u.ring_stats['bytes']} B "
        f"unpacked over {EXT_U4_ROUNDS} rounds")

    # depth 10 on the first 2,000,000 rows: levels of 256 and 512 nodes
    # through K3-u4, and K3-u4's rounded precisions at every level
    dm2 = xt.QuantileDMatrix(higgs_batches(xt, EXT_DEEP_ROWS, F,
                                           f"{tmp}/b16d"), max_bin=16,
                             ref=dm16)
    dd, d_pages = EXT_DEEP_DEPTH, -(-EXT_DEEP_ROWS // EXT_BATCH_ROWS)
    k2, k3 = d_pages * min(dd, 8), d_pages * max(dd - 8, 0)
    b10, c10 = run(f"external memory u4 depth {dd}", dict(p16, max_depth=dd),
                   dm2, 2)
    if c10["hist_int8x2_u4"] != k2 * 2 or c10["hist_f32_u4"] != k3 * 2 or \
            max(t.max_depth() for t in b10.gbm.trees) != dd:
        raise AssertionError(f"depth {dd} u4 launched {c10}, expected K2-u4 "
                             f"{k2} and K3-u4 {k3} times a round")
    for prec in ("bf16x2", "bf16"):
        name = f"hist_{prec}_u4"
        _, cb = run(f"external memory u4 pallas:{prec}",
                    dict(p16, max_depth=dd, hist_method=f"pallas:{prec}"),
                    dm2, 1)
        if cb[name] != d_pages * dd:
            raise AssertionError(f"pallas:{prec} launched {cb}, expected "
                                 f"{name} {d_pages * dd} times (pages x "
                                 "levels)")
    # Booster.predict on a paged matrix: its representative values through
    # K1, against the margin the cache walked over its bins
    reset_counts()
    pm = b10.predict(dm2, output_margin=True)
    walked = b10.gbm.full_margin_binned(
        dm2.binned(16, dev),
        torch.tensor(b10._base_np(), device=dev)).cpu().numpy()[:, 0]
    runs.append(read_counts())
    if runs[-1]["walk_packed"] != 1 or pm.shape != (EXT_DEEP_ROWS,) or \
            not np.isfinite(pm).all():
        raise AssertionError("predict on the paged matrix did not walk K1")
    err = float(np.abs(pm - walked).max())
    if err > 1e-5:
        raise AssertionError(f"predict on the paged matrix is {err} from the "
                             "walk over its bins")
    log(f"external memory predict on the paged {EXT_DEEP_ROWS}-row matrix: "
        f"K1 over its representative values, {err} from the walk over its "
        f"pages' bins")

    # the default budget (4 GiB) collapses the 308 MB matrix to the
    # resident tier: the same 11M rows trained resident
    del os.environ["XTPU_PAGED_COLLAPSE"]
    del os.environ["XTPU_PAGE_CACHE_BYTES"]
    paged.set_cache_budget()
    res_r = {}
    bres, cres = run("external memory default budget", params, dm,
                     EXT_ROUNDS, evals=[(dte, "test")], evals_result=res_r)
    if not isinstance(bres._caches[id(dm)]["binned"], BinnedMatrix) or \
            paged._resident is None or cres["hist_scan"] != depth * EXT_ROUNDS:
        raise AssertionError(f"the default budget did not collapse ({cres})")
    llr = res_r["test"]["logloss"]
    auc_r0 = auc(yte, bres.predict(dte, iteration_range=(0, 1)))
    log(f"external memory default budget ({paged.cache_budget_bytes} B, "
        f"settings {xtpu_env()}): collapsed to the resident tier, K4 "
        f"{depth} times a round on {EXT_ROWS} rows; held-out logloss "
        f"{llr[0]} -> {llr[-1]}, AUC {auc_r0:.6f} -> "
        f"{auc(yte, bres.predict(dte)):.6f} (paged: {ll[0]} -> {ll[-1]}, "
        f"AUC {auc_first:.6f} -> {auc_paged:.6f})")
    return runs, busy, s_round


def train_launches(name, train):
    """Run ``train()`` with every launch count set to 0 just before and
    read just after; returns (its result, the counts)."""
    reset_counts()
    out = train()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{name}: launches {counts}")
    return out, counts


def reset_counts():
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W

    W.LAUNCHES = 0
    for k in W.SCHEDULE_LAUNCHES:
        W.SCHEDULE_LAUNCHES[k] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def read_counts():
    """Launches of every kernel since ``reset_counts``; K1 in all and per
    schedule (``walk_spread``, ``walk_staged``)."""
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W

    return {"walk_packed": W.LAUNCHES,
            **{f"walk_{k}": v for k, v in W.SCHEDULE_LAUNCHES.items()},
            **dict(K.LAUNCHES)}


def levels_of(root: str) -> int:
    """``--levels-of``: K4's and K5's level times and K1's main-path times
    with the port in ``root`` (:func:`time_levels`, :func:`time_walk`,
    through the calls every version has)."""
    sys.path.insert(0, os.path.abspath(root))
    import xgboost_tpu_torch
    from xgboost_tpu_torch.ops.cuda import build

    if not xgboost_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {xgboost_tpu_torch.__file__}, not "
                             f"the port in {root}")
    card = gpu_line()
    log(f"gpu: {card}; port from {os.path.abspath(root)}")
    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    levels = time_levels(torch.device("cuda"), flush, current=False)
    walk = time_walk(torch.device("cuda"), flush, current=False)
    models = model_digests()
    print(json.dumps({"levels_of": os.path.abspath(root), "levels": levels,
                      "walk": walk, "models": models}))
    print(card)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--levels-of":
        return levels_of(sys.argv[2])
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--levels-of DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops.cuda import build
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W
    from xgboost_tpu_torch.ops.walk import (walk_fold_kernel_order,
                                            walk_packed_reference)
    from xgboost_tpu_torch.serve import Server
    from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
    from xgboost_tpu_torch.testing import make_forest, make_forest_model

    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # the plain version's leaf matmul must run in full f32
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls are not in full precision")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # --------------------------------------------- kernel vs plain version
    rng = np.random.RandomState(0)
    raw = make_forest_model(500, 8, 28, seed=0)
    booster = xt.Booster(model_file=raw)
    slice_pf = booster.packed_forest()
    log(f"slice forest: {slice_pf.describe()} Tp="
        f"{slice_pf.tree_offsets.shape[0]}")
    base = torch.tensor(booster._base_np(), device=dev)

    def normal(n, f, nan=0.1):
        X = rng.randn(n, f).astype(np.float32)
        X[rng.rand(n, f) < nan] = np.nan
        return X

    # K1 on the HIGGS-shape forest at every server bucket, 100,000 and
    # 1,000,000 rows on the plan's schedule, and on the other schedule at
    # 512 and 100,000 rows; one row's margin the same bits in all of them
    Xk = torch.from_numpy(normal(1_000_000, 28)).to(dev)
    errs, row0 = [], {}
    for n in (*[1 << k for k in range(10)], 100_000, 1_000_000):
        e, m, sch = check_kernel(f"slice n={n}", slice_pf, Xk[:n], base)
        errs.append(e)
        row0[(n, sch)] = m[0]
    for n, sch in ((512, "staged"), (100_000, "spread")):
        e, m, took = check_kernel(f"slice n={n} forced", slice_pf, Xk[:n],
                                  base, schedule=sch)
        errs.append(e)
        row0[(n, took)] = m[0]
    if not all(torch.equal(v, row0[(1, "spread")]) for v in row0.values()):
        raise AssertionError(f"row 0's margin depends on its batch: "
                             f"{ {k: v.tolist() for k, v in row0.items()} }")
    log(f"row 0's margin has the same bits at {len(row0)} (rows, schedule) "
        f"pairs from 1 to 1,000,000 rows: {sorted(row0)}")
    del Xk
    trees, info = make_forest(300, 8, 28, n_groups=3, seed=1)
    pf3 = PackedForest.from_trees(trees, info, 3)
    if list(pf3.tree_info[:6]) != [0, 1, 2, 0, 1, 2]:
        raise AssertionError("3-group forest does not cycle its groups")
    base3 = torch.tensor([0.1, -0.2, 0.3], device=dev)
    X3 = torch.from_numpy(normal(100_000, 28)).to(dev)
    cats = (0, 5, 11)
    trees, info = make_forest(200, 8, 28, cat_features=cats, seed=2,
                              n_categories=40)
    pfc = PackedForest.from_trees(trees, info, 1)
    Xc = normal(100_000, 28)
    for c in cats:
        Xc[:, c] = rng.randint(-2, 45, 100_000)
        edge = rng.rand(100_000) < 0.1
        Xc[edge, c] = rng.choice([-0.5, 1e10, -1e10, np.nan, 39.9, 40.0],
                                 int(edge.sum()))
    Xc = torch.from_numpy(Xc).to(dev)
    basec = torch.tensor([0.25], device=dev)
    for n in (4096, 100_000):
        for sch in ("spread", "staged"):
            errs.append(check_kernel(f"3-group n={n}", pf3, X3[:n], base3,
                                     sch)[0])
            errs.append(check_kernel(f"categorical n={n}", pfc, Xc[:n],
                                     basec, sch)[0])
    # the eval walk's one tree (Tp = 1) at 100,000 rows; a forest wider
    # than 1,024 features (both schedules read X from global memory); a
    # deep forest whose trees overflow a chunk buffer
    trees, info = make_forest(1, 8, 28, seed=3)
    pf1 = PackedForest.from_trees(trees, info, 1)
    zero = torch.zeros(1, device=dev)
    _, _, took = check_kernel("Tp=1 n=100000", pf1, X3, zero)
    if took != "staged":
        raise AssertionError(f"the one-tree walk of 100,000 rows took {took}")
    trees, info = make_forest(64, 8, 1100, seed=4)
    pfw = PackedForest.from_trees(trees, info, 1)
    Xw = torch.from_numpy(normal(100_000, 1100)).to(dev)
    for n in (512, 100_000):
        errs.append(check_kernel(f"wide n={n}", pfw, Xw[:n], zero)[0])
    del Xw
    trees, info = make_forest(8, 15, 28, seed=5)
    pfd = PackedForest.from_trees(trees, info, 1)
    _, _, took = check_kernel("deep n=100000", pfd, X3, zero)
    biggest = int((pfd.slot_spans()[:, 1] - pfd.slot_spans()[:, 0]).max())
    if took != "spread":
        raise AssertionError(f"the deep forest's walk took {took}")
    log(f"deep forest (depth 15, largest tree {biggest} nodes) planned and "
        f"launched on the spread schedule at 100,000 rows")
    del X3, Xc
    torch.cuda.synchronize()

    # ------------------------------------------ main path: Booster.predict
    n_big = 100_000
    Xbig = rng.randn(n_big, 28).astype(np.float32)
    dm = xt.DMatrix(Xbig)
    reset_counts()
    t0 = time.perf_counter()
    pred = booster.predict(dm)
    t_predict = time.perf_counter() - t0
    counts_predict = read_counts()
    launches_predict = counts_predict["walk_packed"]
    if launches_predict < 1 or counts_predict["walk_staged"] != \
            launches_predict:
        raise AssertionError(f"Booster.predict launched {counts_predict}, "
                             "expected K1 on the staged schedule")
    if pred.shape != (n_big,) or not np.isfinite(pred).all() \
            or not ((pred > 0) & (pred < 1)).all():
        raise AssertionError("Booster.predict gave no valid probabilities")
    log(f"Booster.predict: {n_big} rows in {t_predict * 1e3:.3f} ms "
        f"(host clock, includes H2D/D2H), kernel launches "
        f"{launches_predict} (spread {counts_predict['walk_spread']}, "
        f"staged {counts_predict['walk_staged']})")
    # the same rows through the plain version on the card
    d = slice_pf.device_arrays(dev)
    Xd = torch.from_numpy(Xbig).to(dev)
    ref_margin, ref_leaf = walk_packed_reference(
        d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
        d["group_onehot"], Xd, base, max_depth=slice_pf.max_depth,
        tree_chunk=tree_step(n_big), leaf_index=True)
    margin = booster.predict(dm, output_margin=True)
    bound = sum_bound(slice_pf, ref_leaf, base, tree_step(n_big))
    err = np.abs(margin - ref_margin[:, 0].cpu().numpy())
    if (err > bound[:, 0].cpu().numpy()).any():
        raise AssertionError(f"slice margins off by {err.max()}")
    replica = walk_fold_kernel_order(d["values"][ref_leaf.long()],
                                     d["tree_weight"], d["tree_group"], base)
    if not np.array_equal(margin, replica[:, 0].cpu().numpy()):
        raise AssertionError("Booster.predict's margins differ from the "
                             "kernel-order fold")
    errs.append(float(err.max()))
    depth = torch.from_numpy(node_depths(slice_pf)).to(dev)
    visits_big = int(depth[ref_leaf.long()].sum())
    del ref_margin, ref_leaf
    log(f"slice vs plain: max_abs_err={err.max()} over {n_big} rows, "
        f"{visits_big} internal-node visits; Booster.predict's margins equal "
        f"the kernel-order fold bit for bit")

    # ----------------------------------------------- main path: the Server
    sizes = (1, 8, 64, 512)
    n_req, n_threads = 200, 4
    answers = [None] * n_req
    reset_counts()
    with Server(models={"higgs": raw}, max_batch=512) as srv:
        srv.warmup()

        def client(tid):
            for i in range(tid, n_req, n_threads):
                n = sizes[i % len(sizes)]
                lo = (i * 977) % (n_big - n)
                answers[i] = (lo, n, srv.predict(Xbig[lo:lo + n]))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        snap = srv.metrics_snapshot()
    counts_serve = read_counts()
    launches_serve = counts_serve["walk_packed"]
    if launches_serve < 1 or counts_serve["walk_spread"] != launches_serve:
        raise AssertionError(f"the Server launched {counts_serve}, expected "
                             "K1 on the spread schedule")
    for k, a in enumerate(answers):
        if a is None:
            raise AssertionError(f"request {k} got no answer")
        lo, n, got = a
        if not np.array_equal(np.asarray(got), pred[lo:lo + n]):
            raise AssertionError(
                f"request {k} ({n} rows at {lo}) differs from "
                "Booster.predict")
    e2e = snap["stages"]["e2e"]
    log(f"serve: {n_req} requests of {sizes} rows from {n_threads} threads "
        f"in {wall:.4f} s = {n_req / wall:.1f} req/s, "
        f"{sum(a[1] for a in answers) / wall:.1f} rows/s; "
        f"e2e p50 {e2e['p50_ms']} ms p99 {e2e['p99_ms']} ms; "
        f"batches {snap['counters'].get('batches')}, kernel launches "
        f"{launches_serve} (spread {counts_serve['walk_spread']}, staged "
        f"{counts_serve['walk_staged']}); answers equal Booster.predict "
        f"bit for bit")
    for st in ("queue", "pad", "h2d", "compute", "d2h"):
        s = snap["stages"][st]
        log(f"  stage {st}: p50 {s['p50_ms']} ms p99 {s['p99_ms']} ms")

    # ------------------------------ K2 / K3 / K4 against their plain versions
    F = 28
    hist_errs = {}
    for i, (n_rows, N, B, skew) in enumerate(HIST_CASES):
        bins, gpair, rel = hist_inputs(n_rows, F, B, N, dev, seed=10 + i,
                                       skew=skew)
        label = f"n={n_rows} N={N} B={B}{' skewed' if skew else ''}"
        for k, e in check_hist(bins, gpair, rel, N, B, label).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del bins, gpair, rel

    for i, (n_rows, N, B) in enumerate(TWO_LEVEL_CASES):
        ids, gpair, rel = two_level_inputs(n_rows, F, N, B, dev, seed=90 + i)
        kind = "coarse" if B == 20 else "refine"
        for k, e in check_hist(ids, gpair, rel, N, B,
                               f"{kind} ids n={n_rows} N={N} B={B}").items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del ids, gpair, rel

    # -------------------- K5 and K4's coarse fold against their plain versions
    hist_errs["fused_advance_coarse"] = max(
        check_fused(n_rows, N, B, skew, dev, seed=60 + i)
        for i, (n_rows, N, B, skew) in enumerate(K5_CASES))
    hist_errs["hist_scan"] = max(
        [hist_errs["hist_scan"]]
        + [check_fold(n_rows, N, B, skew, dev, seed=70 + i)
           for i, (n_rows, N, B, skew) in enumerate(FOLD_CASES)])
    # ----------- K2's and K3's packed_u4 bodies against their plain versions
    for i, case in enumerate(U4_CASES):
        for k, e in check_u4(*case, dev, seed=120 + i).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)

    # -------------------------------------- main path: training, depth 8
    X, y = higgs_like(1_100_000, F, seed=0)
    dtr = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    dte = xt.DMatrix(X[1_000_000:], label=y[1_000_000:])
    params = dict(HIGGS_PARAMS)
    rounds = 20
    res = {}
    t0 = time.perf_counter()
    bst, train_counts = train_launches("train depth 8", lambda: xt.train(
        params, dtr, rounds, evals=[(dtr, "train"), (dte, "test")],
        evals_result=res, verbose_eval=5))
    t_train = time.perf_counter() - t0
    if train_counts["hist_scan"] != 8 * rounds or \
            train_counts["hist_int8x2"] != 0 or \
            train_counts["hist_f32"] != 0 or \
            train_counts["fused_advance_coarse"] != 0:
        raise AssertionError(f"training launched {train_counts}, expected "
                             f"K4 8 times a round, K2, K3 and K5 never")
    if train_counts["walk_packed"] < rounds or \
            train_counts["walk_staged"] != train_counts["walk_packed"]:
        raise AssertionError("the held-out evaluation did not walk the "
                             "trees through K1's staged schedule")
    ll = res["train"]["logloss"]
    if not ll[-1] < ll[0]:
        raise AssertionError(f"train logloss did not fall: {ll}")
    p_te = bst.predict(dte)
    auc_te = auc(y[1_000_000:], p_te)
    if not (np.isfinite(p_te).all() and auc_te > 0.6):
        raise AssertionError(f"held-out AUC {auc_te}")
    again = xt.Booster(model_file=bst.save_raw("ubj"))
    if not np.array_equal(again.predict(dte), p_te):
        raise AssertionError("save_raw -> Booster(model_file=) predicts "
                             "other bits")
    log(f"train: {rounds} rounds of depth 8 on 1,000,000 x {F} in "
        f"{t_train:.3f} s (host clock, sketch and binning included); "
        f"train logloss {ll[0]} -> {ll[-1]}, test logloss "
        f"{res['test']['logloss'][-1]}, held-out AUC {auc_te:.6f}; "
        f"save_raw round trip predicts the same bits")

    # seconds per round: update() between two syncs, on the same matrix;
    # then three more rounds under torch.profiler, timed the same way, for
    # the device's busy and idle shares of those rounds
    timer, per_round, auto_s = seconds_per_round(params, dtr)
    log(f"seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per_round]}; median of rounds 1-5 "
        f"{auto_s:.6f} s")
    profile_rounds("auto", timer, dtr, top=16)

    # ------------------------------------- main path: training, depth 10
    d10 = xt.DMatrix(X[:200_000], label=y[:200_000])
    deep, deep_counts = train_launches("train depth 10", lambda: xt.train(
        dict(params, max_depth=10), d10, 3, verbose_eval=False))
    if deep_counts["hist_scan"] != 8 * 3 or deep_counts["hist_f32"] != 2 * 3 \
            or deep_counts["hist_int8x2"] != 0:
        raise AssertionError(f"depth 10 launched {deep_counts}, expected K4 "
                             "8 and K3 2 times a round")
    if max(t.max_depth() for t in deep.gbm.trees) != 10:
        raise AssertionError("the depth-10 trees did not reach depth 10")
    # K3's share of a depth-10 round: its own kernels (the Fixed64
    # instantiations; the sort kernels it shares with K4 are not counted)
    timer10, _, s10 = seconds_per_round(dict(params, max_depth=10), d10)
    dev10, rows10 = profile_rounds("auto depth 10", timer10, d10, top=8)
    k3_ms = sum(e.self_device_time_total for e in rows10
                if "Fixed64" in e.key) / 1e3
    log(f"depth 10 on 200,000 rows: {s10:.6f} s a round (median of rounds "
        f"1-5, host clock); K3's kernels {k3_ms:.3f} ms of {dev10:.3f} ms "
        f"device busy over 3 rounds ({k3_ms / dev10 * 100:.2f}%)")

    # ------------------------------- main path: training below 65,536 rows
    d50 = xt.DMatrix(X[:50_000], label=y[:50_000])
    res50 = {}
    _, small_counts = train_launches("train 50,000 rows", lambda: xt.train(
        params, d50, 5, evals=[(d50, "train")], evals_result=res50,
        verbose_eval=False))
    if small_counts["hist_int8x2"] != 8 * 5 or small_counts["hist_scan"] != 0 \
            or small_counts["hist_f32"] != 0:
        raise AssertionError(f"50,000 rows launched {small_counts}, expected "
                             "K2 8 times a round")
    ll50 = res50["train"]["logloss"]
    if not ll50[-1] < ll50[0]:
        raise AssertionError(f"train logloss did not fall: {ll50}")
    log(f"train 50,000 rows: logloss {ll50[0]} -> {ll50[-1]}")

    # ------------- main path: the two-level schedules at the HIGGS shape
    # launches a round at depth 8: K2 for every coarse and refine build
    # (coarse); K5 at the 7 level boundaries, K2 for the root's coarse
    # histogram and the 8 refines (fused); K4 with its fold at every level
    # (scan)
    two_rounds = 10
    per_round_k = {"coarse": {"hist_int8x2": 16},
                   "fused": {"fused_advance_coarse": 7, "hist_int8x2": 9},
                   "scan": {"hist_scan": 8}}
    auto_ll10 = res["test"]["logloss"][two_rounds - 1]
    auto_auc10 = auc(y[1_000_000:], bst.predict(
        dte, iteration_range=(0, two_rounds)))
    log(f"auto after {two_rounds} rounds: held-out logloss {auto_ll10}, "
        f"AUC {auto_auc10:.6f}; {auto_s:.6f} s a round")
    two_level, two_counts, raws = {}, {}, {}
    for method, want in per_round_k.items():
        p2 = dict(params, hist_method=method)
        r2 = {}
        b2, c2 = train_launches(f"train {method}", lambda p2=p2, r2=r2:
                                xt.train(p2, dtr, two_rounds,
                                         evals=[(dtr, "train"),
                                                (dte, "test")],
                                         evals_result=r2, verbose_eval=False))
        want = {k: want.get(k, 0) * two_rounds for k in K.LAUNCHES}
        if {k: c2[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"{method} launched {c2}, expected {want}")
        ll2 = r2["train"]["logloss"]
        if not ll2[-1] < ll2[0]:
            raise AssertionError(f"{method}: train logloss did not fall")
        p_te2 = b2.predict(dte)
        auc2 = auc(y[1_000_000:], p_te2)
        if not (np.isfinite(p_te2).all() and auc2 > 0.6):
            raise AssertionError(f"{method}: held-out AUC {auc2}")
        timer2, _, s2 = seconds_per_round(p2, dtr)
        profile_rounds(method, timer2, dtr, top=16)
        two_level[method] = (s2, r2["test"]["logloss"][-1], auc2)
        two_counts[method] = c2
        raws[method] = saved_bytes(b2)
        log(f"train {method}: {two_rounds} rounds of depth 8 on 1,000,000 x "
            f"{F}; train logloss {ll2[0]} -> {ll2[-1]}, held-out logloss "
            f"{two_level[method][1]}, AUC {auc2:.6f}; {s2:.6f} s a round "
            f"(median of rounds 1-5, host clock; auto {auto_s:.6f})")
    if not raws["coarse"] == raws["fused"] == raws["scan"]:
        raise AssertionError("coarse, fused and scan saved different models")
    log("coarse, fused and scan saved the same model bytes")

    # ------------------ main path: fused and scan at depth 10 on 200k rows
    deep2 = {}
    for method, want in (("fused", {"fused_advance_coarse": 7,
                                    "hist_int8x2": 9, "hist_f32": 4}),
                         ("scan", {"hist_scan": 8, "hist_f32": 4})):
        b10, c10 = train_launches(f"train {method} depth 10", lambda m=method:
                                  xt.train(dict(params, max_depth=10,
                                                hist_method=m), d10, 2,
                                           verbose_eval=False))
        want = {k: want.get(k, 0) * 2 for k in K.LAUNCHES}
        if {k: c10[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"{method} depth 10 launched {c10}, "
                                 f"expected {want}")
        if max(t.max_depth() for t in b10.gbm.trees) != 10:
            raise AssertionError(f"{method}: no tree reached depth 10")
        deep2[method] = (c10, saved_bytes(b10))
    if deep2["fused"][1] != deep2["scan"][1]:
        raise AssertionError("fused and scan at depth 10 saved different "
                             "models")
    log("fused and scan at depth 10 saved the same model bytes")

    # ------------------- main path: multiclass at the Covertype shape
    # multi:softprob over 7 classes with row and column sampling and early
    # stopping on the held-out rows: K4 at every level of every class tree
    # (the sorted build, as the TPU's auto at 581,012 rows), K1 for the
    # held-out walks, Booster.predict and a 7-group Server
    Xc, yc = covtype_like(seed=4)
    n_cov = sum(COVTYPE_CLASS_COUNTS)
    if np.bincount(yc[:n_cov].astype(np.int64)).tolist() != \
            list(COVTYPE_CLASS_COUNTS):
        raise AssertionError("the Covertype-shape labels miss covtype's "
                             "class counts")
    dcov = xt.DMatrix(Xc[:n_cov], label=yc[:n_cov])
    dcte = xt.DMatrix(Xc[n_cov:], label=yc[n_cov:])
    yte = yc[n_cov:]
    cov_runs, cov_raw = [], []
    for run in range(2):
        res_c = {}
        t0 = time.perf_counter()
        bc, cc = train_launches(f"train Covertype run {run}", lambda r=res_c:
                                xt.train(COVTYPE_PARAMS, dcov, COVTYPE_ROUNDS,
                                         evals=[(dcte, "test")],
                                         evals_result=r, verbose_eval=10,
                                         early_stopping_rounds=(
                                             COVTYPE_EARLY_STOP)))
        t_cov = time.perf_counter() - t0
        rounds_c = bc.num_boosted_rounds()
        if cc["hist_scan"] != 56 * rounds_c or cc["hist_int8x2"] != 0 or \
                cc["hist_f32"] != 0 or cc["fused_advance_coarse"] != 0:
            raise AssertionError(f"Covertype launched {cc}, expected K4 56 "
                                 f"times a round (8 levels x 7 classes)")
        if cc["walk_packed"] != rounds_c or \
                cc["walk_staged"] != rounds_c:
            raise AssertionError(f"Covertype's held-out walks launched {cc}, "
                                 "expected K1 staged once a round")
        cov_runs.append(cc)
        cov_raw.append(bytes(bc.save_raw("ubj")))
        log(f"train Covertype run {run}: {rounds_c} rounds in {t_cov:.3f} s "
            f"(host clock, sketch and binning included on run 0); launches "
            f"a round: K4 {cc['hist_scan'] / rounds_c:g}, K1 "
            f"{cc['walk_packed'] / rounds_c:g}; best_iteration "
            f"{bc.best_iteration}, best_score {bc.best_score}, "
            f"{'stopped early' if rounds_c < COVTYPE_ROUNDS else 'ran every round'}")
    digests = [hashlib.sha256(r).hexdigest() for r in cov_raw]
    if digests[0] != digests[1]:
        raise AssertionError(f"two Covertype runs saved different models: "
                             f"{digests}")
    log(f"Covertype model sha256 (two runs): {digests[0]} {digests[1]}")
    mll = res_c["test"]["mlogloss"]
    p_first = bc.predict(dcte, iteration_range=(0, 1))
    p_cov = bc.predict(dcte)
    me0, me1 = merror(p_first, yte), merror(p_cov, yte)
    if not (mll[-1] < mll[0] and me1 < me0 and np.isfinite(p_cov).all()
            and p_cov.shape == (COVTYPE_TEST_ROWS, 7)):
        raise AssertionError(f"Covertype held-out mlogloss {mll[0]} -> "
                             f"{mll[-1]}, merror {me0} -> {me1}")
    if abs(multi_logloss(p_cov, yte) - mll[-1]) > 1e-5:
        raise AssertionError("Booster.predict disagrees with the eval line")
    log(f"Covertype held-out: mlogloss {mll[0]} -> {mll[-1]} (round "
        f"{len(mll) - 1}), merror {me0:.6f} -> {me1:.6f}; early-stopping "
        f"round {bc.num_boosted_rounds() - 1}, best_iteration "
        f"{bc.best_iteration}")
    # the sampled masks and row draws of every round of the run: the
    # threefry on the card against the threefry on the CPU
    base_mask = dcov.binned(256, dev).cuts.n_real_bins() > 0
    its = range(bc.num_boosted_rounds())
    mask_card = round_masks(COVTYPE_PARAMS, its, base_mask, dev)
    mask_cpu = round_masks(COVTYPE_PARAMS, its, base_mask,
                           torch.device("cpu"))
    if mask_card != mask_cpu:
        raise AssertionError(f"the sampled masks differ: card {mask_card}, "
                             f"CPU {mask_cpu}")
    log(f"Covertype sampled masks and row draws of {len(its)} rounds: "
        f"sha256 {mask_card} on the card and on the CPU")
    # seconds a round and device busy over three profiled rounds
    timer_c, per_c, cov_s = seconds_per_round(COVTYPE_PARAMS, dcov)
    log(f"Covertype seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per_c]}; median of rounds 1-5 {cov_s:.6f} s")
    cov_busy, _ = profile_rounds("Covertype", timer_c, dcov, top=12)
    # the round's random draws alone (host clock, ending in a sync): the
    # seven trees' feature masks and row samples of one round
    from xgboost_tpu_torch.boosting.gbtree import sample_gradients
    from xgboost_tpu_torch.tree.grow import draw_feature_masks
    from xgboost_tpu_torch.utils import random as xrandom

    gp_c = torch.randn(n_cov, 2, device=dev)
    tp_c = timer_c.tree_param
    base_t = torch.from_numpy(base_mask).to(dev)
    draws = []
    for it in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key = xrandom.fold_in(xrandom.key(0), it)
        tkeys = [xrandom.fold_in(key, k) for k in range(7)]
        draw_feature_masks(tkeys, base_t, tp_c, tp_c.max_depth)
        for tk in tkeys:
            sample_gradients(gp_c, tk, tp_c)
        torch.cuda.synchronize()
        draws.append(time.perf_counter() - t0)
    log(f"Covertype random draws of one round (7 trees' masks and row "
        f"samples; host clock, ending in a sync): median of rounds 1-5 "
        f"{float(np.median(draws[1:])) * 1e3:.3f} ms")
    # Booster.predict on the 100k held-out rows and a 7-group Server
    reset_counts()
    p_again = bc.predict(dcte)
    cov_predict_counts = read_counts()
    if not np.array_equal(p_again, p_cov) or \
            cov_predict_counts["walk_staged"] != 1:
        raise AssertionError(f"Covertype predict: {cov_predict_counts}")
    Xte = Xc[n_cov:]
    answers_c = []
    reset_counts()
    with Server(models={"covtype": cov_raw[0]}, max_batch=512) as srv:
        srv.warmup()
        for i in range(80):
            n = sizes[i % len(sizes)]
            lo = (i * 1237) % (COVTYPE_TEST_ROWS - n)
            answers_c.append((lo, n, np.asarray(srv.predict(Xte[lo:lo + n]))))
        snap_c = srv.metrics_snapshot()
    cov_serve_counts = read_counts()
    for lo, n, got in answers_c:
        if not np.array_equal(got, p_cov[lo:lo + n]):
            raise AssertionError(f"a 7-class Server answer ({n} rows at "
                                 f"{lo}) differs from Booster.predict")
    if cov_serve_counts["walk_spread"] < 1:
        raise AssertionError(f"the 7-class Server launched "
                             f"{cov_serve_counts}")
    log(f"Covertype serve: 80 requests of {sizes} rows, 7 groups, every "
        f"answer equal to Booster.predict bit for bit; e2e p50 "
        f"{snap_c['stages']['e2e']['p50_ms']} ms p99 "
        f"{snap_c['stages']['e2e']['p99_ms']} ms; K1 launches "
        f"{cov_serve_counts['walk_packed']} (spread "
        f"{cov_serve_counts['walk_spread']})")
    # one random-forest round (num_parallel_tree 4) and a gradient-based
    # row sample
    rf, rf_counts = train_launches("Covertype num_parallel_tree 4", lambda:
                                   xt.train(dict(COVTYPE_PARAMS,
                                                 num_parallel_tree=4),
                                            dcov, 1, verbose_eval=False))
    if rf_counts["hist_scan"] != 8 * 7 * 4 or len(rf.gbm.trees) != 28 or \
            rf.gbm.tree_info[:8] != [0, 0, 0, 0, 1, 1, 1, 1]:
        raise AssertionError(f"num_parallel_tree 4: {rf_counts}, "
                             f"{len(rf.gbm.trees)} trees")
    res_g = {}
    gb, gb_counts = train_launches("Covertype gradient_based", lambda:
                                   xt.train(dict(COVTYPE_PARAMS,
                                                 subsample=0.5,
                                                 sampling_method=
                                                 "gradient_based"),
                                            dcov, 3, evals=[(dcte, "test")],
                                            evals_result=res_g,
                                            verbose_eval=False))
    gll = res_g["test"]["mlogloss"]
    if not gll[-1] < gll[0] or gb_counts["hist_scan"] != 56 * 3:
        raise AssertionError(f"gradient_based: {gll}, {gb_counts}")
    log(f"Covertype num_parallel_tree 4: 28 trees in one round, K4 "
        f"{rf_counts['hist_scan']}; gradient_based subsample 0.5: held-out "
        f"mlogloss {gll[0]} -> {gll[-1]} in 3 rounds")
    # one round each through K3's rounded precisions
    bf16_counts = {}
    for prec in ("bf16x2", "bf16"):
        bb, cb16 = train_launches(f"Covertype pallas:{prec}", lambda p=prec:
                                  xt.train(dict(COVTYPE_PARAMS,
                                                hist_method=f"pallas:{p}"),
                                           dcov, 1, verbose_eval=False))
        name = f"hist_{prec}"
        if cb16[name] != 56 or cb16["hist_scan"] != 0:
            raise AssertionError(f"pallas:{prec} launched {cb16}, expected "
                                 f"{name} 56 times a round")
        bf16_counts[name] = cb16
    cov_pf = bc.packed_forest()
    Xte_dev = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    cov_base = torch.tensor(bc._base_np(), device=dev)
    last_pf = PackedForest.from_trees(bc.gbm.trees[-7:],
                                      bc.gbm.tree_info[-7:], 7)
    # K1's 7-group fold against the plain walk on both schedules
    for n, sch in ((512, "spread"), (100_000, "staged")):
        errs.append(check_kernel(f"Covertype 7-group n={n}", cov_pf,
                                 Xte_dev[:n].contiguous(), cov_base, sch)[0])

    # ---- main path: BASELINE config #4 in full (categorical codes, dart)
    (covdart_runs, covdart_errs, covdart_k1, covdart_k2, covdart_s,
     covdart_busy) = covertype_categorical_dart(xt, dev, Xc, yc,
                                                (mll, (me0, me1)))
    errs += covdart_k1
    for k, e in covdart_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log(f"covertype_categorical_dart: {covdart_s:.6f} s a round, device busy "
        f"{covdart_busy:.3f} ms over 3 rounds; Covertype one-hot gbtree "
        f"{cov_s:.6f} s a round, busy {cov_busy:.3f} ms")
    del Xc, dcov, dcte

    # ------- main path: BASELINE config #3 in full (rank:ndcg at MSLR shape)
    mslr_runs, mslr_errs, mslr_k1, mslr_hist, mslr = mslr_ranking(xt, dev)
    errs += mslr_k1
    for k, e in mslr_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log(f"mslr_ranking: {mslr['s_round']:.6f} s a round, device busy "
        f"{mslr['busy_ms'] / 3:.3f} ms a round (histograms "
        f"{mslr['hist_ms']:.3f}, LambdaRank gradient {mslr['grad_ms']:.3f}); "
        f"held-out ndcg@10 {mslr['ndcg'][0]} -> {mslr['ndcg'][1]}")

    # ---- main path: BASELINE config #1, the agaricus demos from libsvm files
    with tempfile.TemporaryDirectory(prefix="xtt_agaricus_") as tmp:
        (ag_runs, ag_k2_err, ag_k1_err, ag_k2_time, ag_k1_time,
         ag) = agaricus_walkthrough(xt, dev, tmp)
    errs.append(ag_k1_err)
    hist_errs["hist_int8x2"] = max(hist_errs.get("hist_int8x2", 0.0),
                                   ag_k2_err)
    log(f"agaricus_walkthrough: DMatrix(path) {ag['load_s']:.6f} s, parse "
        f"{ag['parse_rows_per_s']:.1f} rows/s, {ag['s_round']:.6f} s a round, "
        f"device busy {ag['busy_ms'] / 3:.3f} ms a round; held-out error "
        f"{ag['error']}, rmse {ag['rmse']}; model sha256 {ag['digests']}")

    # --------- main path: external memory at the HIGGS-11M shape (paged)
    with tempfile.TemporaryDirectory(prefix="xtt_ext_") as tmp:
        ext_runs, ext_busy, ext_s = external_memory(xt, dev, F, tmp)

    # ------------------------------------------------------- times on card
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    # each kernel at the deepest level its main path gives it, and at the
    # root; K2 also at 1M rows, beside K4 on the same inputs
    # and at the two-level schedules' refine builds (36 slots: K2 at the
    # HIGGS run's root and deepest level, K3 at depth 10's deepest) and the
    # root's coarse build (20 slots)
    hist_times = {}
    for i, (n_rows, N, B) in enumerate((
            (1_000_000, 1, 256), (1_000_000, 128, 256), (200_000, 256, 256),
            (200_000, 512, 256), (50_000, 1, 256), (50_000, 128, 256),
            (1_000_000, 1, 20), (1_000_000, 1, 36), (1_000_000, 128, 36),
            (200_000, 512, 36), (1_000_000, 128, 20))):
        if B == 256:
            bins, gpair, rel = hist_inputs(n_rows, F, B, N, dev,
                                           seed=40 + i)
        else:
            bins, gpair, rel = two_level_inputs(n_rows, F, N, B, dev,
                                                seed=40 + i)
        t, n_active = time_hist(bins, gpair, rel, N, B, flush)
        for name, (ms, plain_ms, lib_ms) in t.items():
            planes = 2 if name in k3_precisions() else 4
            bound = hist_bound_ms(bins, N, B, n_active, planes)
            hist_times[(name, n_rows, N, B)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n={n_rows} N={N} B={B} x {F} u8 (L2 flushed): "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
                f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}; "
                f"{bound[2]} integer adds), kernel at "
                f"{bound[0] / ms * 100:.4f}% of it")
        del bins, gpair, rel
    # K2-u4 and K3-u4 at a 1M-row page of the u4 run's deepest levels
    u4_times = {}
    for N in (128, 512):
        for name, (ms, plain_ms, lib_ms, bound) in time_u4(
                1_000_000, F, N, dev, flush, seed=130 + N).items():
            u4_times[(name, N)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n=1000000 N={N} B=16 x {F} u4-packed (L2 "
                f"flushed): {ms:.6f} ms, plain {plain_ms:.6f} ms, unpack_u4 "
                f"+ index_add_ {lib_ms:.6f} ms, bound {bound[0]:.6f} ms "
                f"({bound[1]}), kernel at {bound[0] / ms * 100:.4f}% of it")
    # K4 at every level width and K5 at every level boundary of the HIGGS
    # run, with their phases
    levels = time_levels(dev, flush)
    for name, label in (("hist_scan", "K4"), ("fused_advance_coarse", "K5")):
        for N, r in levels[name].items():
            sort, tiles, comb = r["phases"]
            log(f"phases {label} N={N}: sort {sort:.6f} ms, tiles "
                f"{tiles:.6f} ms, combine and fold {comb:.6f} ms (sum "
                f"{sort + tiles + comb:.6f}, queued call "
                f"{r['queued_ms']:.6f}, event call {r['ms']:.6f}); queued "
                f"call at {r['bound'][0] / r['queued_ms'] * 100:.4f}% of its "
                f"bound, time - bound {r['queued_ms'] - r['bound'][0]:.6f} "
                f"ms")
    # K1 on the Covertype forest (7 groups, X read from global memory by
    # the staged walk at 54 features): the 100,000 held-out rows through
    # the whole forest (a predict) and through one round's 7 trees (an
    # eval walk), and the server's 1- and 512-row buckets
    cov_walk = {}
    for label, f, n, cold in (("forest 100000", cov_pf, 100_000, flush),
                              ("round 100000", last_pf, 100_000, flush),
                              ("forest 1", cov_pf, 1, None),
                              ("forest 512", cov_pf, 512, None)):
        Xn = Xte_dev[:n].contiguous()
        b7 = cov_base if f is cov_pf else torch.zeros(7, device=dev)
        before = dict(W.SCHEDULE_LAUNCHES)
        _, leaves = f.margin(Xn, b7, leaf_index=True)
        took = [k for k, v in W.SCHEDULE_LAUNCHES.items() if v != before[k]]
        depth7 = torch.from_numpy(node_depths(f)).to(dev)
        r = {"queued_ms": queued_ms(lambda: f.margin(Xn, b7), 20, cold),
             "ms": event_ms(lambda: f.margin(Xn, b7), reps=20, flush=cold),
             "bound": walk_bound_ms(f, n, 54, int(
                 depth7[leaves.long()].sum()))}
        cov_walk[label] = r
        r["schedule"] = took[0]
        log(f"K1 Covertype {label} rows (Tp={f.tree_offsets.shape[0]}, 7 "
            f"groups, {took[0]}): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()
                        if k != "schedule"))
    # K1 at its main-path shapes, and both schedules across the crossover
    walk = time_walk(dev, flush)
    for label, r in walk["shapes"].items():
        log(f"K1 {label} rows: device-only {r['queued_ms']:.6f} ms at "
            f"{r['bound'][0] / r['queued_ms'] * 100:.4f}% of its bound "
            f"({r['bound'][1]}), time - bound "
            f"{r['queued_ms'] - r['bound'][0]:.6f} ms")
    torch.cuda.synchronize()

    log(f"model digests: {{'auto': {digest(bst)!r}, 'scan': "
        f"{hashlib.sha256(raws['scan']).hexdigest()!r}}}")

    # launches: every main-path run of the kernel
    runs = [train_counts, deep_counts, small_counts,
            *two_counts.values(), *(c for c, _ in deep2.values()),
            *cov_runs, rf_counts, gb_counts, *bf16_counts.values(),
            *ext_runs, *covdart_runs, *mslr_runs, *ag_runs]
    kernels = [{
        "name": "walk_packed",
        "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "launches": (launches_predict + launches_serve
                     + cov_predict_counts["walk_packed"]
                     + cov_serve_counts["walk_packed"]
                     + sum(c["walk_packed"] for c in runs)),
        "max_abs_err": max(errs),
        "ms": walk["shapes"]["100000"]["ms"],
        "plain_ms": walk["shapes"]["100000"]["plain_ms"],
        "bound_ms": walk["shapes"]["100000"]["bound"][0],
        "bound_by": walk["shapes"]["100000"]["bound"][1],
        "library_ms": None,
    }]
    # times at the shape that takes most of each kernel's launches (K2:
    # the categorical dart runs' levels over 12 features, at 128 nodes)
    hist_times[("hist_int8x2", "codes")] = covdart_k2
    for name, replaces, shape in (
            ("hist_int8x2", ":621", ("codes",)),
            ("hist_f32", ":634", (200_000, 512, 256)),
            ("hist_bf16x2", ":634", (200_000, 512, 256)),
            ("hist_bf16", ":634", (200_000, 512, 256)),
            ("hist_scan", ":478", (1_000_000, 128, 256))):
        ms, plain_ms, lib_ms, bound = hist_times[(name, *shape)]
        launches = sum(c[name] for c in runs)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + replaces,
            "launches": launches, "max_abs_err": hist_errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
    # the packed_u4 bodies: K2-u4 at the u4 run's levels of 128 nodes, K3-u4
    # at depth 10's levels of 512
    for name, replaces, N in (("hist_int8x2_u4", ":62", 128),
                              ("hist_f32_u4", ":62", 512),
                              ("hist_bf16x2_u4", ":62", 512),
                              ("hist_bf16_u4", ":62", 512)):
        ms, plain_ms, lib_ms, bound = u4_times[(name, N)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + replaces,
            "launches": sum(c[name] for c in runs),
            "max_abs_err": hist_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms})
    # the agaricus shapes: K2 at 6,513 x 127, B = 2 (N = 2, its deeper
    # level), K1 on the agaricus forest at the 1,611 test rows
    ms, plain_ms, lib_ms, bound = ag_k2_time
    kernels.append({
        "name": "hist_int8x2", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/pallas/histogram.py:621",
        "shape": "agaricus 6513 x 127, B=2, N=1/2",
        "launches": sum(c["hist_int8x2"] for c in ag_runs),
        "max_abs_err": ag_k2_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms})
    kernels.append({
        "name": "walk_packed", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "shape": f"agaricus forest, {AGARICUS_TEST_ROWS} rows",
        "launches": sum(c["walk_packed"] for c in ag_runs),
        "max_abs_err": ag_k1_err, "ms": ag_k1_time["ms"],
        "plain_ms": ag_k1_time["plain_ms"],
        "bound_ms": ag_k1_time["bound"][0],
        "bound_by": ag_k1_time["bound"][1], "library_ms": None})
    k5 = levels["fused_advance_coarse"][128]
    ms, plain_ms, bound = k5["ms"], k5["plain_ms"], k5["bound"]
    kernels.append({
        "name": "fused_advance_coarse", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/pallas/histogram.py:344",
        "launches": sum(c["fused_advance_coarse"] for c in runs),
        "max_abs_err": hist_errs["fused_advance_coarse"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
