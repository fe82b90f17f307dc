#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xgboost_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``xgboost_tpu_torch/csrc/`` with nvcc (one
nvcc per source, all at once) and holds each kernel against its plain
PyTorch version on the card: K1 (the forest walk), K2 (int8x2
histogram), K3 (f32 histogram, exact int64 fixed point), K4 (int8x2
histogram over rows sorted by node) and its coarse fold, and K5 (the
level advance fused with the next level's coarse histogram), all but K1
bit for bit and twice each, at the shapes the training runs below give
them: K2, K3 and K4 over 256/257 bin slots, also at skewed levels (one
node with 55% of the rows, three empty), and over the two-level
schedules' 20-slot coarse ids and 36-slot refine ids (a window of 32
fine bins chosen per node and feature, the rest on slot 35). Then it
drives the port's main paths, each with the launch counts set to 0 just
before and read just after:

- serving at the HIGGS shape (500 trees of depth 8 over 28 features,
  ``binary:logistic``, made from a seed): ``Booster.predict`` on 100,000
  rows and a ``Server`` answering 200 requests of 1/8/64/512 rows from 4
  threads, every answer equal to ``Booster.predict`` bit for bit;
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
  where the levels of 256 and 512 nodes take the plain advance and K3.

It times each kernel, its plain version, one PyTorch library call for
the same function where there is one, and the kernel's bound, at the
main paths' shapes; seconds per boosting round on the host clock; and
the device's idle share of the same rounds under ``torch.profiler``.

Prints the card (``nvidia-smi`` name and power limit) and a JSON line
of kernel numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""

import json
import math
import os
import subprocess
import sys
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


def check_kernel(name, pf, X, base):
    """Kernel against its plain version on the same device tensors:
    leaf indices equal, margins within the reassociation bound."""
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
    from xgboost_tpu_torch.serve.packed import tree_step

    d = pf.device_arrays(X.device)
    got, got_leaf = pf.margin(X, base, leaf_index=True)
    tc = tree_step(X.shape[0])
    want, want_leaf = walk_packed_reference(
        d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
        d["group_onehot"], X, base, d.get("cat_words"),
        max_depth=pf.max_depth, tree_chunk=tc, leaf_index=True)
    torch.cuda.synchronize()
    if not torch.equal(got_leaf, want_leaf):
        bad = int((got_leaf != want_leaf).sum())
        raise AssertionError(f"{name}: {bad} leaf indices differ")
    err = (got - want).abs()
    bound = sum_bound(pf, want_leaf, base, tc)
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(
            f"{name}: margin off by {float(err.max())} "
            f"(bound {float(bound.min())}..{float(bound.max())})")
    log(f"check {name}: rows={X.shape[0]} trees={pf.n_trees} "
        f"groups={pf.n_groups} cat={pf.has_cat} leaf_index equal, "
        f"max_abs_err={float(err.max())} "
        f"max_err/bound={float((err / bound).max())}")
    return float(err.max())


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


def hist_kernels(N):
    """The kernels that run at a level of N nodes, with their plain
    versions: (name, kernel(args), plain(args), maker of the args)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    def int8x2_args(bins, gpair, rel):
        q, inv = H.quantise_int8x2(gpair)
        return bins, q, rel, inv

    def f32_args(bins, gpair, rel):
        qs, inv = H.fixed_point_scale(gpair)
        return bins, gpair, rel, qs, inv

    out = [("hist_f32", K.hist_f32_cuda, H.build_hist_f32_reference,
            f32_args)]
    if N <= 128:
        out += [("hist_int8x2", K.hist_int8x2_cuda,
                 H.build_hist_int8x2_reference, int8x2_args),
                ("hist_scan", K.hist_scan_cuda, H.build_hist_scan_reference,
                 int8x2_args)]
    return out


def check_hist(bins, gpair, rel, N, B, label):
    """Each kernel against its plain version on the same card tensors:
    equal bit for bit on two launches; totals against the row sums.
    Returns {kernel: max |kernel - plain|}."""
    errs = {}
    ratios = []
    for name, kernel, plain, make in hist_kernels(N):
        args = make(bins, gpair, rel)
        runs = [kernel(*args, N, B) for _ in range(2)]
        want = plain(*args, N, B)
        torch.cuda.synchronize()
        errs[name] = max(float((r - want).abs().max()) for r in runs)
        if not all(torch.equal(r, want) for r in runs):
            raise AssertionError(f"{name} {label}: a launch differs from the "
                                 f"plain version (max {errs[name]})")
        ratios.append(hist_totals_ok(f"{name} {label}", runs[0], gpair, rel,
                                     N, args[-1]))
    log(f"check hist {label}: rows={bins.shape[0]} features={bins.shape[1]} "
        f"nodes={N} bins={B} ({bins.dtype}): {sorted(errs)} equal their "
        f"plain versions bit for bit on two launches; totals at "
        f"{max(ratios):.3f} of their bound at most")
    return errs


def hist_bound_ms(bins, N, B, n_active, planes):
    """(ms, "bytes"|"operations", ops): bins, the gradients (q or gpair,
    8 B a row) and rel read once, the [N, F, B, 2] f32 histogram written
    once, over 3.35 TB/s; against one integer add per (active row,
    feature, plane) over the f32 lane rate (the table has no scalar
    integer rate)."""
    n, F = bins.shape
    nbytes = n * F * bins.element_size() + n * 8 + n * 4 + N * F * B * 8
    ops = n_active * F * planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", ops
    return t_ops, "operations", ops


def time_hist(bins, gpair, rel, N, B, flush):
    """{kernel: (ms, plain_ms, library_ms)} for the kernels of a level of
    N nodes: CUDA-event times of each kernel (L2 flushed), its plain
    version, and the nearest single PyTorch call, one ``index_add_`` of
    the four int32 planes (K2, K4) or of the f32 (g, h) pairs (K3), with
    the (row, feature) cells and values prepared beforehand. Also the
    active row count."""
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
        args = make(bins, gpair, rel)
        out[name] = (
            event_ms(lambda: kernel(*args, N, B), reps=20, flush=flush),
            event_ms(lambda: plain(*args, N, B), reps=5),
            lib_f32 if name == "hist_f32" else lib_int)
    return out, int(active.sum())


# (rows, nodes of the new level, bin slots): K5 at the level boundaries
# the fused runs give it, and with the missing-slot layout
K5_CASES = ((1_000_000, 2, 256), (1_000_000, 128, 256),
            (1_000_000, 64, 257))


def level_inputs(n, F, B, N, dev, seed):
    """A level boundary made on the card from ``seed``: ``hist_inputs``'s
    bins and gradients; int64 positions at the previous level of N / 2
    nodes, 10% of them strays above it; that level's splits, 20% of its
    nodes not splitting."""
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
    feat = torch.randint(0, F, (n_prev,), generator=g, device=dev)
    thr = torch.randint(0, B - 1, (n_prev,), generator=g, device=dev)
    dleft = torch.rand(n_prev, generator=g, device=dev) < 0.5
    prev = LevelSplits(lo_prev, torch.where(cs, feat, -1),
                       torch.where(cs, thr, 0), cs & dleft, cs)
    return bins, gpair, pos.contiguous(), prev


def check_fused(n_rows, N, B, dev, seed):
    """K5 against its plain version on the same card tensors: positions
    and coarse histogram equal bit for bit on two launches, and the
    histogram equal to K2 over the coarse ids of the advanced rows.
    Returns max |kernel - plain| of the histogram."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, pos, prev = level_inputs(n_rows, 28, B, N, dev, seed)
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
                                 f"B={B}: a launch differs from the plain "
                                 f"version (max {err})")
    if not torch.equal(k2, want):
        raise AssertionError("K5's coarse histogram differs from K2's")
    moved = int((want_pos != pos).sum())
    log(f"check fused_advance_coarse n={n_rows} F=28 N={N} B={B} "
        f"({bins.dtype}): positions ({moved} rows moved) and the coarse "
        f"histogram equal the plain version bit for bit on two launches, "
        f"and K2 over the coarse ids")
    return err


def check_fold(n_rows, N, B, dev, seed):
    """K4's int32 accumulators against the plain ones, their coarse fold
    against the plain fold, and the folded histogram against K2's direct
    build over the coarse ids, bit for bit."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, rel = hist_inputs(n_rows, 28, B, N, dev, seed)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(gpair)
    _, acc = K.hist_scan_cuda(bins, q, rel, inv, N, B, with_acc=True)
    folded = H.coarse_fold(acc, missing)
    want = H.coarse_fold(H.scan_acc_reference(bins, q, rel, N, B), missing)
    direct = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q, rel, inv,
                                N, COARSE_B)
    torch.cuda.synchronize()
    if not torch.equal(folded, want):
        raise AssertionError(f"K4's fold differs from the plain fold "
                             f"(n={n_rows} N={N} B={B})")
    if not torch.equal(H.dequant_int8x2(folded, inv), direct):
        raise AssertionError("K4's folded coarse histogram differs from "
                             "K2's direct build")
    log(f"check coarse fold n={n_rows} F=28 N={N} B={B}: K4's fold equals "
        f"the plain fold and K2's direct coarse build bit for bit")


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


def time_fused(n_rows, N, dev, flush, seed):
    """K5 at a level boundary of N nodes: (ms, plain_ms, index_add_ ms of
    the coarse planes, bound, active rows). The yardstick is one
    ``index_add_`` of the four int32 planes at the advanced rows' coarse
    cells, with cells and values prepared beforehand: the histogram half
    only, as no PyTorch call advances rows."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, pos, prev = level_inputs(n_rows, 28, 256, N, dev, seed)
    lo = 2 * prev.lo + 1
    q, inv = H.quantise_int8x2(gpair)
    new_pos, _ = H.fused_advance_coarse_reference(bins, q, inv, pos, prev,
                                                  lo, N, 256)
    cb = coarse_bin_ids(bins, 256)
    seg, active = H._segments(cb, level_rel(new_pos, lo, N), N, COARSE_B)
    vals = H.int8x2_planes(q)[active][:, None, :].expand(
        -1, 28, 4).reshape(-1, 4)
    acc = torch.zeros((N * 28 * COARSE_B, 4), dtype=torch.int32, device=dev)
    lib = event_ms(lambda: acc.index_add_(0, seg, vals), reps=10,
                   flush=flush)
    n_active = int(active.sum())
    del seg, vals, acc, cb
    ms = event_ms(lambda: K.fused_advance_coarse_cuda(
        bins, q, inv, pos, prev, lo, N, 256), reps=20, flush=flush)
    plain = event_ms(lambda: H.fused_advance_coarse_reference(
        bins, q, inv, pos, prev, lo, N, 256), reps=5)
    return ms, plain, lib, fused_bound_ms(bins, N, n_active), n_active


def saved_bytes(bst):
    """``save_raw`` bytes with the ``hist_method`` the booster records set
    to one value, so that models of different schedules compare."""
    bst.set_param({"hist_method": "scan"})
    return bytes(bst.save_raw("ubj"))


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
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def read_counts():
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W

    return {"walk_packed": W.LAUNCHES, **dict(K.LAUNCHES)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops.cuda import build
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as cuda_walk
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
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

    errs = [check_kernel("slice", slice_pf,
                         torch.from_numpy(normal(4096, 28)).to(dev), base)]
    trees, info = make_forest(300, 8, 28, n_groups=3, seed=1)
    pf3 = PackedForest.from_trees(trees, info, 3)
    if list(pf3.tree_info[:6]) != [0, 1, 2, 0, 1, 2]:
        raise AssertionError("3-group forest does not cycle its groups")
    errs.append(check_kernel(
        "3-group", pf3, torch.from_numpy(normal(4096, 28)).to(dev),
        torch.tensor([0.1, -0.2, 0.3], device=dev)))
    cats = (0, 5, 11)
    trees, info = make_forest(200, 8, 28, cat_features=cats, seed=2,
                              n_categories=40)
    pfc = PackedForest.from_trees(trees, info, 1)
    Xc = normal(4096, 28)
    for c in cats:
        Xc[:, c] = rng.randint(-2, 45, 4096)
        edge = rng.rand(4096) < 0.1
        Xc[edge, c] = rng.choice([-0.5, 1e10, -1e10, np.nan, 39.9, 40.0],
                                 int(edge.sum()))
    errs.append(check_kernel("categorical", pfc,
                             torch.from_numpy(Xc).to(dev),
                             torch.tensor([0.25], device=dev)))
    torch.cuda.synchronize()

    # ------------------------------------------ main path: Booster.predict
    n_big = 100_000
    Xbig = rng.randn(n_big, 28).astype(np.float32)
    dm = xt.DMatrix(Xbig)
    cuda_walk.LAUNCHES = 0
    t0 = time.perf_counter()
    pred = booster.predict(dm)
    t_predict = time.perf_counter() - t0
    launches_predict = cuda_walk.LAUNCHES
    if launches_predict < 1:
        raise AssertionError("Booster.predict did not launch the kernel")
    if pred.shape != (n_big,) or not np.isfinite(pred).all() \
            or not ((pred > 0) & (pred < 1)).all():
        raise AssertionError("Booster.predict gave no valid probabilities")
    log(f"Booster.predict: {n_big} rows in {t_predict * 1e3:.3f} ms "
        f"(host clock, includes H2D/D2H), kernel launches "
        f"{launches_predict}")
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
    errs.append(float(err.max()))
    depth = torch.from_numpy(node_depths(slice_pf)).to(dev)
    visits_big = int(depth[ref_leaf.long()].sum())
    del ref_margin, ref_leaf
    log(f"slice vs plain: max_abs_err={err.max()} over {n_big} rows, "
        f"{visits_big} internal-node visits")

    # ----------------------------------------------- main path: the Server
    sizes = (1, 8, 64, 512)
    n_req, n_threads = 200, 4
    answers = [None] * n_req
    cuda_walk.LAUNCHES = 0
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
    launches_serve = cuda_walk.LAUNCHES
    if launches_serve < 1:
        raise AssertionError("the Server did not launch the kernel")
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
        f"{launches_serve}; answers equal Booster.predict bit for bit")
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
        check_fused(n_rows, N, B, dev, seed=60 + i)
        for i, (n_rows, N, B) in enumerate(K5_CASES))
    check_fold(1_000_000, 128, 256, dev, seed=70)
    check_fold(1_000_000, 64, 257, dev, seed=71)

    # -------------------------------------- main path: training, depth 8
    X, y = higgs_like(1_100_000, F, seed=0)
    dtr = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    dte = xt.DMatrix(X[1_000_000:], label=y[1_000_000:])
    params = {"objective": "binary:logistic", "max_depth": 8, "eta": 0.1,
              "max_bin": 256}
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
    if train_counts["walk_packed"] < rounds:
        raise AssertionError("the held-out evaluation did not walk the "
                             "trees through K1")
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
    profile_rounds("auto", timer, dtr)

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
        profile_rounds(method, timer2, dtr, top=8)
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
            planes = 2 if name == "hist_f32" else 4
            bound = hist_bound_ms(bins, N, B, n_active, planes)
            hist_times[(name, n_rows, N, B)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n={n_rows} N={N} B={B} x {F} u8 (L2 flushed): "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
                f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}; "
                f"{bound[2]} integer adds), kernel at "
                f"{bound[0] / ms * 100:.4f}% of it")
        del bins, gpair, rel
    fused_times = {}
    for i, N in enumerate((2, 8, 32, 128)):
        ms, plain_ms, lib_ms, bound, n_act = time_fused(1_000_000, N, dev,
                                                        flush, seed=80 + i)
        fused_times[N] = (ms, plain_ms, bound)
        log(f"fused_advance_coarse n=1000000 N={N} x {F} u8 (L2 flushed): "
            f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ of the "
            f"coarse planes {lib_ms:.6f} ms, bound {bound[0]:.6f} ms "
            f"({bound[1]}; {bound[2]} integer adds), kernel at "
            f"{bound[0] / ms * 100:.4f}% of it")
    times = {}
    for n in (1, 512, n_big):
        X = Xd[:n].contiguous()
        cold = n == n_big
        ms = event_ms(lambda X=X: slice_pf.margin(X, base),
                      reps=20 if cold else 200, flush=flush if cold else None)
        times[n] = ms
        log(f"kernel walk n={n}: {ms:.6f} ms "
            f"({'L2 flushed' if cold else 'L2 warm'})")
    plain = {}
    for n in (512, n_big):
        X = Xd[:n].contiguous()
        plain[n] = event_ms(lambda X=X: walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], X, base, max_depth=slice_pf.max_depth,
            tree_chunk=tree_step(n)), reps=5 if n == n_big else 20)
        log(f"plain walk n={n}: {plain[n]:.6f} ms")
    bounds = {}
    for n in (1, 512, n_big):
        _, leaves = slice_pf.margin(Xd[:n].contiguous(), base,
                                    leaf_index=True)
        visits = int(depth[leaves.long()].sum())
        bounds[n] = walk_bound_ms(slice_pf, n, 28, visits)
        log(f"bound n={n}: {bounds[n][0]:.6f} ms ({bounds[n][1]}), "
            f"kernel at {bounds[n][0] / times[n] * 100:.4f}% of it")
    torch.cuda.synchronize()

    # launches: every main-path run of the kernel
    runs = [train_counts, deep_counts, small_counts,
            *two_counts.values(), *(c for c, _ in deep2.values())]
    kernels = [{
        "name": "walk_packed",
        "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "launches": (launches_predict + launches_serve
                     + sum(c["walk_packed"] for c in runs)),
        "max_abs_err": max(errs),
        "ms": times[n_big],
        "plain_ms": plain[n_big],
        "bound_ms": bounds[n_big][0],
        "bound_by": bounds[n_big][1],
        "library_ms": None,
    }]
    # times at the shape that takes most of each kernel's launches (K2:
    # the refine builds of coarse/fused)
    for name, replaces, shape in (
            ("hist_int8x2", ":621", (1_000_000, 128, 36)),
            ("hist_f32", ":634", (200_000, 512, 256)),
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
    ms, plain_ms, bound = fused_times[128]
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
