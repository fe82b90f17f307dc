#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xgboost_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``xgboost_tpu_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the slice's main path at the HIGGS shape (500 trees of depth 8
over 28 features, ``binary:logistic``, made from a seed):
``Booster.predict`` on 100,000 rows and a ``Server`` answering 200
requests of 1/8/64/512 rows from 4 threads. It checks that both went
through the kernel, that every served answer equals ``Booster.predict``
bit for bit, and times the kernel, its plain version and its bound.

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops.cuda import build
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

    # ------------------------------------------------------- times on card
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
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

    kernels = [{
        "name": "walk_packed",
        "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "launches": launches_predict + launches_serve,
        "max_abs_err": max(errs),
        "ms": times[n_big],
        "plain_ms": plain[n_big],
        "bound_ms": bounds[n_big][0],
        "bound_by": bounds[n_big][1],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
