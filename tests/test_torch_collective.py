"""The host communicators, their resilient wrapper, fault injection and the
distributed aggregations: the port against the JAX package.

The counterparts of the JAX package's ``tests/test_distributed.py:69-120``
(the in-memory allreduce, the distributed sketch, the aggregator
helpers), ``tests/test_distributed_metrics.py:51-194`` (sharded metrics
equal to the global ones, ``sync_trees``, prune / refresh under a
communicator), ``tests/test_resilience.py:23-230`` (retry, desync,
corruption, timeout, fault plans, ``agree_round``) and its multi-rank
kill and agreed resume (``:326``), and ``tests/test_fault_injection.py``.
Ranks are threads of one process (``InMemoryCommunicator``). Cuts of the
distributed sketch are held bit for bit against the JAX package's;
sharded metrics against the global value at rel 1e-12; every other
comparison is exact.
"""

import os
import threading

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xt
from xgboost_tpu.parallel import collective as jcoll
from xgboost_tpu_torch.data.dmatrix import DataIter, MetaInfo
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.parallel import collective as C
from xgboost_tpu_torch.parallel import resilience as R
from xgboost_tpu_torch.parallel.collective import (
    FaultInjectionCommunicator, InMemoryCommunicator, NoOpCommunicator,
    set_thread_local_communicator)

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def run_world(world, fn, make=InMemoryCommunicator.make_world,
              thread_local=True):
    """``fn(comm, rank)`` on ``world`` thread ranks (each thread's
    communicator set when ``thread_local``) -> the results by rank;
    the first error raises."""
    comms = make(world)
    out, errors = [None] * world, []

    def worker(rank):
        if thread_local:
            set_thread_local_communicator(comms[rank])
        try:
            out[rank] = fn(comms[rank], rank)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            if thread_local:
                set_thread_local_communicator(None)

    ts = [threading.Thread(target=worker, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a rank deadlocked"
    if errors:
        raise errors[0]
    return out


def _shards(n, world):
    cuts = np.linspace(0, n, world + 1).astype(int)
    return [(cuts[r], cuts[r + 1]) for r in range(world)]


# ---- the communicators and the aggregator helpers ---------------------------

@pytest.mark.parametrize("op,want", [("sum", 10.0), ("max", 4.0),
                                     ("min", 1.0)])
def test_in_memory_allreduce(op, want):
    out = run_world(4, lambda c, r: c.allreduce(np.asarray([r + 1.0]), op))
    assert [o[0] for o in out] == [want] * 4


def test_bitwise_or_and_allgather():
    out = run_world(3, lambda c, r: (
        c.allreduce(np.asarray([1 << r], np.int64), "bitwise_or")[0],
        c.allgather_objects({"rank": r}), c.broadcast(f"r{r}", root=2)))
    for o in out:
        assert o[0] == 7
        assert o[1] == [{"rank": 0}, {"rank": 1}, {"rank": 2}]
        assert o[2] == "r2"


def test_noop_communicator_and_module_level_calls():
    comm = NoOpCommunicator()
    assert (comm.get_rank(), comm.get_world_size(),
            comm.is_distributed()) == (0, 1, False)
    assert C.get_world_size() == 1 and not C.is_distributed()
    np.testing.assert_array_equal(C.allreduce(np.arange(3.0)),
                                  np.arange(3.0))
    assert C.allgather("x") == ["x"] and C.broadcast(5) == 5
    C.notify_round(3)                       # a plain communicator ignores it
    with C.CommunicatorContext(comm) as c:
        assert c is comm and C.get_communicator() is comm
    with pytest.raises(ValueError, match="unknown communicator"):
        C.init("carrier-pigeon")
    # the federated communicator connects to its server (the gRPC case is
    # ``tests/test_torch_federated.py``); grpc is imported only there
    try:
        import grpc  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="grpc"):
            C.init("federated", federated_server_address="localhost:1",
                   federated_world_size=1, federated_rank=0)
    else:
        from xgboost_tpu_torch.parallel.federated import (
            FederatedCommunicator, run_federated_server)

        server = run_federated_server(1, port=0)
        try:
            C.init("federated",
                   federated_server_address=f"localhost:{server.port}",
                   federated_world_size=1, federated_rank=0)
            assert isinstance(C.get_communicator(), FederatedCommunicator)
            assert C.allgather("x") == ["x"]
        finally:
            C.finalize()
            server.stop(0)
    with pytest.raises(RuntimeError, match="init_distributed"):
        C.init("torch")                     # no process group here


def test_aggregator_helpers():
    """Reference ``aggregator.h``: GlobalSum / GlobalRatio /
    ApplyWithLabels over three thread ranks, as the JAX package's test."""
    def fn(c, r):
        return (C.global_sum(np.asarray([r + 1.0]), c)[0],
                C.global_ratio(r + 1.0, 2.0, c),
                C.apply_with_labels(lambda: "labels!", c),
                C.global_sum(np.asarray([r + 1.0]), c, row_split=False)[0])

    for r, (s, ratio, awl, local) in enumerate(run_world(3, fn)):
        assert (s, ratio, awl, local) == (6.0, 1.0, "labels!", r + 1.0)


def test_distributed_sketch_cuts_match_jax():
    """Cuts of the summary merge over 4 ranks, bit for bit against the JAX
    package's ``distributed_sketch`` of the same shards, and equal on
    every rank, each cut within 5% of the rows of a one-process cut."""
    rng = np.random.RandomState(9)
    X = rng.randn(4000, 5).astype(np.float32)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    shards = np.array_split(X, 4, axis=0)
    jout = run_world(4, lambda c, r: jcoll.distributed_sketch(
        shards[r], 32, comm=c), make=jcoll.InMemoryCommunicator.make_world,
        thread_local=False)
    tout = run_world(4, lambda c, r: C.distributed_sketch(shards[r], 32,
                                                          comm=c))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.values, jout[0].values)
        np.testing.assert_array_equal(t.ptrs, j.ptrs)
        np.testing.assert_array_equal(t.values, j.values)
        np.testing.assert_array_equal(t.min_vals, j.min_vals)
    # the merged summaries are pruned: each cut near a one-process cut's
    # quantile (the JAX package's test's rank-space bound)
    single = xt.DMatrix(X).cuts(32)
    d = tout[0]
    for f in range(5):
        col = np.sort(X[:, f][~np.isnan(X[:, f])])
        a = d.values[d.ptrs[f]:d.ptrs[f + 1] - 1]
        b = single.values[single.ptrs[f]:single.ptrs[f + 1] - 1]
        k = min(len(a), len(b))
        assert np.abs(np.searchsorted(col, a[:k]) - np.searchsorted(
            col, b[:k])).max() / len(col) < 0.05


def test_sketch_merge_refuses_ragged_features():
    def fn(c, r):
        X = np.zeros((10, 3 if r == 0 else 2), np.float32)
        return C.distributed_sketch(X, 8, comm=c)

    with pytest.raises(ValueError, match="disagree on feature count"):
        run_world(2, fn)


# ---- metrics and updaters across ranks --------------------------------------

@pytest.mark.parametrize("name", ["rmse", "mae", "logloss", "error",
                                  "merror", "mlogloss", "auc", "aucpr"])
def test_sharded_metric_equals_global(name):
    rng = np.random.RandomState(7)
    n = 400
    y = (rng.rand(n) > 0.4).astype(np.float32)
    p = np.clip(rng.rand(n) * 0.6 + y * 0.3, 1e-6, 1 - 1e-6)
    if name in ("merror", "mlogloss"):
        p = np.stack([1 - p, p], 1)
    w = (rng.rand(n) + 0.5).astype(np.float32)
    want = get_metric(name)(p, MetaInfo(labels=y, weights=w))

    def fn(c, r):
        s, e = _shards(n, 3)[r]
        return get_metric(name)(p[s:e], MetaInfo(labels=y[s:e],
                                                 weights=w[s:e]))

    for val in run_world(3, fn):
        assert val == pytest.approx(want, rel=1e-12), name


def test_sharded_ndcg_equals_global():
    """Query groups whole on each rank: ``ndcg@3`` of the shards equals
    the global value (the queries' sums add across ranks)."""
    rng = np.random.RandomState(11)
    n_groups, gsize = 12, 10
    n = n_groups * gsize
    y = rng.randint(0, 4, n).astype(np.float32)
    p = rng.rand(n)
    info = MetaInfo(labels=y)
    info.set_group(np.full(n_groups, gsize))
    want = get_metric("ndcg@3")(p, info)

    def fn(c, r):
        g0, g1 = r * 4, (r + 1) * 4
        loc = MetaInfo(labels=y[g0 * gsize:g1 * gsize])
        loc.set_group(np.full(g1 - g0, gsize))
        return get_metric("ndcg@3")(p[g0 * gsize:g1 * gsize], loc)

    for val in run_world(3, fn):
        assert val == pytest.approx(want, rel=1e-12)


def test_col_split_metrics_skip_reduction():
    rng = np.random.RandomState(5)
    y = (rng.rand(200) > 0.5).astype(np.float32)
    p = np.clip(rng.rand(200), 1e-6, 1 - 1e-6)
    want = get_metric("logloss")(p, MetaInfo(labels=y))
    out = run_world(2, lambda c, r: get_metric("logloss")(
        p, MetaInfo(labels=y, data_split_mode="col")))
    assert all(v == pytest.approx(want, rel=1e-12) for v in out)


@pytest.mark.parametrize("name", ["auc", "aucpr"])
def test_large_auc_curve_merge(name, monkeypatch):
    """Above ``XTPU_AUC_EXACT_MAX`` the ranks' local curves are merged
    (rank-independent, within 0.01 of the exact value at 4 x 2,500
    rows); below it the gathered rows give the exact value."""
    rng = np.random.RandomState(11)
    n = 10_000
    y = (rng.rand(n) > 0.5).astype(np.float32)
    p = np.clip(rng.rand(n) * 0.5 + y * 0.35, 1e-6, 1 - 1e-6)
    w = (rng.rand(n) + 0.5).astype(np.float32)
    exact = get_metric(name)(p, MetaInfo(labels=y, weights=w))

    def fn(c, r):
        s, e = _shards(n, 4)[r]
        return get_metric(name)(p[s:e], MetaInfo(labels=y[s:e],
                                                 weights=w[s:e]))

    monkeypatch.setenv("XTPU_AUC_EXACT_MAX", "1000")
    merged = run_world(4, fn)
    assert len(set(merged)) == 1 and abs(merged[0] - exact) < 0.01
    monkeypatch.setenv("XTPU_AUC_EXACT_MAX", "1000000")
    assert all(v == pytest.approx(exact, abs=1e-12)
               for v in run_world(4, fn))


def _small_model(objective="binary:logistic", seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(300, 5).astype(np.float32)
    y = ((X[:, 0] > 0).astype(np.float32) if objective == "binary:logistic"
         else (X[:, 0] + 0.1 * rng.randn(300)).astype(np.float32))
    bst = xt.train({"objective": objective, "max_depth": 4, "gamma": 0.0,
                    "device": "cpu"}, xt.DMatrix(X, label=y), 2,
                   verbose_eval=False)
    return bst, X, y


def test_sync_trees_broadcasts_rank0():
    from xgboost_tpu_torch.tree.updaters import sync_trees

    bst, _, _ = _small_model()
    trees = bst.gbm.trees
    out = run_world(2, lambda c, r: sync_trees(list(trees) if r == 0
                                               else [], communicator=c))
    assert len(out[1]) == len(trees)
    for a, b in zip(trees, out[1]):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert sync_trees(trees, communicator=NoOpCommunicator()) is trees


def test_prune_refresh_under_communicator():
    """prune / refresh are rank-local on replicated trees: two ranks agree
    bit for bit, and the update process trains under a communicator."""
    from xgboost_tpu_torch.tree.param import TrainParam
    from xgboost_tpu_torch.tree.updaters import prune_tree, refresh_tree

    bst, X, y = _small_model("reg:squarederror", seed=1)
    raw = bytes(bst.save_raw("json"))       # a booster of its own a rank
    param = TrainParam()
    param.update_allow_unknown({"gamma": 0.5, "eta": 0.3})
    gpair = np.stack([y - y.mean(), np.ones_like(y)], 1).astype(np.float32)

    def fn(c, r):
        t = refresh_tree(prune_tree(bst.gbm.trees[0], param), X, gpair,
                         param)
        upd = xt.train({"device": "cpu", "process_type": "update",
                        "updater": "refresh,prune,sync"},
                       xt.DMatrix(X, label=y), 2, xgb_model=raw,
                       verbose_eval=False)
        return t.leaf_value.copy(), t.sum_hess.copy(), bytes(
            upd.save_raw("ubj"))

    a, b = run_world(2, fn)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_base_score_sums_across_ranks():
    """The intercept's gradient sums cross the ranks (``GlobalSum``), so
    every rank derives one base score from its rows, the whole matrix's
    to float rounding."""
    from xgboost_tpu_torch.objective import get_objective

    rng = np.random.RandomState(2)
    y = (rng.rand(1000) < 0.3).astype(np.float32)
    obj = get_objective("binary:logistic")
    want = obj.init_estimation(torch.from_numpy(y))
    out = run_world(2, lambda c, r: obj.init_estimation(
        torch.from_numpy(y[r * 500:(r + 1) * 500])))
    assert out[0] == out[1]
    np.testing.assert_allclose(out[0], want, rtol=1e-6)


def test_resident_training_under_a_world_refuses():
    """``_check_row_comm_sync`` (the JAX package's words): a resident
    matrix under a multi-rank communicator would fit its rows alone."""
    X = np.random.RandomState(0).randn(100, 3).astype(np.float32)

    def fn(c, r):
        with pytest.raises(NotImplementedError, match="not synchronized"):
            xt.train({"device": "cpu"}, xt.DMatrix(X, label=X[:, 0]), 1,
                     verbose_eval=False)
        return True

    assert run_world(2, fn) == [True, True]


# ---- resilience -------------------------------------------------------------

def test_retry_recovers_transient_fault():
    faulty = R.FaultyCommunicator(
        NoOpCommunicator(), R.FaultPlan(fail_at_op=2, transient=True))
    rc = R.ResilientCommunicator(faulty, R.RetryPolicy(base_delay_s=0.001))
    assert rc.allreduce(np.ones(3))[0] == 1.0
    assert rc.allreduce(np.full(3, 2.0))[0] == 2.0
    assert rc.stats["retries"] == 1


def test_permanent_fault_not_retried():
    rc = R.ResilientCommunicator(
        R.FaultyCommunicator(NoOpCommunicator(),
                             R.FaultPlan(fail_at_op=1, transient=False)),
        R.RetryPolicy(base_delay_s=0.001))
    with pytest.raises(R.CollectiveFault):
        rc.allreduce(np.ones(2))
    assert rc.stats["retries"] == 0


def test_retries_are_bounded():
    rc = R.ResilientCommunicator(
        R.FaultyCommunicator(NoOpCommunicator(), R.FaultPlan(
            fail_at_op=None, flaky_p=1.0, max_failures=None)),
        R.RetryPolicy(max_retries=2, base_delay_s=0.001))
    with pytest.raises(R.TransientCollectiveError):
        rc.allreduce(np.ones(2))
    assert rc.stats["retries"] == 2


def test_flaky_schedule_completes_under_retries():
    rc = R.ResilientCommunicator(
        R.FaultyCommunicator(NoOpCommunicator(), R.FaultPlan(
            fail_at_op=None, flaky_p=0.4, seed=42, max_failures=None)),
        R.RetryPolicy(max_retries=8, base_delay_s=0.0))
    for i in range(30):
        assert rc.allreduce(np.asarray([float(i)]))[0] == float(i)
    assert rc.stats["retries"] > 0


@pytest.mark.parametrize("kind", ["op", "label"])
def test_desync_raises_typed_error_on_all_ranks(kind):
    """Mismatched op kinds, or the same op at two call sites
    (``op_context``), raise ``CollectiveDesync`` on both ranks."""
    def fn(c, r):
        rc = R.ResilientCommunicator(c)
        try:
            if kind == "op":
                rc.allreduce(np.ones(4, np.float32),
                             op="sum" if r == 0 else "max")
            else:
                with R.op_context("paged/hist" if r == 0
                                  else "sketch/merge"):
                    rc.allreduce(np.ones(4, np.float32))
            return "ok"
        except R.CollectiveDesync as e:
            assert e.rank == r and e.seq == 0
            return "desync"

    assert run_world(2, fn, thread_local=False) == ["desync", "desync"]


def test_allreduce_corruption_caught_by_control_sum():
    rc = R.ResilientCommunicator(R.FaultyCommunicator(
        NoOpCommunicator(), R.FaultPlan(fail_at_op=None, corrupt_at_op=1)))
    with pytest.raises(R.CollectiveCorruption):
        rc.allreduce(np.ones(5, np.float64))
    assert rc.stats["corruptions"] == 1


def test_allgather_corruption_caught_by_crc():
    def fn(c, r):
        plan = R.FaultPlan(fail_at_op=None,
                           corrupt_at_op=1 if r == 0 else None)
        rc = R.ResilientCommunicator(R.FaultyCommunicator(c, plan))
        try:
            rc.allgather_objects({"rank": r})
            return "ok"
        except R.CollectiveCorruption:
            return "corrupt"

    assert run_world(2, fn, thread_local=False)[0] == "corrupt"


def test_latency_injection_trips_timeout():
    rc = R.ResilientCommunicator(
        R.FaultyCommunicator(NoOpCommunicator(), R.FaultPlan(
            fail_at_op=None, latency_s=0.3, max_failures=0)),
        R.RetryPolicy(timeout_s=0.05))
    with pytest.raises(R.CollectiveTimeout):
        rc.allreduce(np.ones(2))
    rc2 = R.ResilientCommunicator(
        R.FaultyCommunicator(NoOpCommunicator(), R.FaultPlan(
            fail_at_op=None, latency_s=0.01, max_failures=0)),
        R.RetryPolicy(timeout_s=5.0))
    assert rc2.allreduce(np.ones(2))[0] == 1.0


def test_fault_plan_round_schedule():
    faulty = R.FaultyCommunicator(
        NoOpCommunicator(),
        R.FaultPlan(fail_at_op=2, fail_round=3, transient=False))
    faulty.on_round(2)
    faulty.allreduce(np.ones(1))
    faulty.allreduce(np.ones(1))
    faulty.on_round(3)
    faulty.allreduce(np.ones(1))
    with pytest.raises(R.CollectiveFault, match="round 3"):
        faulty.allreduce(np.ones(1))
    faulty.on_round(3)                  # fail-once: no second fault
    faulty.allreduce(np.ones(1))
    faulty.allreduce(np.ones(1))


def test_fault_plan_validation():
    for kw in ({"fail_at_op": 0}, {"op_filter": "broadcast"},
               {"corrupt_at_op": 0}):
        with pytest.raises(ValueError):
            R.FaultPlan(**kw)


def test_resilient_wrapper_preserves_plain_values():
    rc = R.ResilientCommunicator(NoOpCommunicator())
    x = np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5
    out = rc.allreduce(x)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_array_equal(out, x)
    assert rc.allgather_objects({"a": 1}) == [{"a": 1}]
    xi = np.asarray([3, 5], np.int64)
    np.testing.assert_array_equal(rc.allreduce(xi, op="max"), xi)
    fam = R.ResilientCommunicator._collect_obs(rc)
    assert fam[0].name == "xtpu_collective_events_total"


def test_resilient_sketch_matches_plain():
    """The wrapper's framing is invisible to the sketch merge: the same
    cuts as the plain communicators give."""
    rng = np.random.RandomState(3)
    X = rng.randn(600, 3).astype(np.float32)
    shards = np.array_split(X, 2)
    plain = run_world(2, lambda c, r: C.distributed_sketch(shards[r], 16,
                                                           comm=c))
    wrapped = run_world(2, lambda c, r: C.distributed_sketch(
        shards[r], 16, comm=R.resilient(c)))
    np.testing.assert_array_equal(plain[0].values, wrapped[1].values)


def test_agree_round_is_min_across_ranks():
    assert run_world(2, lambda c, r: R.agree_round(6 if r == 0 else 4,
                                                   comm=c)) == [4, 4]
    assert R.agree_round(7, comm=NoOpCommunicator()) == 7


# ---- fault injection --------------------------------------------------------

def test_injected_fault_fires_at_exact_call():
    comm = FaultInjectionCommunicator(NoOpCommunicator(), fail_at=3)
    comm.allreduce(np.ones(2))
    comm.allgather_objects("x")
    with pytest.raises(FaultInjectionCommunicator.InjectedFault, match="#3"):
        comm.allreduce(np.ones(2))
    assert comm.allreduce(np.ones(2))[0] == 1.0
    with pytest.raises(ValueError):
        FaultInjectionCommunicator(NoOpCommunicator(), fail_at=0)


def test_op_filter_counts_only_matching_kind():
    comm = FaultInjectionCommunicator(NoOpCommunicator(), fail_at=2,
                                      op_filter="allgather")
    for _ in range(5):
        comm.allreduce(np.ones(1))
    comm.allgather_objects(1)
    with pytest.raises(FaultInjectionCommunicator.InjectedFault):
        comm.allgather_objects(2)


def test_sketch_fault_surfaces_on_all_ranks():
    """A failed collective inside the sketch merge raises on every rank:
    never a hang, never rank-divergent cuts."""
    X = np.random.RandomState(0).randn(400, 3).astype(np.float32)
    shards = np.array_split(X, 2)

    def fn(c, r):
        comm = FaultInjectionCommunicator(c, fail_at=1,
                                          op_filter="allgather")
        try:
            C.distributed_sketch(shards[r], 16, comm=comm)
            return "ok"
        except FaultInjectionCommunicator.InjectedFault:
            return "fault"

    assert run_world(2, fn, thread_local=False) == ["fault", "fault"]


def test_global_sum_through_injection_wrapper():
    out = run_world(2, lambda c, r: C.global_sum(np.asarray([r + 1.0])),
                    make=lambda w: [FaultInjectionCommunicator(c, fail_at=99)
                                    for c in InMemoryCommunicator.make_world(
                                        w)])
    assert out[0][0] == out[1][0] == 3.0


def test_failing_training_collective_raises_on_every_rank(monkeypatch,
                                                          tmp_path):
    """A collective that fails inside training raises a CollectiveError on
    both ranks; neither goes on with its local rows."""
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    rng = np.random.RandomState(1)
    X = rng.randn(400, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)

    def fn(c, r):
        set_thread_local_communicator(R.FaultyCommunicator(
            c, R.FaultPlan(fail_round=1, transient=False)))
        dm = xt.QuantileDMatrix(_OneShot(X[r::2], y[r::2],
                                         str(tmp_path / f"f{r}")),
                                max_bin=16)
        with pytest.raises(R.CollectiveError):
            xt.train({"device": "cpu", "max_bin": 16,
                      "objective": "binary:logistic"}, dm, 3,
                     verbose_eval=False)
        return True

    assert run_world(2, fn, thread_local=False) == [True, True]


# ---- the iterator's retry ---------------------------------------------------

class _OneShot(DataIter):
    def __init__(self, X, y, prefix=None):
        super().__init__(cache_prefix=prefix)
        self.X, self.y, self.done = X, y, False

    def next(self, input_data):
        if self.done:
            return 0
        self.done = True
        input_data(data=self.X, label=self.y)
        return 1

    def reset(self):
        self.done = False


def test_iterator_next_is_retried(monkeypatch):
    """A ``next()`` that fails once is retried (the JAX package's
    ``_retry_io``): the matrix is the one a clean iterator gives; a
    failure past ``XTPU_IO_RETRIES`` raises."""
    X = np.random.RandomState(0).randn(50, 3).astype(np.float32)

    class Flaky(_OneShot):
        fails = 1

        def next(self, input_data):
            if Flaky.fails:
                Flaky.fails -= 1
                input_data(data=X[:5])          # a partial batch, dropped
                raise OSError("transient read failure")
            return super().next(input_data)

    monkeypatch.setenv("XTPU_IO_RETRIES", "2")
    got = xt.QuantileDMatrix(Flaky(X, X[:, 0]), max_bin=16)
    want = xt.QuantileDMatrix(_OneShot(X, X[:, 0]), max_bin=16)
    assert got.num_row() == 50
    np.testing.assert_array_equal(got.cuts(16).values, want.cuts(16).values)
    Flaky.fails = 5
    with pytest.raises(OSError, match="transient"):
        xt.QuantileDMatrix(Flaky(X, X[:, 0]), max_bin=16)


# ---- a multi-rank kill and the agreed resume --------------------------------

def test_multirank_kill_and_agreed_resume_bitexact(tmp_path, monkeypatch):
    """Both ranks of the paged tier die on an injected fault in round 5,
    resume from the last AGREED snapshot (round 4, the minimum across
    ranks) and land on the straight 2-rank run's bytes (the JAX package's
    ``test_multirank_kill_and_agreed_resume_bitexact``)."""
    monkeypatch.setenv("XTPU_PAGE_ROWS", "200")
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    rng = np.random.RandomState(5)
    X = rng.randn(1600, 5).astype(np.float32)
    y = (X @ rng.randn(5) > 0).astype(np.float32)
    shards = [(X[:800], y[:800]), (X[800:], y[800:])]
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
              "max_bin": 16, "device": "cpu"}

    def world(tag, plan=None, ck=True):
        def fn(c, r):
            if plan is not None:
                c = R.FaultyCommunicator(c, plan())
            set_thread_local_communicator(c)
            qdm = xt.QuantileDMatrix(_OneShot(*shards[r], str(
                tmp_path / f"{tag}{r}")), max_bin=16)
            cfg = (xt.CheckpointConfig(str(tmp_path / f"ck{r}"),
                                       every_n_rounds=2) if ck else None)
            try:
                return bytes(xt.train(params, qdm, 8, checkpoint=cfg,
                                      verbose_eval=False).save_raw("ubj"))
            except R.CollectiveFault as e:
                return e

        return run_world(2, fn, thread_local=False)

    straight = world("s", ck=False)
    assert straight[0] == straight[1]
    killed = world("k", plan=lambda: R.FaultPlan(fail_round=5,
                                                  transient=False))
    assert all(isinstance(e, R.CollectiveFault) for e in killed)
    resumed = world("r")
    assert resumed[0] == resumed[1] == straight[0]


def test_resume_round_agreed_across_ranks(tmp_path):
    """One rank holds snapshots to round 4, the other to round 2: both
    resume from round 2, the round both hold."""
    from xgboost_tpu_torch.utils.checkpoint import (CheckpointConfig,
                                                    CheckpointManager)

    X = np.random.RandomState(0).randn(200, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    p = {"device": "cpu", "objective": "binary:logistic"}
    for r, rounds in ((0, 4), (1, 2)):
        xt.train(p, xt.DMatrix(X, label=y), rounds, checkpoint=(
            CheckpointConfig(str(tmp_path / f"c{r}"), every_n_rounds=2)))

    def fn(c, r):
        m = CheckpointManager(CheckpointConfig(str(tmp_path / f"c{r}"),
                                               every_n_rounds=2))
        return m.find_resume(xt.DMatrix(X, label=y)).round

    assert run_world(2, fn) == [2, 2]


def test_rabit_shim_forwards():
    from xgboost_tpu_torch import rabit

    with pytest.warns(FutureWarning):
        assert rabit.get_world_size() == 1
    with pytest.warns(FutureWarning):
        np.testing.assert_array_equal(
            rabit.allreduce(np.ones(2), rabit.Op.SUM), np.ones(2))
    with pytest.warns(FutureWarning):
        assert rabit.broadcast("x") == "x"


def test_tracker_hands_out_a_rendezvous(tmp_path):
    from xgboost_tpu_torch.parallel.tracker import Tracker

    t = Tracker(2)
    args = t.worker_args()
    assert args["init_method"].startswith("tcp://127.0.0.1:")
    assert args["MASTER_PORT"] == str(t.port) and args["n_workers"] == 2
    f = Tracker(3, file_path=str(tmp_path / "rdv")).worker_args()
    assert f["init_method"] == "file://" + str(tmp_path / "rdv")
    with pytest.raises(ValueError):
        Tracker(0)
