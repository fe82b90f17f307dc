"""External memory under a communicator: each rank streams its own pages.

The counterparts of the JAX package's ``tests/test_external_memory.py``
cases ``:143`` (paged training under a communicator), ``:391`` (paged
lossguide under it), ``:556`` (the collapse respects the budget and the
communicator) and ``:627`` (a communicator after a collapse refuses a
continuation). Two thread ranks (``InMemoryCommunicator``), each with its
own iterator and disk cache: the iterator's summaries merge across the
ranks, each level's histograms and the root's sums are summed across
them on the host (``tree/paged.py``), and both ranks must save the same
bytes. The port's two ranks are held against the JAX package's two
ranks (its paged tier with ``hist_method="prehot"``, per page the int8x2
arithmetic of K2 / K4) under ``tests/test_torch_train.py
compare_forests``' near-tie certificate, leaves and predictions at rtol
1e-5 plus ``LEAF_ATOL``; and against one rank over the pooled rows
(the same batches: identical cuts, the sums only reassociated).
"""

import threading

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.parallel import collective as jcoll
from xgboost_tpu_torch.parallel.collective import (
    InMemoryCommunicator, set_thread_local_communicator)

from test_data_iterator import BatchIter
from test_torch_paged import PortIter, _data
from test_torch_train import LEAF_ATOL, compare_forests

ENV = {"XTPU_PAGE_ROWS": "500", "XTPU_PAGED_COLLAPSE": "0",
       "XTPU_BATCH_ROUNDS": "1"}


def _env(monkeypatch, **kw):
    for k, v in dict(ENV, **kw).items():
        monkeypatch.setenv(k, str(v))


def _world(make, set_tl, fn, world=2):
    comms = make(world)
    out, errors = [None] * world, []

    def worker(rank):
        set_tl(comms[rank])
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            set_tl(None)

    ts = [threading.Thread(target=worker, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not any(t.is_alive() for t in ts), "a rank deadlocked"
    if errors:
        raise errors[0]
    return out


def _ranks(X, y, params, rounds, tmp_path, tag):
    """The port's and the JAX package's two thread ranks, each over its
    half of the rows in one batch -> ((port bytes, port model) by rank,
    JAX model of rank 0)."""
    half = len(y) // 2
    shards = [(X[:half], y[:half]), (X[half:], y[half:])]

    def port(rank):
        Xr, yr = shards[rank]
        qdm = xt.QuantileDMatrix(PortIter(Xr, yr, 1, cache_prefix=str(
            tmp_path / f"t{tag}{rank}")), max_bin=params["max_bin"])
        b = xt.train(dict(params, device="cpu"), qdm, rounds,
                     verbose_eval=False)
        assert qdm.binned(params["max_bin"], torch.device("cpu")).is_paged
        return bytes(b.save_raw("ubj")), b

    def jax(rank):
        Xr, yr = shards[rank]
        it = BatchIter(Xr, yr, n_batches=1)
        it.cache_prefix = str(tmp_path / f"j{tag}{rank}")
        return xgb.train(dict(params, hist_method="prehot"),
                         xgb.QuantileDMatrix(it, max_bin=params["max_bin"]),
                         rounds, verbose_eval=False)

    tout = _world(InMemoryCommunicator.make_world,
                  set_thread_local_communicator, port)
    jout = _world(jcoll.InMemoryCommunicator.make_world,
                  jcoll.set_thread_local_communicator, jax)
    return tout, jout[0]


def _pooled(X, y, params, rounds, tmp_path, tag):
    """One rank over the pooled rows, batched as the ranks see them."""
    qdm = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / f"p{tag}")), max_bin=params["max_bin"])
    return xt.train(dict(params, device="cpu"), qdm, rounds,
                    verbose_eval=False)


# (case, params, rounds, trees in full against the JAX ranks and against
# one rank over the pooled rows, as measured on the CPU)
CASES = [
    ("depthwise", {"objective": "binary:logistic", "max_depth": 4,
                   "eta": 0.3, "max_bin": 64}, 5, 5, 5),
    ("lossguide", {"objective": "binary:logistic", "eta": 0.3,
                   "max_bin": 64, "grow_policy": "lossguide",
                   "max_leaves": 8, "max_depth": 0}, 3, 3, 3),
    ("vector_leaves", {"objective": "reg:squarederror", "max_depth": 3,
                       "eta": 0.3, "max_bin": 32,
                       "multi_strategy": "multi_output_tree"}, 3, 3, 3),
]


@pytest.mark.parametrize("case,params,rounds,jax_min,pooled_min", CASES,
                         ids=[c[0] for c in CASES])
def test_paged_ranks_match_jax_ranks(case, params, rounds, jax_min,
                                     pooled_min, tmp_path, monkeypatch):
    _env(monkeypatch)
    X, y = _data(9, n=6000 if case == "depthwise" else 2000)
    if case == "vector_leaves":
        rng = np.random.RandomState(4)
        y = np.stack([np.nan_to_num(X) @ rng.randn(X.shape[1])
                      for _ in range(2)], 1).astype(np.float32)
    (tout, jb) = _ranks(X, y, params, rounds, tmp_path, case)
    (raw0, b0), (raw1, _) = tout
    assert raw0 == raw1, "the two ranks saved different models"
    capped = case == "lossguide"
    full, ties, drift = compare_forests(jb.gbm.trees, b0.gbm.trees, 0.3,
                                        capped=capped)
    print(f"{case}: port ranks vs JAX ranks {full} in full, ties {ties}, "
          f"drift {drift:.3e}")
    assert full >= jax_min
    np.testing.assert_allclose(
        b0.predict(xt.DMatrix(X), iteration_range=(0, full)),
        jb.predict(xgb.DMatrix(X), iteration_range=(0, full)), rtol=1e-5,
        atol=LEAF_ATOL)
    one = _pooled(X, y, params, rounds, tmp_path, case)
    full1, ties1, _ = compare_forests(one.gbm.trees, b0.gbm.trees, 0.3,
                                      capped=capped)
    assert full1 >= pooled_min, ties1
    np.testing.assert_allclose(b0.predict(xt.DMatrix(X)),
                               one.predict(xt.DMatrix(X)), rtol=1e-5,
                               atol=LEAF_ATOL)


def test_ranks_run_the_page_kernels_and_merge_cuts(tmp_path, monkeypatch):
    """Each rank's cuts are the merge of both ranks' summaries (the same
    on every rank), its matrix stays paged, and its histogram builds
    are its own pages' (the levels times its 3 pages)."""
    _env(monkeypatch)
    import xgboost_tpu_torch.ops.histogram as H

    X, y = _data(3, n=3000)
    calls = [0, 0]
    real = H.build_hist_int8x2_reference
    local = threading.local()

    def counted(*a, **k):
        calls[local.rank] += 1
        return real(*a, **k)

    monkeypatch.setattr(H, "build_hist_int8x2_reference", counted)

    def fn(rank):
        local.rank = rank
        Xr, yr = X[rank * 1500:(rank + 1) * 1500], y[rank * 1500:
                                                      (rank + 1) * 1500]
        qdm = xt.QuantileDMatrix(PortIter(Xr, yr, 1, cache_prefix=str(
            tmp_path / f"c{rank}")), max_bin=32)
        xt.train({"device": "cpu", "max_depth": 3, "max_bin": 32,
                  "hist_method": "pallas"}, qdm, 2, verbose_eval=False)
        paged = qdm.binned(32, torch.device("cpu"))
        return paged.cuts.values.copy(), paged.is_paged, paged.n_pages()

    out = _world(InMemoryCommunicator.make_world,
                 set_thread_local_communicator, fn)
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] and out[1][1] and out[0][2] == 3
    assert calls == [2 * 3 * 3, 2 * 3 * 3]


def test_paged_collapse_respects_budget_and_comm(tmp_path, monkeypatch):
    """No collapse under a multi-rank communicator (the per-level
    allreduce is the row-split sync); a world of one may collapse."""
    _env(monkeypatch, XTPU_PAGE_CACHE_BYTES=str(4 << 30))
    monkeypatch.delenv("XTPU_PAGED_COLLAPSE")
    X, y = _data(22, n=3000)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 64,
              "device": "cpu"}

    def train(tag, rows):
        qdm = xt.QuantileDMatrix(PortIter(X[rows], y[rows], 1,
                                          cache_prefix=str(tmp_path / tag)),
                                 max_bin=64)
        bst = xt.train(params, qdm, 2, verbose_eval=False)
        st = next(iter(bst._caches.values()))
        return st["binned"].is_paged

    one = _world(InMemoryCommunicator.make_world,
                 set_thread_local_communicator,
                 lambda r: train("w1", slice(None)), world=1)
    assert one == [False]                   # a world of one collapses
    two = _world(InMemoryCommunicator.make_world,
                 set_thread_local_communicator,
                 lambda r: train(f"w2_{r}", slice(r * 1500,
                                                  (r + 1) * 1500)))
    assert two == [True, True]


def test_collapse_then_communicator_continuation_refused(tmp_path,
                                                         monkeypatch):
    """A communicator activated after a booster's entry collapsed refuses
    further training on that booster (the entry is resident: the rank
    would fit its rows alone)."""
    _env(monkeypatch, XTPU_PAGE_CACHE_BYTES=str(4 << 30))
    monkeypatch.delenv("XTPU_PAGED_COLLAPSE")
    X, y = _data(23, n=1500)
    qdm = xt.QuantileDMatrix(PortIter(X, y, 3, cache_prefix=str(
        tmp_path / "cc")), max_bin=64)
    bst = xt.train({"objective": "binary:logistic", "max_depth": 3,
                    "max_bin": 64, "device": "cpu"}, qdm, 2,
                   verbose_eval=False)
    assert not next(iter(bst._caches.values()))["binned"].is_paged
    set_thread_local_communicator(InMemoryCommunicator.make_world(2)[0])
    try:
        with pytest.raises(NotImplementedError, match="not synchronized"):
            bst.update(qdm, 2)
    finally:
        set_thread_local_communicator(None)


def test_paged_approx_resketch_merges_across_ranks(tmp_path, monkeypatch):
    """``approx`` over pages under a communicator: each round's hessian
    re-sketch merges the ranks' summaries, so both ranks bin alike and
    save one model."""
    _env(monkeypatch)
    X, y = _data(5, n=2000)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
              "tree_method": "approx", "device": "cpu"}

    def fn(rank):
        qdm = xt.QuantileDMatrix(PortIter(X[rank::2], y[rank::2], 1,
                                          cache_prefix=str(
                                              tmp_path / f"a{rank}")),
                                 max_bin=32)
        return bytes(xt.train(params, qdm, 2,
                              verbose_eval=False).save_raw("ubj"))

    a, b = _world(InMemoryCommunicator.make_world,
                  set_thread_local_communicator, fn)
    assert a == b
