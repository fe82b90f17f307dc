"""Vertical federated training: the port's parties against the pooled model.

The counterparts of the JAX package's ``tests/test_vertical_federated.py``
(all 15 cases): parties hold contiguous, deliberately unequal blocks of
the features of every row (``_column_blocks``), only rank 0 holds
labels, every ``DMatrix`` is built with ``data_split_mode="col"``, and
the parties are ``InMemoryCommunicator`` threads (or, in the gRPC case,
``FederatedCommunicator`` clients of a ``run_federated_server`` on port
0). Every party must hold the model the port trains on the pooled
columns on one device: the dumps equal (stats included, as the JAX
package's tests hold them), the trees node by node and the predictions
at rtol 1e-5 + atol 1e-5. The port's pooled model is held against the
JAX package's (``hist_method="prehot"``) under ``tests/test_torch_train.py
compare_forests``' near-tie certificate. The JAX package's ``slow``
marks are kept.
"""

import os
import threading

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.parallel import collective
from xgboost_tpu_torch.parallel.collective import InMemoryCommunicator

from test_torch_train import compare_forests

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
          "max_bin": 64}


def _column_blocks(F, world):
    """Contiguous rank-ordered feature blocks, deliberately unequal."""
    cuts = np.linspace(0, F, world + 1).astype(int)
    return [(cuts[r], cuts[r + 1]) for r in range(world)]


def run_threads(world, fn, comms=None):
    comms = comms or InMemoryCommunicator.make_world(world)
    results = [None] * world
    errors = []

    def worker(rank):
        collective.set_thread_local_communicator(comms[rank])
        try:
            results[rank] = fn(comms[rank], rank)
        except Exception as e:  # surfaced below
            import traceback

            traceback.print_exc()
            errors.append(e)
        finally:
            collective.set_thread_local_communicator(None)

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return results


def _make_data(n=2000, F=9, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = rng.randn(F).astype(np.float32)
    y = (X @ w + 0.3 * rng.randn(n).astype(np.float32) > 0).astype(
        np.float32)
    return X, y


def _train_vertical(params, X, y, comm, rank, rounds=5, **dm_kw):
    lo, hi = _column_blocks(X.shape[1], comm.get_world_size())[rank]
    ft = dm_kw.pop("feature_types", None)
    dm = xt.DMatrix(X[:, lo:hi], label=y if rank == 0 else None,
                    data_split_mode="col",
                    feature_types=None if ft is None else ft[lo:hi],
                    **dm_kw)
    return xt.train(dict(params, data_split_mode="col", device="cpu"), dm,
                    rounds, verbose_eval=False)


def pooled(params, X, y, rounds, jax_min=None, capped=False, **dm_kw):
    """The port's pooled one-device model; with ``jax_min``, also held
    against the JAX package's pooled model (at least that many trees in
    full, as measured on the CPU)."""
    b = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y, **dm_kw),
                 rounds, verbose_eval=False)
    if jax_min is not None:
        jb = xgb.train(dict(params, hist_method="prehot"),
                       xgb.DMatrix(X, label=y, **dm_kw), rounds,
                       verbose_eval=False)
        full, ties, _ = compare_forests(jb.gbm.trees, b.gbm.trees,
                                        params.get("eta", 0.3),
                                        capped=capped)
        print(f"port pooled vs JAX pooled: {full} trees in full, ties {ties}")
        assert full >= jax_min
    return b


def same_model(bst, ref):
    """A party's model against the pooled one: the dump (stats included)
    and the trees node by node."""
    assert bst.get_dump(with_stats=True) == ref.get_dump(with_stats=True)
    for ta, tb in zip(ref.gbm.trees, bst.gbm.trees):
        for f in ("split_feature", "split_bin", "default_left", "is_leaf",
                  "is_cat_split", "cat_words"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        np.testing.assert_allclose(tb.leaf_value, ta.leaf_value, **TOL)


def test_vertical_matches_pooled_inmemory():
    X, y = _make_data()
    ref = pooled(PARAMS, X, y, 5, jax_min=5)
    for bst in run_threads(3, lambda c, r: _train_vertical(PARAMS, X, y, c,
                                                           r)):
        same_model(bst, ref)


@pytest.mark.slow
def test_vertical_colsample_subsample_matches_pooled():
    params = dict(PARAMS, colsample_bytree=0.7, colsample_bylevel=0.8,
                  subsample=0.8, seed=11)
    X, y = _make_data(n=1500, F=10, seed=7)
    ref = pooled(params, X, y, 4)
    for bst in run_threads(2, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=4)):
        same_model(bst, ref)


def test_vertical_adaptive_leaf_matches_pooled():
    """reg:absoluteerror refreshes leaves from label quantiles: on the
    label rank, through ``apply_with_labels``."""
    params = {"objective": "reg:absoluteerror", "max_depth": 3, "eta": 0.5,
              "max_bin": 64}
    rng = np.random.RandomState(5)
    X = rng.randn(1200, 6).astype(np.float32)
    y = (X @ rng.randn(6) + 0.1 * rng.randn(1200)).astype(np.float32)
    ref = pooled(params, X, y, 4, jax_min=4)
    for bst in run_threads(3, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=4)):
        same_model(bst, ref)


def test_vertical_base_score_broadcast():
    """The non-label ranks take the label rank's base score, the pooled
    one (not zero)."""
    X, y = _make_data(n=800, F=4)
    vals = run_threads(2, lambda c, r: float(_train_vertical(
        PARAMS, X, y, c, r, rounds=1).base_margin_[0]))
    ref = pooled(PARAMS, X, y, 1)
    jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y), 1, verbose_eval=False)
    assert vals[0] == vals[1] == float(ref.base_margin_[0])
    assert vals[0] == pytest.approx(float(jb.base_margin_[0]))


def test_vertical_predict_and_eval_match_pooled():
    """The decision-bit prediction and the label rank's metrics: every
    party gets the pooled model's predictions and eval lines."""
    X, y = _make_data(n=1600, F=8)
    Xv, yv = _make_data(n=400, F=8, seed=21)
    p = dict(PARAMS, eval_metric=["logloss", "auc"])
    hist_ref = {}
    ref = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 4,
                   evals=[(xt.DMatrix(Xv, label=yv), "val")],
                   evals_result=hist_ref, verbose_eval=False)
    want = ref.predict(xt.DMatrix(Xv))

    def fn(comm, rank):
        lo, hi = _column_blocks(8, comm.get_world_size())[rank]
        dm = xt.DMatrix(X[:, lo:hi], label=y if rank == 0 else None,
                        data_split_mode="col")
        dmv = xt.DMatrix(Xv[:, lo:hi], label=yv if rank == 0 else None,
                         data_split_mode="col")
        hist = {}
        bst = xt.train(dict(p, data_split_mode="col", device="cpu"), dm, 4,
                       evals=[(dmv, "val")], evals_result=hist,
                       verbose_eval=False)
        return (hist, bst.predict(xt.DMatrix(Xv[:, lo:hi])),
                bst.predict(xt.DMatrix(Xv[:, lo:hi]), output_margin=True))

    for hist, pred, margin in run_threads(3, fn):
        np.testing.assert_allclose(pred, want, **TOL)
        np.testing.assert_allclose(
            margin, ref.predict(xt.DMatrix(Xv), output_margin=True), **TOL)
        assert hist == hist_ref


def test_vertical_requires_comm_or_mesh():
    X, y = _make_data(n=100, F=4)
    dm = xt.DMatrix(X, label=y, data_split_mode="col")
    with pytest.raises(ValueError, match="mesh|communicator"):
        xt.train({**PARAMS, "data_split_mode": "col", "device": "cpu"}, dm,
                 1, verbose_eval=False)


@pytest.mark.parametrize("params,dm_mode,exc,words", [
    ({"multi_strategy": "multi_output_tree", "num_target": 2}, "col",
     NotImplementedError, "scalar trees only"),
    ({"booster": "gblinear"}, "col", NotImplementedError,
     "tree boosters only"),
    ({}, "row", ValueError, "data_split_mode='col'"),
    ({"tree_method": "exact"}, "col", NotImplementedError,
     "tree_method=hist/approx"),
])
def test_vertical_refusals(params, dm_mode, exc, words):
    """What vertical parties refuse, in the JAX package's words: vector
    leaves, gblinear, a DMatrix without the flag, ``exact``."""
    X, y = _make_data(n=200, F=4)
    Y = np.stack([y, 1 - y], 1) if "num_target" in params else y
    params = {k: v for k, v in params.items() if k != "num_target"}

    def fn(comm, rank):
        lo, hi = _column_blocks(4, 2)[rank]
        dm = xt.DMatrix(X[:, lo:hi], label=Y if rank == 0 else None,
                        data_split_mode=dm_mode)
        with pytest.raises(exc, match=words):
            xt.train(dict(PARAMS, data_split_mode="col", device="cpu",
                          **params), dm, 1, verbose_eval=False)

    run_threads(2, fn)


def test_vertical_predict_refuses_shap_and_leaves():
    X, y = _make_data(n=300, F=4)

    def fn(comm, rank):
        bst = _train_vertical(PARAMS, X, y, comm, rank, rounds=1)
        lo, hi = _column_blocks(4, 2)[rank]
        with pytest.raises(NotImplementedError, match="SHAP"):
            bst.predict(xt.DMatrix(X[:, lo:hi]), pred_contribs=True)
        with pytest.raises(NotImplementedError, match="pred_leaf"):
            bst.predict(xt.DMatrix(X[:, lo:hi]), pred_leaf=True)

    run_threads(2, fn)


@pytest.mark.slow
def test_vertical_matches_pooled_federated_grpc():
    """The same parity over the gRPC federated communicator."""
    pytest.importorskip("grpc")
    from xgboost_tpu_torch.parallel.federated import (FederatedCommunicator,
                                                      run_federated_server)

    X, y = _make_data(n=1000, F=6)
    ref = pooled(PARAMS, X, y, 3)
    world = 3
    server = run_federated_server(world, port=0)
    comms = [FederatedCommunicator(f"localhost:{server.port}", world, r,
                                   timeout=60.0) for r in range(world)]
    try:
        out = run_threads(world, lambda c, r: _train_vertical(
            PARAMS, X, y, c, r, rounds=3), comms=comms)
    finally:
        for c in comms:
            c.close()
        server.stop(0)
    for bst in out:
        same_model(bst, ref)


@pytest.mark.slow
def test_vertical_monotone_matches_pooled():
    rng = np.random.RandomState(31)
    n, F = 1500, 6
    X = rng.randn(n, F).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + X[:, 1]
         + 0.1 * rng.randn(n)).astype(np.float32)
    params = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.3,
              "max_bin": 64, "monotone_constraints": "(1,-1,0,0,0,0)"}
    ref = pooled(params, X, y, 4)
    want = ref.predict(xt.DMatrix(X))

    def fn(comm, rank):
        lo, hi = _column_blocks(F, comm.get_world_size())[rank]
        bst = _train_vertical(params, X, y, comm, rank, rounds=4)
        return bst, bst.predict(xt.DMatrix(X[:, lo:hi]))

    for bst, pred in run_threads(3, fn):
        same_model(bst, ref)
        np.testing.assert_allclose(pred, want, **TOL)


def test_vertical_interaction_matches_pooled():
    rng = np.random.RandomState(32)
    n, F = 1500, 9
    X = rng.randn(n, F).astype(np.float32)
    # interacting pairs span parties (blocks 0-2 / 3-5 / 6-8)
    y = (X[:, 0] * X[:, 4] + X[:, 5] * X[:, 8]
         + 0.1 * rng.randn(n)).astype(np.float32)
    params = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.3,
              "max_bin": 64, "interaction_constraints": "[[0,4],[5,8]]"}
    ref = pooled(params, X, y, 4, jax_min=4)
    for bst in run_threads(3, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=4)):
        same_model(bst, ref)
    groups = [{0, 4}, {5, 8}]
    for tree in ref.gbm.trees:
        def walk(h, path):
            if tree.is_leaf[h]:
                if path:
                    assert any(path <= g for g in groups), path
                return
            path = path | {int(tree.split_feature[h])}
            walk(tree.left_child[h], path)
            walk(tree.right_child[h], path)
        walk(0, set())


@pytest.mark.slow
def test_vertical_categorical_matches_pooled():
    rng = np.random.RandomState(33)
    n, k = 1500, 8
    cat0 = rng.randint(0, k, n).astype(np.float32)
    num = rng.randn(n, 3).astype(np.float32)
    cat4 = rng.randint(0, 5, n).astype(np.float32)
    X = np.column_stack([cat0, num[:, :2], cat4, num[:, 2]]).astype(
        np.float32)
    ft = ["c", "float", "float", "c", "float"]
    eff = rng.randn(k)
    y = (eff[cat0.astype(int)] + num[:, 0] + 0.3 * (cat4 == 2)
         + 0.1 * rng.randn(n) > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
              "max_bin": 64, "max_cat_to_onehot": 4}
    ref = pooled(params, X, y, 4, jax_min=4, feature_types=ft,
                 enable_categorical=True)
    assert any(t.is_cat_split.any() for t in ref.gbm.trees)
    want = ref.predict(xt.DMatrix(X, feature_types=ft,
                                  enable_categorical=True))

    def fn(comm, rank):
        lo, hi = _column_blocks(X.shape[1], comm.get_world_size())[rank]
        bst = _train_vertical(params, X, y, comm, rank, rounds=4,
                              feature_types=ft, enable_categorical=True)
        return bst, bst.predict(xt.DMatrix(
            X[:, lo:hi], feature_types=ft[lo:hi], enable_categorical=True))

    for bst, pred in run_threads(2, fn):
        same_model(bst, ref)
        np.testing.assert_allclose(pred, want, **TOL)


def test_vertical_approx_matches_pooled():
    """``approx``: each party re-sketches its own columns with the
    broadcast hessians (a feature's sketch is its own, so the cuts are
    the pooled run's)."""
    params = dict(PARAMS, tree_method="approx")
    X, y = _make_data(n=1500, F=9, seed=13)
    ref = pooled(params, X, y, 4, jax_min=4)
    for bst in run_threads(3, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=4)):
        same_model(bst, ref)


def test_vertical_lossguide_matches_pooled():
    params = {"objective": "binary:logistic", "eta": 0.3, "max_bin": 64,
              "grow_policy": "lossguide", "max_leaves": 8, "max_depth": 0}
    X, y = _make_data(n=1800, F=9, seed=21)
    ref = pooled(params, X, y, 4, jax_min=4, capped=True)
    for bst in run_threads(3, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=4)):
        same_model(bst, ref)


def test_vertical_lossguide_monotone_interaction_matches_pooled():
    params = {"objective": "reg:squarederror", "eta": 0.4, "max_bin": 64,
              "grow_policy": "lossguide", "max_leaves": 6, "max_depth": 0,
              "monotone_constraints": "(1,-1,0,0,0,0)",
              "interaction_constraints": "[[0,1,2],[2,3,4,5]]"}
    rng = np.random.RandomState(31)
    X = rng.randn(1200, 6).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + 0.1 * rng.randn(1200)).astype(np.float32)
    ref = pooled(params, X, y, 3, jax_min=3, capped=True)
    want = ref.predict(xt.DMatrix(X))

    def fn(comm, rank):
        bst = _train_vertical(params, X, y, comm, rank, rounds=3)
        lo, hi = _column_blocks(X.shape[1], comm.get_world_size())[rank]
        return bst, bst.predict(xt.DMatrix(X[:, lo:hi],
                                           data_split_mode="col"))

    for bst, pred in run_threads(2, fn):
        same_model(bst, ref)
        np.testing.assert_allclose(pred, want, **TOL)


def test_vertical_dart_matches_pooled():
    """dart: the drops come from the seed on every rank, and the dropped
    trees' margins walk by the decision-bit protocol."""
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
              "max_bin": 64, "booster": "dart", "rate_drop": 0.5,
              "seed": 5}
    X, y = _make_data(n=1500, F=8, seed=23)
    ref = pooled(params, X, y, 5)
    for bst in run_threads(2, lambda c, r: _train_vertical(
            params, X, y, c, r, rounds=5)):
        same_model(bst, ref)


def test_vertical_coarse_hist_method_warns_and_falls_back():
    """``coarse`` / ``fused`` are row-split schemes: the vertical growers
    warn and train with the exact one-pass kernels (the JAX package's
    words); ``mega`` trains as ``scan``."""
    from xgboost_tpu_torch.tree.param import TrainParam
    from xgboost_tpu_torch.tree.vertical import (VerticalFederatedGrower,
                                                 VerticalLossguideGrower,
                                                 row_split_hist_method)

    X, y = _make_data(n=300, F=4)
    binned = xt.DMatrix(X, label=y).binned(32, torch.device("cpu"))
    for cls, extra in ((VerticalFederatedGrower, {}),
                       (VerticalLossguideGrower, {"max_leaves": 6})):
        param = TrainParam.from_dict({"max_depth": 3, **extra})
        for hm, resolved in (("coarse", "auto"),
                             ("fused+nosub", "auto+nosub")):
            with pytest.warns(UserWarning, match="requires row split"):
                g = cls(param, binned.max_nbins, binned.cuts,
                        hist_method=hm)
            assert g.hist_method == resolved
            assert getattr(g, "schedule", None) is None
    assert row_split_hist_method("mega") == "scan"


def test_vertical_failing_collective_raises_on_every_party():
    """A collective that fails inside vertical training (a permanent
    fault in round 1, as ``tests/test_torch_collective.py`` injects it
    under row split) raises a ``CollectiveError`` on every party: none
    goes on with a model the others lack."""
    from xgboost_tpu_torch.parallel import resilience as R

    X, y = _make_data(n=400, F=4)
    comms = [R.FaultyCommunicator(c, R.FaultPlan(fail_round=1,
                                                 transient=False))
             for c in InMemoryCommunicator.make_world(2)]

    def fn(comm, rank):
        with pytest.raises(R.CollectiveError):
            _train_vertical(PARAMS, X, y, comm, rank, rounds=3)
        return True

    assert run_threads(2, fn, comms=comms) == [True, True]


@pytest.mark.parametrize("objective,metrics", [
    ("binary:logistic", ["logloss", "error", "auc", "aucpr", "rmse"]),
    ("rank:ndcg", ["ndcg@5", "map@5", "pre@3", "auc"]),
])
def test_vertical_metrics_match_pooled_and_jax(objective, metrics):
    """The metrics under vertical parties (the label rank's score through
    ``apply_with_labels``; the ``data_split_mode`` guards keep their
    reductions off the ranks): the pooled run's eval lines, and the JAX
    package's pooled values to the printed digits."""
    rng = np.random.RandomState(41)
    sizes = rng.randint(5, 30, 60)
    n = int(sizes.sum())
    X = rng.randn(n, 6).astype(np.float32)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    if objective == "rank:ndcg":
        y = np.clip(np.round(X[:, 0] + rng.randn(n)), 0, 3).astype(
            np.float32)
    else:
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    kw = {"qid": qid} if objective == "rank:ndcg" else {}
    params = {"objective": objective, "max_depth": 3, "eta": 0.3,
              "max_bin": 64, "eval_metric": metrics}
    ref = {}
    xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y, **kw), 3,
             evals=[(xt.DMatrix(X, label=y, **kw), "t")], evals_result=ref,
             verbose_eval=False)
    jref = {}
    xgb.train(dict(params, hist_method="prehot"),
              xgb.DMatrix(X, label=y, **kw), 3,
              evals=[(xgb.DMatrix(X, label=y, **kw), "t")],
              evals_result=jref, verbose_eval=False)
    for m in metrics:
        np.testing.assert_allclose(ref["t"][m], jref["t"][m], atol=2e-6)

    def fn(comm, rank):
        lo, hi = _column_blocks(6, comm.get_world_size())[rank]
        own = kw if rank == 0 else {}
        dm = xt.DMatrix(X[:, lo:hi], label=y if rank == 0 else None,
                        data_split_mode="col", **own)
        hist = {}
        xt.train(dict(params, data_split_mode="col", device="cpu"), dm, 3,
                 evals=[(dm, "t")], evals_result=hist, verbose_eval=False)
        return hist

    for hist in run_threads(3, fn):
        assert hist == ref
