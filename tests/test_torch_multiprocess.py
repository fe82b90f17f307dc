"""Two OS processes, each holding only its rows, train one model through
``parallel.launch.train_per_host`` over ``torch.distributed`` (``gloo``
on the CPU): the counterpart of the JAX package's
``tests/test_multiprocess.py``.

Each process joins at a ``file://`` rendezvous under ``tmp_path`` (no
fixed port: the suite runs under ``pytest -n``), builds a
``ShardedDMatrix`` of its rows (cuts from the summary merge across the
processes, the missing slot agreed), trains, and evaluates its rows with
the metrics summed across the processes. Both processes must save the
same bytes and print the same eval line. The model is held against the
port's one-process model of all the rows and against the JAX package's
2-shard mesh under ``tests/test_torch_train.py compare_forests``'
near-tie certificate, predictions at rtol 1e-5 plus ``LEAF_ATOL``: at
803 rows the merged summaries are whole (no pruning), so the cuts are
the one-process sketch's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.parallel import launch

from test_torch_train import LEAF_ATOL, compare_forests

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import hashlib, json, sys
    sys.path.insert(0, __REPO__)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.parallel import launch
    from xgboost_tpu_torch.parallel.launch import ShardedDMatrix

    launch.init_distributed(init, world, rank, backend="gloo")
    rng = np.random.RandomState(42)
    X = rng.randn(803, 6).astype(np.float32)
    y = (X @ rng.randn(6) > 0).astype(np.float32)
    sl = slice(0, 401) if rank == 0 else slice(401, None)
    with launch.CommunicatorContext() as comm:
        bst = launch.train_per_host(
            {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
             "device": "cpu", "eval_metric": ["logloss", "auc"]},
            X[sl], y[sl], 5, verbose_eval=False)
        sdm = next(iter(bst._caches.values()))["dm"]
        assert isinstance(sdm, ShardedDMatrix) and sdm.num_row() == (
            401 if rank == 0 else 402)
        line = bst.eval_set([(sdm, "train")], 0)
    raw = bytes(bst.save_raw("ubj"))
    open(out + ".ubj", "wb").write(raw)
    json.dump({"rank": rank, "sha": hashlib.sha256(raw).hexdigest(),
               "eval_line": line, "comm_s": comm.seconds,
               "base": float(bst.base_margin_[0])}, open(out, "w"))
    torch.distributed.destroy_process_group()
""")


def _data():
    rng = np.random.RandomState(42)
    X = rng.randn(803, 6).astype(np.float32)
    y = (X @ rng.randn(6) > 0).astype(np.float32)
    return X, y


def test_two_process_train_per_host(tmp_path):
    world = 2
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("__REPO__", repr(_REPO)))
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"out{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), init, outs[r]], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    res = [json.load(open(o)) for o in outs]
    assert res[0]["sha"] == res[1]["sha"]
    assert res[0]["eval_line"] == res[1]["eval_line"]
    assert "train-logloss" in res[0]["eval_line"]
    assert res[0]["base"] == res[1]["base"]
    model = xt.Booster({"device": "cpu"},
                       model_file=open(outs[0] + ".ubj", "rb").read())

    X, y = _data()
    # the port in one process over all the rows
    one = xt.train({"objective": "binary:logistic", "max_depth": 4,
                    "eta": 0.3, "device": "cpu"}, xt.DMatrix(X, label=y), 5,
                   verbose_eval=False)
    full, ties, _ = compare_forests(one.gbm.trees, model.gbm.trees, 0.3)
    print(f"processes vs one process: {full} in full, ties {ties}")
    assert full == 5 and not ties
    np.testing.assert_allclose(model.predict(xt.DMatrix(X)),
                               one.predict(xt.DMatrix(X)), rtol=1e-5,
                               atol=LEAF_ATOL)
    # the shards' eval line, summed across the processes, is the global
    # one: the one-process model's metrics over all the rows (6 digits)
    want = model.eval_set([(xt.DMatrix(X, label=y), "train")], 0)
    assert res[0]["eval_line"] == want

    # the JAX package's 2-shard mesh
    if len(jax.devices()) >= 2:
        jb = xgb.train({"objective": "binary:logistic", "max_depth": 4,
                        "eta": 0.3, "hist_method": "prehot",
                        "mesh": xgb.make_data_mesh(2)},
                       xgb.DMatrix(X, label=y), 5, verbose_eval=False)
        full, ties, _ = compare_forests(jb.gbm.trees, model.gbm.trees, 0.3)
        print(f"processes vs the JAX 2-shard mesh: {full} in full")
        assert full == 5 and not ties
        np.testing.assert_allclose(model.predict(xt.DMatrix(X)),
                                   jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                                   atol=LEAF_ATOL)


def test_init_distributed_never_switches_backends():
    """NCCL needs one CUDA device a rank: on a host without enough it
    raises and names ``backend="gloo"``, before any rendezvous; with no
    cluster configured the process stays alone."""
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        launch.init_distributed("file:///nonexistent/rdv", 2, 0,
                                backend="nccl")
    launch.init_distributed()               # no MASTER_ADDR: alone
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_train_per_host_alone_is_plain_training():
    """Without a multi-rank communicator ``train_per_host`` is ``train``
    over a mesh of the local device: the one-device model's bytes."""
    X, y = _data()
    p = {"objective": "binary:logistic", "max_depth": 3, "device": "cpu"}
    with launch.CommunicatorContext(xt.collective.NoOpCommunicator()):
        a = launch.train_per_host(p, X, y, 3, verbose_eval=False)
    b = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    assert bytes(a.save_raw("ubj")) == bytes(b.save_raw("ubj"))
    assert launch.global_data_mesh("cpu").size == 1
