"""Row-split training over a data mesh: the port against the JAX package.

The counterparts of the JAX package's ``tests/test_distributed.py``
mesh cases (``:28-56``, ``:247``, ``:400``) and its mesh branches of the
lossguide, vector-leaf and ``approx`` growers. The JAX package runs on
its 8-device CPU mesh (``tests/conftest.py``) with
``hist_method="prehot"`` (its int8x2 build, whose scale is ``pmax``ed
over the shards; its two-level schedules build in f32 ``segment`` on
the CPU, so those cases train both packages on gradients already on the
int8x2 grid, as ``tests/test_torch_two_level_train.py`` does); the
port runs on a ``Mesh`` of the same 8 shards on
the CPU (a device may repeat), with its ``auto`` or the two-level
schedule named. Trees are compared node by node under
``tests/test_torch_train.py compare_forests``' near-tie certificate,
leaves and predictions at rtol 1e-5 + atol 1e-5 where the trees agree
(``LEAF_ATOL`` 1e-4 against the JAX package, as in that file); the
port's mesh is held against the port's one device the same way. The
quantiser scale: each shard's histogram of the port bit for bit against
the JAX package's per-shard ``prehot`` build under ``shard_map``.

Row sampling under a mesh draws over the padded row count, as the JAX
package's mesh does (``boosting/gbtree.py:505-508``); the threefry
stream is counter-based, so the real rows draw one device's bits
(``test_mesh_sampling_draws_over_padded_rows``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.context import shard_map
from xgboost_tpu.ops.histogram import build_hist as jax_build_hist
from xgboost_tpu_torch.context import Mesh, make_data_mesh
from xgboost_tpu_torch.ops.histogram import abs_max, build_hist
from xgboost_tpu_torch.tree.shards import RowShards

from test_torch_train import LEAF_ATOL, compare_forests
from test_torch_two_level_train import (_jax_grid_objective,
                                        _port_grid_gradient)
from xgboost_tpu_torch.objective.base import Objective

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SHARDS = 8
MESH_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < SHARDS:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    return xgb.make_data_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * SHARDS)


def _regression(n, F, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _binary(n, F, seed, missing=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) > 0).astype(np.float32)
    if missing:
        X[rng.rand(n, F) < missing] = np.nan
    return X, y


def _both(jmesh, tmesh, X, y, params, rounds, jax_method="prehot",
          port_method="auto", obj=None):
    """The JAX package's mesh model, the port's mesh model and the port's
    one-device model of the same rows; ``obj``: the JAX side's custom
    objective."""
    jb = xgb.train(dict(params, hist_method=jax_method, mesh=jmesh),
                   xgb.DMatrix(X, label=y), rounds, verbose_eval=False,
                   obj=obj)
    tp = dict(params, hist_method=port_method, device="cpu")
    tm = xt.train(dict(tp, mesh=tmesh), xt.DMatrix(X, label=y), rounds,
                  verbose_eval=False)
    t1 = xt.train(tp, xt.DMatrix(X, label=y), rounds, verbose_eval=False)
    return jb, tm, t1


def _check(jb, tm, t1, X, eta, full_min, capped=False):
    """The port's mesh against the JAX package's mesh (at least
    ``full_min`` trees in full, as measured on the CPU) and against the
    port's one device (every tree in full), predictions as stated."""
    full, ties, drift = compare_forests(jb.gbm.trees, tm.gbm.trees, eta,
                                        capped=capped)
    print(f"port mesh vs JAX mesh: {full} trees in full, ties {ties}, "
          f"drift {drift:.3e}")
    assert full >= full_min
    np.testing.assert_allclose(
        tm.predict(xt.DMatrix(X), iteration_range=(0, full)),
        jb.predict(xgb.DMatrix(X), iteration_range=(0, full)), rtol=1e-5,
        atol=LEAF_ATOL)
    full1, ties1, drift1 = compare_forests(t1.gbm.trees, tm.gbm.trees, eta,
                                           capped=capped)
    print(f"port mesh vs port one device: {full1} in full, drift "
          f"{drift1:.3e}")
    assert full1 == len(t1.gbm.trees) and not ties1
    np.testing.assert_allclose(tm.predict(xt.DMatrix(X)),
                               t1.predict(xt.DMatrix(X)), **MESH_TOL)


# (case, rows, features, params, rounds, JAX / port hist_method, trees
# in full against the JAX mesh as measured on the CPU)
DEPTHWISE = [
    ("regression", 1000, 8, {"objective": "reg:squarederror",
                             "max_depth": 4, "eta": 0.3}, 5, "auto", 5),
    ("uneven_pad", 1003, 5, {"objective": "reg:squarederror",
                             "max_depth": 3, "eta": 0.3}, 3, "auto", 3),
    ("coarse", 4000, 9, {"objective": "binary:logistic", "max_depth": 4,
                         "eta": 0.3}, 4, "coarse", 4),
    ("fused", 4000, 9, {"objective": "binary:logistic", "max_depth": 4,
                        "eta": 0.3}, 4, "fused", 4),
    ("scan", 4000, 9, {"objective": "binary:logistic", "max_depth": 4,
                       "eta": 0.3}, 4, "scan", 4),
]


@pytest.mark.parametrize("case,n,F,params,rounds,method,full_min",
                         DEPTHWISE, ids=[c[0] for c in DEPTHWISE])
def test_depthwise_mesh_matches_jax_mesh(jmesh, tmesh, case, n, F, params,
                                         rounds, method, full_min,
                                         monkeypatch):
    if params["objective"] == "binary:logistic":
        X, y = _binary(n, F, seed=23)
    else:
        X, y = _regression(n, F, seed=1)
    kw = {}
    if method != "auto":
        # the JAX package's CPU two-level builds are f32: both on the grid
        monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
        kw["obj"] = _jax_grid_objective
    jax_method = "prehot" if method == "auto" else method
    jb, tm, t1 = _both(jmesh, tmesh, X, y, dict(params, base_score=0.5),
                       rounds, jax_method=jax_method, port_method=method,
                       **kw)
    _check(jb, tm, t1, X, params["eta"], full_min)


def test_mesh_eval_and_logistic(jmesh, tmesh):
    """Evals on a mesh (the JAX package's ``test_mesh_eval_and_logistic``):
    the metrics of the trimmed margins, equal to the JAX mesh's to the
    6 printed digits where the trees agree."""
    X, y = _binary(2000, 10, seed=5, missing=0.05)
    p = {"objective": "binary:logistic", "max_depth": 4,
         "eval_metric": ["logloss", "auc"], "base_score": 0.5}
    rj, rt = {}, {}
    jb = xgb.train(dict(p, hist_method="prehot", mesh=jmesh),
                   xgb.DMatrix(X, label=y), 8,
                   evals=[(xgb.DMatrix(X, label=y), "train")],
                   evals_result=rj, verbose_eval=False)
    tm = xt.train(dict(p, device="cpu", mesh=tmesh), xt.DMatrix(X, label=y),
                  8, evals=[(xt.DMatrix(X, label=y), "train")],
                  evals_result=rt, verbose_eval=False)
    full, _, _ = compare_forests(jb.gbm.trees, tm.gbm.trees, 0.3)
    assert full >= 8
    assert rt["train"]["auc"][-1] > 0.9
    np.testing.assert_allclose(rt["train"]["logloss"],
                               rj["train"]["logloss"], atol=2e-6)
    np.testing.assert_allclose(rt["train"]["auc"], rj["train"]["auc"],
                               atol=2e-6)


def test_gradient_based_sampling_on_a_mesh(jmesh, tmesh):
    """``gradient_based`` sampling under a mesh (the JAX package's
    ``test_gradient_based_sampling_trains``): trains, and the first tree
    (before any sampled margin feeds back) agrees with the JAX mesh's."""
    X, y = _binary(3000, 8, seed=9)
    p = {"objective": "binary:logistic", "max_depth": 4, "subsample": 0.3,
         "sampling_method": "gradient_based", "eval_metric": "auc",
         "base_score": 0.5}
    res = {}
    jb = xgb.train(dict(p, hist_method="prehot", mesh=jmesh),
                   xgb.DMatrix(X, label=y), 10, verbose_eval=False)
    dm = xt.DMatrix(X, label=y)
    tm = xt.train(dict(p, device="cpu", mesh=tmesh), dm, 10,
                  evals=[(dm, "t")], evals_result=res, verbose_eval=False)
    assert res["t"]["auc"][-1] > 0.9
    full, ties, _ = compare_forests(jb.gbm.trees, tm.gbm.trees, 0.3)
    print(f"gradient_based: {full} trees in full, ties {ties}")
    assert full >= 1


def test_mesh_sampling_draws_over_padded_rows(jmesh, tmesh):
    """1,003 rows on 8 shards pad to 1,008: ``subsample`` draws over the
    padded rows, as the JAX package's mesh draws. The threefry stream is
    counter-based (``jax_threefry_partitionable``, on in this JAX), so
    the first 1,003 of those draws are one device's: the mesh keeps the
    same rows as one device, and grows the JAX mesh's trees and one
    device's."""
    from xgboost_tpu_torch.utils import random as xrandom

    key = xrandom.fold_in(xrandom.key(0), 0x5AB)
    pad = xrandom.bernoulli(key, 0.5, (1008,), torch.device("cpu"))
    one = xrandom.bernoulli(key, 0.5, (1003,), torch.device("cpu"))
    assert torch.equal(pad[:1003], one)
    jkey = jax.random.fold_in(jax.random.key(0), 0x5AB)
    np.testing.assert_array_equal(
        pad.numpy(), np.asarray(jax.random.bernoulli(jkey, 0.5, (1008,))))
    X, y = _binary(1003, 6, seed=4)
    p = {"objective": "binary:logistic", "max_depth": 3, "subsample": 0.5,
         "base_score": 0.5}
    jb, tm, t1 = _both(jmesh, tmesh, X, y, p, 3)
    _check(jb, tm, t1, X, 0.3, 3)


def test_lossguide_on_a_mesh(jmesh, tmesh):
    X, y = _binary(3000, 10, seed=37, missing=0.1)
    p = {"objective": "binary:logistic", "grow_policy": "lossguide",
         "max_leaves": 10, "max_depth": 0, "eta": 0.3, "base_score": 0.5}
    jb, tm, t1 = _both(jmesh, tmesh, X, y, p, 4)
    _check(jb, tm, t1, X, 0.3, 4, capped=True)


def test_vector_leaves_on_a_mesh(jmesh, tmesh):
    rng = np.random.RandomState(3)
    X = rng.randn(1500, 8).astype(np.float32)
    Y = (X @ rng.randn(8, 3) + 0.5 * rng.randn(1500, 3)).astype(np.float32)
    p = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.3,
         "multi_strategy": "multi_output_tree"}
    jb, tm, t1 = _both(jmesh, tmesh, X, Y, p, 4)
    _check(jb, tm, t1, X, 0.3, 4)


def test_approx_on_a_mesh(jmesh, tmesh):
    """``approx`` over a mesh: the sketch of every shard's rows with their
    hessians (one process holds them all), the re-binned matrix sharded."""
    X, y = _binary(3000, 8, seed=0)
    p = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
         "tree_method": "approx", "base_score": 0.5}
    jb, tm, t1 = _both(jmesh, tmesh, X, y, p, 4)
    _check(jb, tm, t1, X, 0.3, 4)


@pytest.mark.parametrize("params,exc,words", [
    ({"tree_method": "exact"}, ValueError,
     "tree_method=exact does not support distributed training"),
    ({"booster": "gblinear"}, NotImplementedError,
     "booster=gblinear does not support a device mesh"),
])
def test_mesh_refuses_exact_and_gblinear(tmesh, params, exc, words):
    X, y = _binary(200, 4, seed=1)
    with pytest.raises(exc, match=words):
        xt.train(dict(params, device="cpu", mesh=tmesh),
                 xt.DMatrix(X, label=y), 1, verbose_eval=False)


def test_mesh_refuses_the_unported(tmesh):
    """Sibling subtraction is ignored under a mesh (as the JAX package's
    is: one shard's share of the built children can pass its local half),
    under row and column split alike: ``auto+sub`` saves ``auto``'s
    bytes. Column split itself trains on a mesh
    (``tests/test_torch_col_split.py``) and ``exact`` under it is refused
    with the JAX package's words."""
    X, y = _binary(400, 4, seed=2)
    for mode in ("row", "col"):
        raws = []
        for m in ("auto", "auto+sub"):
            b = xt.train({"device": "cpu", "mesh": tmesh,
                          "data_split_mode": mode, "hist_method": m},
                         xt.DMatrix(X, label=y), 2, verbose_eval=False)
            b.set_param({"hist_method": "auto"})
            raws.append(bytes(b.save_raw("ubj")))
        assert raws[0] == raws[1], mode
    with pytest.raises(NotImplementedError,
                       match="data_split_mode=col supports "
                             "tree_method=hist/approx"):
        xt.train({"device": "cpu", "mesh": tmesh, "data_split_mode": "col",
                  "tree_method": "exact"}, xt.DMatrix(X, label=y), 1,
                 verbose_eval=False)
    b = xt.train({"device": "cpu", "mesh": tmesh, "data_split_mode": "col"},
                 xt.DMatrix(X, label=y), 1, verbose_eval=False)
    assert b.num_boosted_rounds() == 1


def test_paged_matrix_on_a_mesh_refuses(tmesh, tmp_path, monkeypatch):
    """A paged matrix on a mesh trains (``tests/test_torch_paged_mesh.py``)
    and refuses what the JAX package's paged mesh refuses, in its words:
    ``approx`` over pages on a mesh, and column split on pages."""
    from test_torch_paged import PortIter

    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    monkeypatch.setenv("XTPU_PAGE_ROWS", "100")
    X, y = _binary(400, 4, seed=6)
    qdm = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / "m")), max_bin=16)
    p = {"device": "cpu", "mesh": tmesh, "max_bin": 16}
    with pytest.raises(NotImplementedError,
                       match="supports row split without a device mesh"):
        xt.train(dict(p, tree_method="approx"), qdm, 1, verbose_eval=False)
    with pytest.raises(NotImplementedError,
                       match="supports data_split_mode=row only"):
        xt.train(dict(p, data_split_mode="col"), qdm, 1, verbose_eval=False)
    assert xt.train(p, qdm, 1, verbose_eval=False).num_boosted_rounds() == 1


def test_two_mesh_runs_give_one_model(tmesh):
    X, y = _binary(2000, 8, seed=3)
    p = {"objective": "binary:logistic", "max_depth": 5, "device": "cpu",
         "mesh": tmesh, "hist_method": "fused"}
    a = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    b = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    assert bytes(a.save_raw("ubj")) == bytes(b.save_raw("ubj"))


# (shards, hist_method, trees in full as measured on the CPU: at 3
# shards ``auto``'s third tree meets a near tie at node 22)
ONE_DEVICE = [(2, "auto", 3), (2, "pallas:f32", 3), (3, "auto", 2),
              (3, "pallas:f32", 3)]


@pytest.mark.parametrize("shards,method,full_min", ONE_DEVICE)
def test_port_mesh_matches_one_device(shards, method, full_min):
    """Other shard counts (3 pads 2,000 rows to 2,001), at depth 6 with
    missing values and K3 (``pallas:f32``): the mesh's trees under the
    certificate against one device's, predictions within rtol 1e-5 +
    atol 1e-5."""
    X, y = _binary(2000, 8, seed=11, missing=0.1)
    p = {"objective": "binary:logistic", "max_depth": 6, "device": "cpu",
         "hist_method": method}
    one = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    msh = xt.train(dict(p, mesh=Mesh(["cpu"] * shards)),
                   xt.DMatrix(X, label=y), 3, verbose_eval=False)
    full, ties, _ = compare_forests(one.gbm.trees, msh.gbm.trees, 0.3)
    assert full >= full_min, (full, ties)
    np.testing.assert_allclose(msh.predict(xt.DMatrix(X)),
                               one.predict(xt.DMatrix(X)), **MESH_TOL)


def test_shard_quantisation_matches_jax_pmax(jmesh):
    """Each shard's int8x2 histogram with the scale reduced over the
    shards, bit for bit against the JAX package's ``prehot`` build under
    ``shard_map`` (its scale ``pmax``ed over the ``data`` axis): the
    same q and the same dequantisation on every shard."""
    rng = np.random.RandomState(0)
    n, F, B, N = 8 * 250, 6, 33, 4
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    gpair = np.stack([rng.randn(n) * np.where(np.arange(n) < 250, 5.0, 1.0),
                      rng.rand(n)], 1).astype(np.float32)
    rel = rng.randint(0, N + 1, n).astype(np.int32)
    P = jax.sharding.PartitionSpec

    def shard(b, g, r):
        return jax_build_hist(b, g, r, N, B, method="prehot",
                              axis_name="data")

    want = np.asarray(jax.jit(shard_map(
        shard, jmesh, in_specs=(P("data", None), P("data", None),
                                P("data")),
        out_specs=P("data")))(jnp.asarray(bins), jnp.asarray(gpair),
                              jnp.asarray(rel))).reshape(SHARDS, N, F, B, 2)
    rows = RowShards.split_matrix(torch.from_numpy(bins),
                                  make_data_mesh(devices=["cpu"] * SHARDS))
    gps = rows.split(torch.from_numpy(gpair))
    rels = rows.split(torch.from_numpy(rel))
    scale = rows.scale(gps)
    assert torch.equal(scale["max_abs"], abs_max(torch.from_numpy(gpair)))
    assert scale["total_rows"] == n
    for s in range(SHARDS):
        got = build_hist(rows.parts[s], gps[s], rels[s], N, B,
                         method="prehot", **scale)
        np.testing.assert_array_equal(got.numpy(), want[s])
    # without the reduced scale shard 1 quantises with its own max
    own = build_hist(rows.parts[1], gps[1], rels[1], N, B, method="prehot")
    assert not np.array_equal(own.numpy(), want[1])


def test_make_data_mesh_needs_a_card_or_named_devices():
    m = make_data_mesh(devices=["cpu", "cpu"])
    assert m.size == 2 and m.shape == {"data": 2} and m.world == 2
    ctx = xt.Context(device="cpu").with_mesh(m)
    assert ctx.mesh is m and ctx.world() == 2 and ctx.torch_device() == \
        torch.device("cpu")
    assert xt.Context(device="cpu").world() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_data_mesh()
        with pytest.raises(RuntimeError, match="needs CUDA"):
            Mesh(["cuda"])
