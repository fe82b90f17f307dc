"""Column-split training over a data mesh: the port against the JAX package.

The counterparts of the JAX package's ``tests/test_distributed.py``
column-split cases (``:122-240``, ``:301-400``, ``:416-460``): every row
on every shard, the features padded to a multiple of the shard count
and cut into blocks (13 features on 8 shards pad to 16), each shard's
split search over its features, the best-split exchange and the
decision broadcast. The JAX package runs on its 8-device CPU mesh
(``tests/conftest.py``) with ``hist_method="prehot"`` (its int8x2
build; its two-level schedules build in f32 ``segment`` on the CPU, so
those cases train both packages on gradients already on the int8x2
grid, as ``tests/test_torch_mesh.py`` does); the port runs on a
``Mesh`` of the same 8 shards on the CPU with its ``auto`` or the
schedule named.

Each port column mesh is held against the port's one device exactly,
node by node (features, bins, default directions, categorical words),
leaves and predictions at rtol 1e-5 + atol 1e-5 (in fact bit for bit:
every shard has every row, so its histograms are one device's); against
the JAX package's column mesh under ``tests/test_torch_train.py
compare_forests``' near-tie certificate, leaves at its ``LEAF_ATOL``,
with at least the trees in full measured on the CPU (the packages' near
ties are one device's too: the first case's tree 2 parts at node 17 by
1.2e-7 of gain between the JAX package's one device and the port's).
The JAX package's ``slow`` marks are kept.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import jax

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.context import Mesh
from xgboost_tpu_torch.data.binned import feature_pad_for_mesh
from xgboost_tpu_torch.objective.base import Objective
from xgboost_tpu_torch.ops import histogram as hist_ops
from xgboost_tpu_torch.ops.split import SplitResult
from xgboost_tpu_torch.tree.shards import ColShards

from test_torch_train import LEAF_ATOL, compare_forests
from test_torch_two_level_train import (_jax_grid_objective,
                                        _port_grid_gradient)

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SHARDS = 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < SHARDS:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    return xgb.make_data_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * SHARDS)


def same_trees(a, b):
    """Port trees ``a`` (one device) and ``b`` (column mesh) node by node:
    the structure exactly, leaves at rtol 1e-5 + atol 1e-5."""
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        for f in ("left_child", "right_child", "split_feature", "split_bin",
                  "default_left", "is_leaf", "is_cat_split", "cat_words"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f),
                                          err_msg=f)
        np.testing.assert_allclose(tb.leaf_value, ta.leaf_value, **TOL)
        np.testing.assert_allclose(tb.split_value, ta.split_value, **TOL)


def trees_sha(bst) -> str:
    """sha256 of the model's trees (the learner's parameters name the
    split mode and differ)."""
    trees = [t.to_json() for t in bst.gbm.trees]
    return hashlib.sha256(repr(trees).encode()).hexdigest()


def port_both(tmesh, X, y, params, rounds, dm=None):
    """The port's one-device and column-mesh models of the same rows."""
    dm = dm or (lambda: xt.DMatrix(X, label=y))
    p = dict(params, device="cpu")
    one = xt.train(p, dm(), rounds, verbose_eval=False)
    col = xt.train(dict(p, mesh=tmesh, data_split_mode="col"), dm(), rounds,
                   verbose_eval=False)
    same_trees(one.gbm.trees, col.gbm.trees)
    assert trees_sha(one) == trees_sha(col)
    Xp = dm()
    np.testing.assert_allclose(col.predict(Xp), one.predict(Xp), **TOL)
    return one, col


def against_jax(jmesh, jb_params, col, X, y, rounds, full_min, eta=0.3,
                capped=False, obj=None, jdm=None):
    """The port's column mesh against the JAX package's."""
    jdm = jdm or (lambda: xgb.DMatrix(X, label=y))
    jb = xgb.train(dict(jb_params, mesh=jmesh, data_split_mode="col"),
                   jdm(), rounds, verbose_eval=False, obj=obj)
    full, ties, drift = compare_forests(jb.gbm.trees, col.gbm.trees, eta,
                                        capped=capped)
    print(f"port column mesh vs JAX column mesh: {full} trees in full, "
          f"ties {ties}, drift {drift:.3e}")
    assert full >= full_min
    return jb, full


def _binary(n, F, seed, missing=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) > 0).astype(np.float32)
    if missing:
        X[rng.rand(n, F) < missing] = np.nan
    return X, y


def test_col_split_matches_single_device(jmesh, tmesh):
    X, y = _binary(3000, 13, seed=3)          # 13 -> pads to 16 columns
    p = {"objective": "binary:logistic", "max_depth": 5, "eta": 0.3,
         "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 5)
    jb, full = against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y,
                           5, 2)
    np.testing.assert_allclose(
        col.predict(xt.DMatrix(X), iteration_range=(0, full)),
        jb.predict(xgb.DMatrix(X), iteration_range=(0, full)), rtol=1e-5,
        atol=LEAF_ATOL)


@pytest.mark.slow
def test_col_split_with_missing(jmesh, tmesh):
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 10).astype(np.float32)
    y = (np.nan_to_num(X) @ rng.randn(10) > 0).astype(np.float32)
    X[rng.rand(*X.shape) < 0.25] = np.nan
    p = {"objective": "reg:squarederror", "max_depth": 4, "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 4)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 4, 3)


@pytest.mark.slow
def test_col_split_deep_tree(jmesh, tmesh):
    """Depth 9: the levels above 128 nodes build through K3."""
    rng = np.random.RandomState(11)
    X = rng.randn(4000, 11).astype(np.float32)
    y = (np.sin(X[:, 0] * 3) + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 9, "eta": 0.4,
         "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 3)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 3, 1,
                eta=0.4)


@pytest.mark.slow
def test_col_split_categorical(jmesh, tmesh):
    """One-hot and sorted-partition splits: the winner's words cross the
    exchange bit for bit."""
    rng = np.random.RandomState(12)
    codes = rng.randint(0, 24, 3000)
    eff = rng.randn(24) * 2.0
    X = np.stack([codes, rng.randn(3000), rng.randn(3000),
                  rng.randint(0, 5, 3000)], axis=1).astype(np.float32)
    y = (eff[codes] + X[:, 1] + 0.7 * (X[:, 3] == 2)).astype(np.float32)
    ft = ["c", "float", "float", "c"]
    p = {"objective": "reg:squarederror", "max_depth": 5, "eta": 0.3,
         "max_cat_to_onehot": 8, "base_score": 0.5}
    one, col = port_both(tmesh, X, y, p, 6, dm=lambda: xt.DMatrix(
        X, label=y, feature_types=ft, enable_categorical=True))
    assert any(t.is_cat_split.any() for t in col.gbm.trees)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 6, 6,
                jdm=lambda: xgb.DMatrix(X, label=y, feature_types=ft,
                                        enable_categorical=True))


@pytest.mark.slow
def test_col_split_monotone_and_interaction(jmesh, tmesh):
    rng = np.random.RandomState(13)
    X = rng.randn(2500, 6).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
         + 0.1 * rng.randn(2500)).astype(np.float32)
    p = {"objective": "reg:squarederror", "max_depth": 5, "eta": 0.3,
         "monotone_constraints": "(1,-1,0,0,0,0)",
         "interaction_constraints": "[[0,1],[2,3],[4,5]]", "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 5)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 5, 5)


def test_col_split_approx_matches_single_device(jmesh, tmesh):
    """``approx``: every shard re-bins with the one sketch of all the rows
    (rows replicate), and the re-binned features land in blocks; ``exact``
    stays refused under column split, with the JAX package's words."""
    X, y = _binary(2500, 13, seed=5)
    p = {"objective": "binary:logistic", "max_depth": 5, "eta": 0.3,
         "tree_method": "approx", "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 4)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 4, 4)
    with pytest.raises(NotImplementedError,
                       match="data_split_mode=col supports "
                             "tree_method=hist/approx"):
        xt.train(dict(p, tree_method="exact", mesh=tmesh, device="cpu",
                      data_split_mode="col"), xt.DMatrix(X, label=y), 1,
                 verbose_eval=False)


def test_col_split_requires_mesh():
    X = np.random.RandomState(0).randn(100, 4).astype(np.float32)
    with pytest.raises(ValueError, match="requires a mesh"):
        xt.train({"data_split_mode": "col", "device": "cpu"},
                 xt.DMatrix(X, label=X[:, 0]), 1, verbose_eval=False)


def test_col_split_lossguide_matches_single_device(jmesh, tmesh):
    X, y = _binary(3000, 13, seed=7)
    p = {"objective": "binary:logistic", "grow_policy": "lossguide",
         "max_leaves": 14, "max_depth": 0, "eta": 0.3, "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 4)
    for t in col.gbm.trees:
        assert int(t.is_leaf.sum()) <= 14
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 4, 4,
                capped=True)


def test_col_split_lossguide_monotone(jmesh, tmesh):
    rng = np.random.RandomState(9)
    X = rng.randn(2500, 6).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] + 0.1 * rng.randn(2500)).astype(np.float32)
    p = {"objective": "reg:squarederror", "grow_policy": "lossguide",
         "max_leaves": 10, "max_depth": 0,
         "monotone_constraints": "(1,0,0,0,0,0)", "base_score": 0.5}
    _, col = port_both(tmesh, X, y, p, 3)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, y, 3, 3,
                capped=True)
    Xg = np.zeros((50, 6), np.float32)
    Xg[:, 0] = np.linspace(-2, 2, 50)
    assert (np.diff(col.predict(xt.DMatrix(Xg))) >= -1e-5).all()


def test_col_split_multi_output_tree_matches_single_device(jmesh, tmesh):
    rng = np.random.RandomState(11)
    X = rng.randn(3000, 13).astype(np.float32)
    Y = np.stack([X @ rng.randn(13), X @ rng.randn(13)],
                 axis=1).astype(np.float32)
    p = {"objective": "reg:squarederror", "max_depth": 4,
         "multi_strategy": "multi_output_tree", "base_score": 0.5}
    _, col = port_both(tmesh, X, Y, p, 4)
    assert len(col.gbm.trees) == 4
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, Y, 4, 4)


@pytest.mark.slow
def test_col_split_multi_output_deep_tree(jmesh, tmesh):
    rng = np.random.RandomState(13)
    X = rng.randn(2500, 5).astype(np.float32)
    Y = np.stack([X @ rng.randn(5), X @ rng.randn(5)],
                 axis=1).astype(np.float32)
    p = {"objective": "reg:squarederror", "max_depth": 8,
         "min_child_weight": 4.0, "multi_strategy": "multi_output_tree",
         "base_score": 0.5}
    _, col = port_both(tmesh, X, Y, p, 2)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, Y, 2, 1)


def test_col_split_vector_leaf_lossguide(jmesh, tmesh):
    """Leaf-wise vector leaves over feature shards (the JAX package's
    ``_eval2_multi_col``)."""
    rng = np.random.RandomState(15)
    X = rng.randn(2000, 13).astype(np.float32)
    Y = np.stack([X @ rng.randn(13), X @ rng.randn(13)],
                 axis=1).astype(np.float32)
    p = {"objective": "reg:squarederror", "grow_policy": "lossguide",
         "max_leaves": 8, "multi_strategy": "multi_output_tree",
         "base_score": 0.5}
    _, col = port_both(tmesh, X, Y, p, 3)
    against_jax(jmesh, dict(p, hist_method="prehot"), col, X, Y, 3, 3,
                capped=True)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_col_split_model_loads_without_mesh(jmesh, tmesh, tmp_path, pkg):
    """The split mode describes the training data, not the model: a
    column-mesh model loads without a mesh, in both packages, and the
    other package's loader reads it too."""
    rng = np.random.RandomState(17)
    X = rng.randn(1500, 6).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 3,
         "data_split_mode": "col"}
    path = str(tmp_path / "col.json")
    if pkg == "port":
        b = xt.train(dict(p, mesh=tmesh, device="cpu"),
                     xt.DMatrix(X, label=y), 2, verbose_eval=False)
        want = b.predict(xt.DMatrix(X))
    else:
        b = xgb.train(dict(p, mesh=jmesh, hist_method="prehot"),
                      xgb.DMatrix(X, label=y), 2, verbose_eval=False)
        want = b.predict(xgb.DMatrix(X))
    b.save_model(path)
    tb = xt.Booster({"device": "cpu"}, model_file=path)
    assert tb.learner_params.get("data_split_mode", "row") == "row"
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)), want, rtol=1e-6)
    jb = xgb.Booster(model_file=path)
    np.testing.assert_allclose(jb.predict(xgb.DMatrix(X)), want, rtol=1e-6)


@pytest.mark.parametrize("method", ["coarse", "fused", "scan"])
def test_col_split_two_level_matches_single_device(jmesh, tmesh, method,
                                                   monkeypatch):
    """The two-level schedules over feature shards (the JAX package's
    ``test_col_split_coarse_hist_matches_single_device``): each shard's
    coarse histogram, window, refine and synthetic search over its
    features, then the exchange; with missing values. ``fused`` and
    ``scan`` advance at the end of each level, and the fused kernel's
    sweep is never called."""
    rng = np.random.RandomState(29)
    X = rng.randn(3000, 13).astype(np.float32)
    y = (X @ rng.randn(13) > 0).astype(np.float32)
    X[rng.rand(*X.shape) < 0.15] = np.nan
    p = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
         "hist_method": method, "base_score": 0.5}

    def refuse(*a, **k):
        raise AssertionError("the fused sweep ran under column split")

    monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
    one = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 4,
                   verbose_eval=False)
    import xgboost_tpu_torch.tree.grow as grow_mod
    monkeypatch.setattr(grow_mod, "fused_advance_coarse", refuse)
    monkeypatch.setattr(grow_mod, "scan_advance_level", refuse)
    col = xt.train(dict(p, device="cpu", mesh=tmesh, data_split_mode="col"),
                   xt.DMatrix(X, label=y), 4, verbose_eval=False)
    same_trees(one.gbm.trees, col.gbm.trees)
    np.testing.assert_allclose(col.predict(xt.DMatrix(X)),
                               one.predict(xt.DMatrix(X)), **TOL)
    if method == "coarse":
        against_jax(jmesh, dict(p, hist_method="coarse"), col, X, y, 4, 4,
                    obj=_jax_grid_objective)


def test_col_split_coarse_lossguide_matches_single_device(jmesh, tmesh,
                                                          monkeypatch):
    rng = np.random.RandomState(37)
    X = rng.randn(3000, 13).astype(np.float32)
    y = (X @ rng.randn(13) > 0).astype(np.float32)
    X[rng.rand(*X.shape) < 0.15] = np.nan
    p = {"objective": "binary:logistic", "eta": 0.3, "hist_method": "coarse",
         "grow_policy": "lossguide", "max_leaves": 10, "max_depth": 0,
         "base_score": 0.5}
    monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
    _, col = port_both(tmesh, X, y, p, 4)
    for t in col.gbm.trees:
        assert int(t.is_leaf.sum()) <= 10
    against_jax(jmesh, p, col, X, y, 4, 4, capped=True,
                obj=_jax_grid_objective)


def test_col_split_colsample_on_other_shard_counts():
    """Column samples over the padded features (pad columns have no real
    bin and take no draw), at 3 shards (13 pad to 15), depth 6, K3 and
    missing values: one device's trees."""
    X, y = _binary(2000, 13, seed=11, missing=0.1)
    p = {"objective": "binary:logistic", "max_depth": 6,
         "colsample_bynode": 0.7, "colsample_bytree": 0.8, "seed": 3}
    for method in ("auto", "pallas:f32"):
        port_both(Mesh(["cpu"] * 3), X, y, dict(p, hist_method=method), 3)


def test_two_col_mesh_runs_give_one_model(tmesh):
    X, y = _binary(2000, 8, seed=3)
    p = {"objective": "binary:logistic", "max_depth": 5, "device": "cpu",
         "mesh": tmesh, "data_split_mode": "col"}
    a = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    b = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    assert bytes(a.save_raw("ubj")) == bytes(b.save_raw("ubj"))


def test_auto_keeps_off_the_sorted_build_under_col_split():
    """``auto`` never takes K4 under column split (the JAX package's
    ``auto_selects_coarse(col_split=True)``), where it would one device."""
    assert hist_ops.resolve_hist_kernel("auto", 1 << 17, 4, 257) == "scan"
    assert hist_ops.resolve_hist_kernel("auto", 1 << 17, 4, 257,
                                        col_split=True) == "int8x2"
    assert not hist_ops.auto_selects_scan(1 << 17, 257, True,
                                          col_split=True)


def test_feature_layout_and_exchange():
    """``ColShards``: the pad columns (bin 0), the blocks, the exchange's
    tie rule (the lowest shard, the pooled lowest feature), the
    categorical words bit for bit, the pooled layout a shard searches in
    (``FeatureBlock``), and the decision OR."""
    assert feature_pad_for_mesh(13, 8) == 3
    assert feature_pad_for_mesh(16, 8) == 0
    bins = torch.arange(5 * 13, dtype=torch.int64).reshape(5, 13).to(
        torch.uint8)
    cols = ColShards.split_matrix(bins, Mesh(["cpu"] * 4))
    assert cols.shape == (5, 16) and cols.pad == 3 and cols.f_local == 4
    assert torch.equal(cols.parts[1], bins[:, 4:8])
    assert (cols.parts[3][:, 1:] == 0).all()

    def res(gain, feat, words):
        N = len(gain)
        return SplitResult(
            gain=torch.tensor(gain), feature=torch.tensor(feat),
            bin=torch.tensor(feat) + 10,
            default_left=torch.tensor([f % 2 == 0 for f in feat]),
            left_sum=torch.ones(N, 2) * torch.tensor(gain)[:, None],
            right_sum=torch.zeros(N, 2), is_cat=torch.zeros(N, dtype=bool),
            cat_words=torch.tensor(words, dtype=torch.int64)[:, None])

    big = 0xFFFFFFFF
    out = cols.exchange([res([1.0, 2.0, 5.0], [0, 1, 2], [1, 2, 3]),
                         res([1.0, 3.0, float("-inf")], [7, 6, 4],
                             [4, big, 6]),
                         res([0.5, 3.0, 1.0], [9, 9, 9], [7, 8, 9]),
                         res([1.0, 0.0, 0.0], [14, 14, 14], [0, 0, 0])],
                        with_cat=True)
    assert out.gain.tolist() == [1.0, 3.0, 5.0]
    assert out.feature.tolist() == [0, 6, 2]            # shard 0, 1, 0
    assert out.bin.tolist() == [10, 16, 12]
    assert out.cat_words[:, 0].tolist() == [1, big, 3]
    # a shard's histogram in the pooled layout: its block of the 13 real
    # features, the pad columns dropped, its bins widened with the missing
    # slot last
    blk = cols.block(3)
    assert blk == (12, 4, 13, 0, True)
    h = torch.arange(2 * 4 * 3 * 2, dtype=torch.float32).reshape(2, 4, 3, 2)
    e = blk.embed(h)
    assert e.shape == (2, 13, 3, 2) and torch.equal(e[:, 12], h[:, 0])
    assert e[:, :12].abs().sum() == 0
    wide = blk._replace(nbins=5).embed(h)
    assert torch.equal(wide[:, 12, :2], h[:, 0, :2])
    assert torch.equal(wide[:, 12, 4], h[:, 0, 2])
    assert wide[:, 12, 2:4].abs().sum() == 0
    n_real = torch.full((13,), 7)
    assert blk.restrict(n_real).tolist() == [0] * 12 + [7]
    assert blk.local(torch.arange(13)[None]).tolist() == [[12, 0, 0, 0]]
    bits = cols.decide([torch.tensor([True, False, False]),
                        torch.tensor([False, False, True]),
                        torch.zeros(3, dtype=torch.bool),
                        torch.zeros(3, dtype=torch.bool)])
    assert bits.tolist() == [True, False, True]
