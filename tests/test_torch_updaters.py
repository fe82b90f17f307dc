"""``process_type="update"`` in the port (``xgboost_tpu_torch/tree/
updaters.py``, ``core.py Booster._update_existing_trees``) against the
JAX package, on the CPU.

ROADMAP C.1's input: a 3-round ``binary:logistic`` model refreshed with
``updater="refresh"`` (and ``"refresh,prune"``) for 3 rounds is still 3
rounds, its trees the JAX package's node by node under
``tests/test_torch_train.py compare_tree``; a fourth round finds no
trees to update. The updaters themselves are held bit for bit on one
tree and one gradient: ``route_rows``' leaves, ``refresh_tree``'s
float64 sums (cast to f32), ``prune_tree``'s collapsed and renumbered
tree.
"""

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import compare_tree
from xgboost_tpu.tree import updaters as jax_updaters
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu.tree.tree import TreeModel as JaxTree
from xgboost_tpu_torch.tree import updaters
from xgboost_tpu_torch.tree.param import TrainParam
from xgboost_tpu_torch.tree.tree import TreeModel

PARAMS = {"objective": "binary:logistic", "max_depth": 3}


@pytest.fixture(scope="module")
def c1():
    """ROADMAP C.1's smallest input and the 3-round models of both
    packages (the JAX package's through ``prehot``, K2's integers)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.normal(size=2000) > 0).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        jb = xgb.train(dict(PARAMS, hist_method="prehot"),
                       xgb.DMatrix(X, label=y), 3, verbose_eval=False)
    tb = xt.train(dict(PARAMS, device="cpu"), xt.DMatrix(X, label=y), 3,
                  verbose_eval=False)
    return X, y, jb, tb


@pytest.mark.parametrize("updater", ["refresh", "refresh,prune",
                                     "refresh,prune,sync"])
def test_c1_refresh_keeps_the_rounds(c1, updater):
    X, y, jb, tb = c1
    p = dict(PARAMS, process_type="update", updater=updater,
             refresh_leaf=True, gamma=0.5)
    jd, td = xgb.DMatrix(X, label=y), xt.DMatrix(X, label=y)
    jr = xgb.train(p, jd, 3, xgb_model=jb.copy(), verbose_eval=False)
    tr = xt.train(dict(p, device="cpu"), td, 3,
                  xgb_model=xt.Booster({"device": "cpu"},
                                       model_file=tb.save_raw("json")),
                  verbose_eval=False)
    assert tr.num_boosted_rounds() == jr.num_boosted_rounds() == 3
    assert len(tr.gbm.trees) == 3
    for r, (a, b) in enumerate(zip(jr.gbm.trees, tr.gbm.trees)):
        ties, _ = compare_tree(a, b, eta=0.3, r=r)
        assert not ties
        np.testing.assert_allclose(b.sum_hess, a.sum_hess, rtol=1e-5)
    # the refreshed model predicts what its trees say, and is not the
    # model it started from
    np.testing.assert_allclose(tr.predict(td), jr.predict(jd), rtol=1e-5,
                               atol=1e-5)
    assert not np.array_equal(tr.gbm.trees[1].leaf_value,
                              tb.gbm.trees[1].leaf_value)
    with pytest.raises(ValueError, match="no more trees to update"):
        xt.train(dict(p, device="cpu"), td, 1, xgb_model=tr,
                 verbose_eval=False)


def test_unknown_updater_is_refused(c1):
    X, y, _, tb = c1
    with pytest.raises(ValueError, match="unknown updater 'grow_colmaker'"):
        xt.train(dict(PARAMS, device="cpu", process_type="update",
                      updater="refresh,grow_colmaker"),
                 xt.DMatrix(X, label=y), 1,
                 xgb_model=xt.Booster({"device": "cpu"},
                                      model_file=tb.save_raw("json")))


def _tree_pair(tb):
    obj = tb.gbm.trees[2].to_json()
    return JaxTree.from_json(obj), TreeModel.from_json(obj)


@pytest.mark.parametrize("refresh_leaf", [True, False])
def test_route_and_refresh_bit_for_bit(c1, refresh_leaf):
    """The same tree and gradients: the same leaves, node sums and
    weights; the port's input tree is left as it was."""
    X, _, _, tb = c1
    jt, tt = _tree_pair(tb)
    Xn = X.copy()
    Xn[::7, 0] = np.nan                       # the default directions too
    np.testing.assert_array_equal(updaters.route_rows(tt, Xn),
                                  jax_updaters.route_rows(jt, Xn))
    rng = np.random.RandomState(1)
    gpair = np.stack([rng.randn(len(X)), rng.rand(len(X))],
                     axis=1).astype(np.float32)
    before = tt.leaf_value.copy()
    want = jax_updaters.refresh_tree(jt, Xn, gpair, JaxTrainParam(eta=0.7),
                                     refresh_leaf=refresh_leaf)
    got = updaters.refresh_tree(tt, Xn, gpair, TrainParam(eta=0.7),
                                refresh_leaf=refresh_leaf)
    for f in ("sum_hess", "base_weight", "leaf_value"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(tt.leaf_value, before)


@pytest.mark.parametrize("gamma", [0.0, 5.0, 1e9])
def test_prune_bit_for_bit(c1, gamma):
    _, _, _, tb = c1
    jt, tt = _tree_pair(tb)
    want = jax_updaters.prune_tree(jt, JaxTrainParam(gamma=gamma))
    got = updaters.prune_tree(tt, TrainParam(gamma=gamma))
    assert got.to_json() == want.to_json()
    if gamma == 1e9:
        assert got.num_nodes() == 1


@pytest.mark.parametrize("updater", ["refresh", "refresh,prune"])
def test_refresh_on_agaricus_files_matches_jax(tmp_path, updater):
    """The demo's 2-round model (depth 2, ``eta`` 1) on agaricus-shaped
    libsvm files, refreshed for its 2 rounds with ``refresh_leaf`` off:
    node sums and base weights the JAX package's, leaves kept."""
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    y, idx = agaricus_rows(1500, seed=8)
    path = str(tmp_path / "agaricus.txt.train")
    write_libsvm(path, y, idx)
    uri = path + "?format=libsvm"
    p = {"objective": "binary:logistic", "max_depth": 2, "eta": 1.0}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(uri), 2,
                  verbose_eval=False)
    raw = tb.save_raw("json")
    up = dict(p, process_type="update", updater=updater, refresh_leaf=False)
    jr = xgb.train(up, xgb.DMatrix(uri), 2,
                   xgb_model=xgb.Booster(model_file=raw), verbose_eval=False)
    tr = xt.train(dict(up, device="cpu"), xt.DMatrix(uri), 2,
                  xgb_model=xt.Booster({"device": "cpu"}, model_file=raw),
                  verbose_eval=False)
    assert tr.num_boosted_rounds() == jr.num_boosted_rounds() == 2
    for r, (a, b, c) in enumerate(zip(jr.gbm.trees, tr.gbm.trees,
                                      tb.gbm.trees)):
        assert not compare_tree(a, b, eta=1.0, r=r)[0]
        np.testing.assert_allclose(b.sum_hess, a.sum_hess, rtol=1e-5)
        np.testing.assert_allclose(b.base_weight, a.base_weight, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(b.leaf_value[b.is_leaf],
                                      c.leaf_value[c.is_leaf])
