"""Multi-target training at MediaMill's 101 labels, on the CPU at a
small row count, and ``multi:softprob`` with vector leaves: the port
against the JAX package (``tests/test_torch_multi_target_train.py``
holds the smaller K and the comparison's helpers)."""

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt

from test_torch_multi_target_train import VEC, _check, _data, _train_both
from test_torch_train import LEAF_ATOL, compare_forests

# one_output_per_tree at K = 101: target chains equal in full, as measured
# on the CPU
CHAINS_FULL = 98


@pytest.mark.parametrize("strategy,trees,full_min", [
    ("one_output_per_tree", 202, 47), ("multi_output_tree", 2, 2)])
def test_101_labels(strategy, trees, full_min):
    """K = 101, MediaMill's label count, at a small row count: 0/1 labels
    with ``binary:logistic``, both strategies. One tree a target grows
    101 independent chains of trees (target k's are trees k, k + 101, ...),
    so a near tie in one target leaves the others' trees alone: each
    chain is also compared on its own, ``CHAINS_FULL`` of them agree in
    full, and each of those targets' prediction columns is held to the
    JAX package's."""
    X, Y = _data(800, F=10, K=101, seed=5, binary=True)
    params = {"objective": "binary:logistic", "max_depth": 3,
              "multi_strategy": strategy}
    jb, tb = _train_both(params, X, Y, 2)
    np.testing.assert_array_equal(tb.base_margin_,
                                  np.asarray(jb.base_margin_))
    _check(jb, tb, X, trees, full_min)
    if strategy == "one_output_per_tree":
        _check_chains(jb, tb, X, 101)


def _check_chains(jb, tb, X, K):
    full = []
    for k in range(K):
        chain = jb.gbm.trees[k::K]
        n_full, _, _ = compare_forests(chain, tb.gbm.trees[k::K], 0.3)
        if n_full == len(chain):
            full.append(k)
    print(f"{len(full)} of {K} target chains equal in full")
    assert len(full) >= CHAINS_FULL
    want = jb.predict(xgb.DMatrix(X))
    got = tb.predict(xt.DMatrix(X))
    assert got.shape == want.shape == (len(X), K)
    np.testing.assert_allclose(got[:, full], want[:, full], rtol=1e-5,
                               atol=LEAF_ATOL)


def test_softprob_vector_leaves():
    """``multi:softprob`` with ``multi_output_tree``: one vector-leaf tree
    a round over the ``num_class`` outputs."""
    rng = np.random.RandomState(0)
    X = rng.randn(1500, 6).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.6 * rng.randn(1500, 3), 1).astype(np.float32)
    jb, tb = _train_both({"objective": "multi:softprob", "num_class": 3,
                          "max_depth": 4, **VEC}, X, y, 3)
    assert tb.gbm.trees[0].leaf_value.shape[1] == 3
    _check(jb, tb, X, 3, 3)
