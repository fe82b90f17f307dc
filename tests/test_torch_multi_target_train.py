"""Whole multi-target models trained by the port and by the JAX package
on the CPU: one tree a target (``one_output_per_tree``) and vector-leaf
trees (``multi_output_tree``), depthwise and lossguide, with
``max_leaves``, interaction constraints, row and column sampling,
and parallel trees, at K = 2 to 4 (K = 101 and ``multi:softprob`` are
in ``tests/test_torch_multi_target_k101.py``).

Both packages build the same integer histograms (the JAX package with
``hist_method="prehot"``), so trees are compared node for node with
``tests/test_torch_train.py compare_forests`` (each target's leaf weight
at rtol 1e-5 plus ``LEAF_ATOL``, the summed gain under the near-tie
certificate, ``GAIN_RTOL`` unchanged) and predictions [n, K] at the same
tolerance over the trees equal in full. The number of trees equal in
full is asserted as measured on the CPU.
"""

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt

from test_torch_train import LEAF_ATOL, compare_forests

CPU = {"device": "cpu"}
VEC = {"multi_strategy": "multi_output_tree"}
LG = {"grow_policy": "lossguide", "max_depth": 0}


def _data(n, F=8, K=3, seed=3, binary=False, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    Y = X @ rng.randn(F, K) + 0.5 * rng.randn(n, K)
    Y = (Y > 1.0).astype(np.float32) if binary else Y.astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return X, Y


def _train_both(params, X, Y, rounds):
    p = dict({"eta": 0.3}, **params)
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=Y),
                   rounds, verbose_eval=False)
    tb = xt.train(dict(p, **CPU), xt.DMatrix(X, label=Y), rounds,
                  verbose_eval=False)
    return jb, tb


def _check(jb, tb, X, n_trees, full_min, capped=False):
    assert len(tb.gbm.trees) == len(jb.gbm.trees) == n_trees
    assert tb.gbm.tree_info == jb.gbm.tree_info
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3,
                                        capped=capped)
    print(f"{full} of {n_trees} trees equal in full, near ties {ties}, "
          f"largest leaf drift {drift:.3e}")
    assert full >= full_min
    per_round = len(tb.gbm.trees) // tb.num_boosted_rounds()
    rounds = full // per_round          # the rounds whose trees all agree
    if rounds:
        want = jb.predict(xgb.DMatrix(X), iteration_range=(0, rounds))
        got = tb.predict(xt.DMatrix(X), iteration_range=(0, rounds))
        assert got.shape == want.shape == (len(X), tb.n_groups)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=LEAF_ATOL)
    return full


# (params, data keywords, rounds, trees, trees equal in full as measured)
CASES = {
    "per_tree_k2": ({"objective": "reg:squarederror", "max_depth": 4},
                    dict(n=1000, K=2), 3, 6, 6),
    "vector_depthwise": ({"objective": "reg:squarederror", "max_depth": 4,
                          **VEC}, dict(n=1000), 3, 3, 3),
    "vector_logistic": ({"objective": "binary:logistic", "max_depth": 4,
                         **VEC}, dict(n=1000, K=4, binary=True), 3, 3, 3),
    "vector_max_leaves_interaction": (
        {"objective": "reg:squarederror", "max_depth": 4, "max_leaves": 9,
         "interaction_constraints": "[[0, 1], [2, 3, 4]]", **VEC},
        dict(n=1000), 3, 3, 3),
    "vector_lossguide_interaction": (
        {"objective": "reg:squarederror", "max_leaves": 10,
         "interaction_constraints": "[[0, 1], [2, 3, 4]]", **LG, **VEC},
        dict(n=1000), 3, 3, 3),
    "vector_sampled": ({"objective": "reg:squarederror", "max_depth": 4,
                        "subsample": 0.8, "colsample_bytree": 0.8,
                        "colsample_bynode": 0.7, **VEC},
                       dict(n=1000), 3, 3, 3),
    "vector_lossguide_sampled": (
        {"objective": "reg:squarederror", "max_leaves": 10,
         "colsample_bynode": 0.6, "subsample": 0.8, **LG, **VEC},
        dict(n=1000), 3, 3, 3),
    "vector_parallel": ({"objective": "reg:squarederror", "max_depth": 3,
                         "num_parallel_tree": 2, **VEC},
                        dict(n=1000), 2, 4, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_models_match_jax(case):
    """Node for node under the certificate; vector-leaf regression also
    bit for bit: with squared error the two packages' gradients are the
    same bits, and the port adds the intercepts, the root sums, the
    prefix sums and the sums over the targets in the JAX package's
    order, so its trees save the JAX package's JSON."""
    params, data, rounds, n_trees, full_min = CASES[case]
    X, Y = _data(**data)
    jb, tb = _train_both(params, X, Y, rounds)
    capped = "max_leaves" in params and params.get("grow_policy") == \
        "lossguide"
    _check(jb, tb, X, n_trees, full_min, capped=capped)
    if params.get("multi_strategy") and \
            params["objective"] == "reg:squarederror":
        np.testing.assert_array_equal(tb.base_margin_,
                                      np.asarray(jb.base_margin_))
        assert [t.to_json() for t in tb.gbm.trees] == \
            [t.to_json() for t in jb.gbm.trees]
    if "interaction_constraints" in params:
        # every path uses features of one constraint set only
        sets = [{0, 1}, {2, 3, 4}]
        for t in tb.gbm.trees:
            for leaf in np.nonzero(t.is_leaf)[0]:
                used, c = set(), int(leaf)
                while t.parent[c] >= 0:
                    c = int(t.parent[c])
                    used.add(int(t.split_feature[c]))
                assert len(used) <= 1 or any(used <= s for s in sets)


def test_eval_history_and_continuation():
    """Evaluation over a label matrix (rows weighted, targets averaged)
    gives the JAX package's history; training continued from a saved
    vector-leaf model grows the trees of one uninterrupted run."""
    X, Y = _data(1200, K=3)
    w = (1 + np.arange(1200) % 4).astype(np.float32)
    p = {"objective": "reg:squarederror", "max_depth": 3, "eta": 0.3,
         "eval_metric": ["rmse", "mae"], **VEC}
    res_j, res_t = {}, {}
    xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=Y,
                                                         weight=w), 3,
              evals=[(xgb.DMatrix(X, label=Y, weight=w), "t")],
              evals_result=res_j, verbose_eval=False)
    dm = xt.DMatrix(X, label=Y, weight=w)
    three = xt.train(dict(p, **CPU), dm, 3, evals=[(dm, "t")],
                    evals_result=res_t, verbose_eval=False)
    for m in ("rmse", "mae"):
        np.testing.assert_allclose(res_t["t"][m], res_j["t"][m], rtol=1e-5)
    assert res_t["t"]["rmse"][-1] < res_t["t"]["rmse"][0]
    one = xt.train(dict(p, **CPU), dm, 1, verbose_eval=False)
    more = xt.train(dict(p, **CPU), dm, 2, verbose_eval=False,
                    xgb_model=one.save_raw("json"))
    assert more.num_boosted_rounds() == 3
    for a, b in zip(three.gbm.trees, more.gbm.trees):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)
