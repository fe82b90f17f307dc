"""The adaptive-leaf objectives of the port (``objective/adaptive.py``:
``reg:absoluteerror`` and ``reg:quantileerror``) against the JAX package
on the CPU.

``segment_quantiles`` is held bit for bit in float64 against the JAX
package's ``_weighted_quantile`` on each leaf's rows (and, cast to f32,
against its ``segment_quantiles``), with and without weights, with tied
residuals, a one-row leaf and a leaf no row reaches. Models (MAE, and
three alphas of the pinball loss) are compared under
``tests/test_torch_train.py compare_forests`` with the number of trees
equal in full asserted as measured on the CPU: the surrogate gradients
are a sign or an alpha with unit hessians, so both packages build the
same histograms, and the refreshed leaves are quantiles of the same
residuals. After every round the port's margin cache equals
``predict`` of its saved and reloaded model within rtol 1e-6 (the same
leaves, summed in the walk's order: the cache moves by the refreshed
leaves, not the grower's, which differ by far more).
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.objective.adaptive import (
    _weighted_quantile as jax_weighted_quantile,
    segment_quantiles as jax_segment_quantiles)
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.objective.adaptive import (parse_alphas,
                                                  segment_quantiles)

from test_torch_train import LEAF_ATOL, compare_forests

CPU = {"device": "cpu"}
ALPHAS = [0.05, 0.5, 0.95]


def _segments(case, weighted, seed=0):
    """(positions [n], residuals [n] f64, weights or None, leaves [L])."""
    rng = np.random.default_rng(seed)
    n = 3000
    pos = rng.choice(np.asarray([1, 3, 4, 8, 11, 12]), n,
                     p=[0.3, 0.2, 0.2, 0.15, 0.1, 0.05])
    res = rng.normal(size=n)
    if case == "ties":
        res = np.round(res * 4) / 4                    # many equal values
    elif case == "one_row":
        pos[pos == 11] = 3
        pos[0] = 11                                    # leaf 11: one row
    leaves = np.asarray([1, 3, 4, 7, 8, 11, 12])      # leaf 7: no row
    if case == "one_row":
        leaves = np.asarray([1, 3, 4, 8, 11, 12])
    w = None
    if weighted:
        w = rng.choice(np.asarray([0.1, 0.5, 1.0, 2.0, 0.3]), n)
        if case == "ties":
            w = np.full(n, 0.1)                        # sums round in f64
    return pos, res, w, leaves


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["plain", "ties", "one_row"])
@pytest.mark.parametrize("alpha", [0.05, 0.5, 0.9])
def test_segment_quantiles_bit_for_bit(case, weighted, alpha):
    pos, res, w, leaves = _segments(case, weighted)
    got = segment_quantiles(
        torch.from_numpy(pos), torch.from_numpy(res),
        None if w is None else torch.from_numpy(w),
        torch.from_numpy(leaves), alpha).numpy()
    assert got.dtype == np.float64 and got.shape == leaves.shape
    for i, leaf in enumerate(leaves):
        rows = pos == leaf
        want = jax_weighted_quantile(res[rows],
                                     None if w is None else w[rows], alpha)
        assert got[i] == want, (leaf, got[i], want)
    np.testing.assert_array_equal(
        got.astype(np.float32),
        jax_segment_quantiles(pos, res, w, leaves, alpha))
    if case != "one_row":
        assert got[list(leaves).index(7)] == 0.0


@pytest.mark.parametrize("given,want", [
    ([0.05, 0.5, 0.95], ALPHAS), (0.3, [0.3]), ("0.3", [0.3]),
    ("[0.05, 0.5, 0.95]", ALPHAS), ((0.1, 0.9), [0.1, 0.9])])
def test_alpha_parsing(given, want):
    assert parse_alphas(given) == want
    obj = get_objective("reg:quantileerror", {"quantile_alpha": given})
    assert obj.alphas() == want and obj.n_targets() == len(want)


def _data(n=2000, F=6, seed=0, weighted=False):
    """Heteroscedastic regression: the noise's spread grows with
    feature 1, so the quantiles fan out."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + (0.5 + np.abs(X[:, 1])) * rng.normal(size=n)).astype(
        np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32) if weighted else None
    return X, y, w


# (params, data keywords, rounds, trees equal in full as measured)
MAE = {"objective": "reg:absoluteerror"}
QUANT = {"objective": "reg:quantileerror", "quantile_alpha": ALPHAS}
CASES = {
    "mae_depthwise": (MAE, {}, 4, 4),
    "mae_weighted": (MAE, {"weighted": True}, 4, 4),
    "mae_lossguide": (dict(MAE, grow_policy="lossguide", max_leaves=9,
                           max_depth=0), {}, 4, 4),
    "mae_parallel_trees": (dict(MAE, num_parallel_tree=2,
                                colsample_bynode=0.7), {}, 3, 6),
    "mae_subsample": (dict(MAE, subsample=0.5), {}, 4, 4),
    "mae_dart": (dict(MAE, booster="dart", rate_drop=0.5), {}, 4, 4),
    "quantile_depthwise": (QUANT, {}, 3, 9),
    "quantile_weighted": (QUANT, {"weighted": True}, 3, 9),
    "quantile_lossguide": (dict(QUANT, grow_policy="lossguide",
                                max_leaves=9, max_depth=0), {}, 3, 9),
    "quantile_parallel_trees": (dict(QUANT, num_parallel_tree=2), {}, 2,
                                12),
    # the first tree meets an exact tie at node 4 (gap 0.0: the pinball
    # loss's two gradient values a target make equal sums common), so
    # the end-to-end comparison stops there
    "quantile_subsample": (dict(QUANT, subsample=0.5), {}, 3, 0),
    "quantile_dart": (dict(QUANT, booster="dart", rate_drop=0.5), {}, 3,
                      9),
}


def _train_both(params, data_kw, rounds):
    X, y, w = _data(**data_kw)
    p = dict({"max_depth": 3, "eta": 0.3}, **params)
    jb = xgb.train(dict(p, hist_method="prehot"),
                   xgb.DMatrix(X, label=y, weight=w), rounds,
                   verbose_eval=False)
    tb = xt.train(dict(p, **CPU), xt.DMatrix(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    return jb, tb, X


@pytest.mark.parametrize("case", list(CASES))
def test_models_match_jax(case):
    params, data_kw, rounds, full_min = CASES[case]
    jb, tb, X = _train_both(params, data_kw, rounds)
    assert len(tb.gbm.trees) == len(jb.gbm.trees)
    assert tb.gbm.tree_info == jb.gbm.tree_info
    np.testing.assert_array_equal(tb._base_np(), np.asarray(jb._base_np()))
    full, ties, drift = compare_forests(
        jb.gbm.trees, tb.gbm.trees, 0.3,
        capped="lossguide" in case)
    print(f"{case}: {full} of {len(tb.gbm.trees)} trees equal in full, "
          f"ties {ties}, largest leaf drift {drift:.3e}")
    assert full >= full_min
    got = tb.predict(xt.DMatrix(X))
    if params["objective"] == "reg:quantileerror":
        assert got.shape == (len(X), 3)
        # the outer quantiles are ordered on most rows
        assert np.mean(got[:, 0] <= got[:, 2]) > 0.9
    rounds_full = full // (len(tb.gbm.trees) // tb.num_boosted_rounds())
    if rounds_full:
        want = jb.predict(xgb.DMatrix(X), iteration_range=(0, rounds_full))
        got = tb.predict(xt.DMatrix(X), iteration_range=(0, rounds_full))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=LEAF_ATOL)


@pytest.mark.parametrize("case", ["mae_depthwise", "quantile_lossguide",
                                  "mae_parallel_trees", "quantile_dart"])
def test_margin_cache_equals_reloaded_predict(case):
    """After every round the training cache's margin is the margin of the
    saved model: its leaves are the refreshed ones."""
    params, data_kw, rounds, _ = CASES[case]
    X, y, w = _data(**data_kw)
    dm = xt.DMatrix(X, label=y, weight=w)
    b = xt.Booster(dict({"max_depth": 3, "eta": 0.3}, **params, **CPU))
    for it in range(rounds):
        b.update(dm, it)
        cache = b._cached_margin(dm, is_train=True).numpy()
        again = xt.Booster(CPU, model_file=b.save_raw("json"))
        want = again.predict(xt.DMatrix(X), output_margin=True,
                             strict_shape=True)
        # the same leaves; the walk adds them in its own order
        np.testing.assert_allclose(cache, want, rtol=1e-6, atol=1e-6)


def test_label_matrix_is_refused():
    """The JAX package's leaf refresh flattens a label matrix and fails
    with a numpy broadcast error; the port refuses it up front, naming
    ROADMAP C."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1000, 4)).astype(np.float32)
    Y = np.stack([3 * X[:, 0], -2 * X[:, 1]], axis=1).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        xgb.train({"objective": "reg:absoluteerror", "max_depth": 3},
                  xgb.DMatrix(X, label=Y), 5, verbose_eval=False)
    for objective in ("reg:absoluteerror", "reg:quantileerror"):
        with pytest.raises(ValueError, match="ROADMAP C"):
            xt.train({"objective": objective, "max_depth": 3, **CPU},
                     xt.DMatrix(X, label=Y), 5, verbose_eval=False)


def test_vector_leaves_are_refused():
    X, y, _ = _data(n=500)
    with pytest.raises(NotImplementedError, match="adaptive"):
        xt.train(dict(QUANT, multi_strategy="multi_output_tree", **CPU),
                 xt.DMatrix(X, label=y), 1, verbose_eval=False)


def test_quantile_metric_and_base_scores_round_trip(tmp_path):
    """The default ``quantile`` metric on the eval line, the three
    intercepts in the native file, and the reference schema's scalar
    ``base_score`` (target 0's, with the JAX package's warning)."""
    X, y, _ = _data(n=1500)
    dm = xt.DMatrix(X, label=y)
    res = {}
    b = xt.train(dict(QUANT, max_depth=3, **CPU), dm, 3,
                 evals=[(dm, "train")], evals_result=res,
                 verbose_eval=False)
    assert list(res["train"]) == ["quantile"]
    again = xt.Booster(CPU, model_file=b.save_raw("ubj"))
    np.testing.assert_array_equal(again._base_np(), b._base_np())
    assert again.obj.alphas() == ALPHAS and again.n_groups == 3
    with pytest.warns(UserWarning, match="target 0"):
        xt.save_xgboost_model(b, str(tmp_path / "ref.json"))
    ref = xt.load_xgboost_model(str(tmp_path / "ref.json"), device="cpu")
    assert ref.obj.alphas() == ALPHAS
    rows = np.broadcast_to(b._base_np(), (len(X), 3)).astype(np.float32)
    dmb = xt.DMatrix(X, base_margin=rows)
    np.testing.assert_array_equal(ref.predict(dmb), b.predict(dmb))
