"""Monotone and interaction constraints in the port against the JAX
package, on the CPU (ROADMAP A.5.4).

- the parsers (``tree/param.py``): strings and lists, names in the
  interaction sets, singleton sets for the features no set mentions,
  None when unconstrained — equal outputs;
- ``evaluate_splits`` with ``monotone`` / ``node_lower`` /
  ``node_upper`` on seeded histograms of exact values: equal features,
  bins and directions, gains to 1e-6 of the node's scale;
- the helpers ``interaction_allowed_dev`` / ``_host`` and
  ``monotone_child_bounds_host`` bit for bit;
- depthwise and leaf-wise trees under monotone constraints, interaction
  constraints and both, 3 rounds on 4,000 x 10: node by node under
  ``tests/test_torch_train.py compare_tree`` (the JAX package through
  ``hist_method="prehot"``, its int8x2 integers in XLA; the port through
  its plain versions); and what the constraints promise: predictions
  never move against a constrained feature's sign, every path's
  features lie in one set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import compare_forests
from xgboost_tpu.ops.split import evaluate_splits as jax_evaluate
from xgboost_tpu.tree import grow as jax_grow
from xgboost_tpu.tree import param as jax_param
from xgboost_tpu_torch.ops.split import evaluate_splits
from xgboost_tpu_torch.tree import grow
from xgboost_tpu_torch.tree import param

N_ROWS, N_FEAT = 4000, 10
BASE = {"objective": "binary:logistic", "eta": 0.3, "base_score": 0.5}
MONO = "(1,0,-1,0,1)"
SETS = "[[0, 1], [2, 3], [1, 4, 5]]"


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N_ROWS, N_FEAT).astype(np.float32)
    X[rng.rand(N_ROWS, N_FEAT) < 0.03] = np.nan
    y = (X[:, 0] * X[:, 1] - np.nan_to_num(X[:, 2]) + 0.5 * X[:, 4]
         + 0.3 * rng.randn(N_ROWS) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("spec", [
    "(1,-1,0)", "(0,0)", "()", "", None, [1, 0, -1, 1, 0, 0, 0, 1],
    (0, 0, 0), "(1, -1, 0, 1, 0, 0, 0, 0, 0, 0, -1, 1)"])
def test_monotone_parser_equals_jax(spec):
    assert param.parse_monotone_constraints(spec, 10) == \
        jax_param.parse_monotone_constraints(spec, 10)


@pytest.mark.parametrize("spec,names", [
    ("[[0, 1], [2, 3]]", None), ("[[0],[1],[2]]", None),
    ("[['a', 'c'], ['b', 'd', 'e']]", list("abcdefgh")),
    ([["a", 3], [1, "h"]], list("abcdefgh")), ([[0, 7]], None),
    ("", None), (None, None), ("[]", None)])
def test_interaction_parser_equals_jax(spec, names):
    got = param.parse_interaction_constraints(spec, 8, names)
    want = jax_param.parse_interaction_constraints(spec, 8, names)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("has_missing", [True, False])
@pytest.mark.parametrize("max_delta_step", [0.0, 0.7])
def test_evaluate_splits_monotone_matches_jax(has_missing, max_delta_step):
    """Histograms of rows whose (g, h) are multiples of 1/64 (every sum
    exact in f32 in either order), bounds that bind at some nodes."""
    rng = np.random.RandomState(3)
    N, F, B, n = 6, 5, 17, 3000
    gh = np.stack([rng.randint(-40, 40, n), rng.randint(0, 30, n)],
                  -1) / 64.0
    bins = rng.randint(0, B if has_missing else B - 1, (n, F))
    node = rng.randint(0, N, n)
    hist = np.zeros((N, F, B, 2), np.float64)
    for f in range(F):
        np.add.at(hist[:, f], (node, bins[:, f]), gh)
    hist = hist.astype(np.float32)
    parent = hist[:, 0].sum(axis=1).astype(np.float32)
    n_real = np.asarray([B - 1 - int(has_missing)] * F, np.int64)
    lower = np.asarray([-np.inf, -0.2, -np.inf, 0.05, -0.5, -1], np.float32)
    upper = np.asarray([np.inf, np.inf, 0.1, 0.3, 0.5, 1], np.float32)
    mono = np.asarray([1, -1, 0, 1, -1], np.int64)
    kw = dict(reg_lambda=1.0, min_child_weight=0.1,
              max_delta_step=max_delta_step)
    want = jax_evaluate(jnp.asarray(hist), jnp.asarray(parent),
                        jnp.asarray(n_real), jax_param.TrainParam(**kw),
                        monotone=jnp.asarray(mono, jnp.int32),
                        node_lower=jnp.asarray(lower),
                        node_upper=jnp.asarray(upper),
                        has_missing=has_missing)
    got = evaluate_splits(torch.from_numpy(hist), torch.from_numpy(parent),
                          torch.from_numpy(n_real), param.TrainParam(**kw),
                          has_missing=has_missing,
                          monotone=torch.from_numpy(mono),
                          node_lower=torch.from_numpy(lower),
                          node_upper=torch.from_numpy(upper))
    for field in ("feature", "bin", "default_left"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.left_sum.numpy(),
                                  np.asarray(want.left_sum))


def test_constraint_helpers_bit_for_bit():
    rng = np.random.RandomState(5)
    cons = jax_param.parse_interaction_constraints(SETS, N_FEAT)
    paths = rng.rand(16, N_FEAT) < 0.15
    paths[0] = False
    want = np.asarray(jax_grow.interaction_allowed_dev(
        jnp.asarray(paths), jnp.asarray(cons)))
    np.testing.assert_array_equal(grow.interaction_allowed_dev(
        torch.from_numpy(paths), torch.from_numpy(cons)).numpy(), want)
    np.testing.assert_array_equal(
        grow.interaction_allowed_host(paths, cons), want)
    ls = (rng.randn(16, 2) * [3, 1] + [0, 4]).astype(np.float32)
    rs = (rng.randn(16, 2) * [3, 1] + [0, 4]).astype(np.float32)
    feat = rng.randint(-1, 6, 16)
    plo = np.where(rng.rand(16) < 0.5, -np.inf, -0.3).astype(np.float32)
    phi = np.where(rng.rand(16) < 0.5, np.inf, 0.4).astype(np.float32)
    mono = np.asarray([1, -1, 0, 1, -1, 1], np.int32)
    kw = dict(reg_lambda=1.5, reg_alpha=0.2)
    got = grow.monotone_child_bounds_host(ls, rs, feat, plo, phi, mono,
                                          param.TrainParam(**kw))
    want = jax_grow.monotone_child_bounds_host(
        ls, rs, feat, plo, phi, mono, jax_param.TrainParam(**kw))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def _both(X, y, params, rounds=3):
    jb = xgb.train(dict(params, hist_method="prehot"),
                   xgb.DMatrix(X, label=y), rounds, verbose_eval=False)
    tb = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y),
                  rounds, verbose_eval=False)
    return jb, tb


def _monotone_holds(bst, X, signs):
    """Sweep each constrained feature over 64 values on 200 rows: the
    predictions never move against its sign."""
    rows = np.nan_to_num(X[:200])
    for f, sign in enumerate(signs):
        if not sign:
            continue
        grid = np.repeat(rows, 64, axis=0)
        grid[:, f] = np.tile(np.linspace(-3, 3, 64, dtype=np.float32), 200)
        p = bst.predict(xt.DMatrix(grid)).reshape(200, 64)
        assert (sign * np.diff(p, axis=1) >= -1e-6).all(), f


def _paths_in_one_set(bst, cons):
    """Every root-to-leaf path's features lie in one constraint set."""
    for t in bst.gbm.trees:
        stack = [(0, frozenset())]
        while stack:
            i, path = stack.pop()
            if t.is_leaf[i]:
                assert any(all(cons[s, f] for f in path)
                           for s in range(cons.shape[0])), sorted(path)
                continue
            path = path | {int(t.split_feature[i])}
            stack += [(t.left_child[i], path), (t.right_child[i], path)]


# (grow policy params, constraints, trees equal in full as measured)
CASES = [
    ("depthwise", {"monotone_constraints": MONO}, 3),
    ("depthwise", {"interaction_constraints": SETS}, 3),
    ("depthwise", {"monotone_constraints": MONO,
                   "interaction_constraints": SETS}, 3),
    ("lossguide", {"monotone_constraints": MONO}, 3),
    ("lossguide", {"interaction_constraints": SETS}, 3),
    ("lossguide", {"monotone_constraints": MONO,
                   "interaction_constraints": SETS}, 3),
]
POLICY = {"depthwise": {"max_depth": 4},
          "lossguide": {"grow_policy": "lossguide", "max_leaves": 12,
                        "max_depth": 0}}


@pytest.mark.parametrize("policy,cons,full_min", CASES)
def test_constrained_trees_match_jax(data, policy, cons, full_min,
                                     monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = data
    params = dict(BASE, **POLICY[policy], **cons)
    jb, tb = _both(X, y, params)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3,
                                        capped=policy == "lossguide")
    print(f"{policy} {cons}: {full} trees equal in full, ties {ties}, "
          f"leaf drift {drift:.3e}")
    assert full >= full_min
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)),
                               jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                               atol=1e-4)
    if "monotone_constraints" in cons:
        _monotone_holds(tb, X, param.parse_monotone_constraints(
            cons["monotone_constraints"], N_FEAT))
    if "interaction_constraints" in cons:
        _paths_in_one_set(tb, param.parse_interaction_constraints(
            cons["interaction_constraints"], N_FEAT))


def test_constraints_follow_the_config_and_the_model(data):
    """``save_config`` carries the constraints and the grow policy; a
    loaded model parses them over its own feature count, names
    included."""
    X, y = data
    names = [f"x{i}" for i in range(N_FEAT)]
    params = dict(BASE, max_depth=3, monotone_constraints="(1,0,-1)",
                  interaction_constraints="[['x0', 'x1'], ['x2', 'x3']]",
                  grow_policy="lossguide", max_leaves=6, device="cpu")
    b = xt.train(params, xt.DMatrix(X, label=y, feature_names=names), 2,
                 verbose_eval=False)
    other = xt.Booster({"device": "cpu"})
    other.load_config(b.save_config())
    for k in ("grow_policy", "max_leaves", "monotone_constraints",
              "interaction_constraints"):
        assert getattr(other.tree_param, k) == getattr(b.tree_param, k)
    again = xt.Booster({"device": "cpu"}, model_file=b.save_raw("json"))
    again._configure(None)
    assert again.gbm.monotone == [1, 0, -1] + [0] * (N_FEAT - 3)
    np.testing.assert_array_equal(
        again.gbm.constraint_sets,
        jax_param.parse_interaction_constraints(
            "[[0, 1], [2, 3]]", N_FEAT))
    # one more round of the loaded model keeps its constraints
    more = xt.train({"device": "cpu"}, xt.DMatrix(X, label=y,
                                                  feature_names=names), 1,
                    xgb_model=b.save_raw("json"), verbose_eval=False)
    _paths_in_one_set(more, again.gbm.constraint_sets)
    _monotone_holds(more, X, again.gbm.monotone)


@pytest.mark.parametrize("kw", [{}, {"reg_alpha": 0.3},
                                {"max_delta_step": 0.4, "reg_lambda": 0.5},
                                {"reg_alpha": 0.1, "max_delta_step": 0.2}])
def test_lossguide_host_weight_is_the_jax_packages(kw):
    """Leaf-wise growth bounds its children by weights computed on the
    host from float64 sums, as the JAX package's ``calc_weight`` computes
    them on numpy scalars with 64-bit types off."""
    from xgboost_tpu_torch.tree.lossguide import host_weight

    rng = np.random.RandomState(2)
    for g, h in zip(rng.randn(200) * 50, np.abs(rng.randn(200)) * 30):
        g32, h32 = np.float64(np.float32(g)), np.float64(np.float32(h))
        want = np.asarray(jax_param.calc_weight(
            g32, h32, jax_param.TrainParam(**kw)), np.float32)
        got = host_weight(g32, h32, param.TrainParam(**kw))
        assert got.dtype == np.float32
        assert got == want, (g32, h32)
