"""Row and column sampling in the port against the JAX package, on the
CPU.

The draws are bit for bit: ``sample_gradients`` (``uniform``), the
feature masks of a tree, of its levels and of its nodes, including the
f32 product of ``ceil(frac * count)`` (JAX gives 16 for 0.3 x 50 and for
0.6 x 25, where the exact product gives 15) and features without real
bins, which take no draw. ``gradient_based`` sums ``sqrt(g^2 + lambda
h^2)`` over the rows in f32, and the two packages add in different
orders: a row's probability can differ by an ulp or two, and its keep
decision flips only where its uniform draw lies between the two
probabilities. The test shows that this is the only difference.

Trained models with ``subsample``, ``colsample_by*`` below 1 and
``num_parallel_tree`` above 1 are held as the main path is
(``tests/test_torch_train.py``): trees node by node under the near-tie
certificate, end to end until the first near tie and then round by
round (the port grows round r from the JAX model's margin before it,
with round r's key), leaves and predictions at rtol 1e-5 plus 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import LEAF_ATOL, compare_tree
from xgboost_tpu.boosting.gbtree import sample_gradients as jax_sample
from xgboost_tpu.tree.grow import _sample_features as jax_features
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.boosting.gbtree import sample_gradients
from xgboost_tpu_torch.tree.grow import draw_feature_masks, sample_features
from xgboost_tpu_torch.tree.param import TrainParam
from xgboost_tpu_torch.utils import random as xrandom


def _jkey(seed, *folds):
    k = jax.random.key(np.uint32(seed))
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _tkey(seed, *folds):
    k = xrandom.key(seed)
    for d in folds:
        k = xrandom.fold_in(k, d)
    return k


def _gpair(n, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(n, 2).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1]) + 0.01
    g[rng.rand(n) < 0.05] = 0.0                  # rows already sampled out
    return g


# ---- the draws -----------------------------------------------------------------

@pytest.mark.parametrize("n,subsample", [(1, 0.5), (1001, 0.8),
                                         (2 ** 17 + 3, 0.5)])
def test_uniform_row_sampling_bit_for_bit(n, subsample):
    g = _gpair(n, n)
    for it, k in ((0, 0), (3, 5)):
        want = np.asarray(jax_sample(
            jnp.asarray(g), _jkey(it, it, k),
            JaxTrainParam(subsample=subsample)))
        got = sample_gradients(torch.from_numpy(g), _tkey(it, it, k),
                               TrainParam(subsample=subsample)).numpy()
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [1000, 50_000])
def test_gradient_based_sampling_differs_only_at_its_f32_sum(n):
    g = _gpair(n, 7)
    jp = JaxTrainParam(subsample=0.5, sampling_method="gradient_based")
    tp = TrainParam(subsample=0.5, sampling_method="gradient_based")
    want = np.asarray(jax_sample(jnp.asarray(g), _jkey(0, 0, 2), jp))
    got = sample_gradients(torch.from_numpy(g), _tkey(0, 0, 2), tp).numpy()
    # each package's keep probability and the shared uniform draw
    gj = jnp.asarray(g)
    u = jnp.sqrt(gj[:, 0] ** 2 + jp.reg_lambda * gj[:, 1] ** 2)
    p_jax = np.asarray(jnp.minimum(1.0, 0.5 * n * u / (jnp.sum(u) + 1e-30)))
    gt = torch.from_numpy(g)
    ut = torch.sqrt(gt[:, 0] * gt[:, 0] + 1.0 * (gt[:, 1] * gt[:, 1]))
    p_port = torch.clamp(float(np.float32(0.5 * n)) * ut / (ut.sum() + 1e-30),
                         max=1.0).numpy()
    draw = xrandom.uniform(_tkey(0, 0, 2, 0x5AB), (n,)).numpy()
    # the probabilities: within a few ulps of each other
    np.testing.assert_allclose(p_port, p_jax, rtol=4 * 2.0 ** -23, atol=0)
    kept_j, kept_t = want[:, 0] != 0, got[:, 0] != 0
    both = (want != 0).any(axis=1) & (got != 0).any(axis=1)
    flip = ((want != 0).any(axis=1)) != ((got != 0).any(axis=1))
    # a decision flips only where the draw lies between the two p's
    lo, hi = np.minimum(p_port, p_jax), np.maximum(p_port, p_jax)
    assert np.all((draw[flip] >= lo[flip]) & (draw[flip] <= hi[flip]))
    print(f"gradient_based n={n}: {int(flip.sum())} keep decisions of "
          f"{n} flip, max |p_port - p_jax| "
          f"{np.abs(p_port - p_jax).max():.3e}")
    # kept rows are scaled by 1/p: equal up to p's ulps
    np.testing.assert_allclose(got[both], want[both], rtol=8 * 2.0 ** -23)
    assert kept_j.sum() > 0 and kept_t.sum() > 0


@pytest.mark.parametrize("frac,count,F", [(0.3, 50, 64), (0.6, 25, 54),
                                          (0.8, 54, 54), (0.5, 44, 54),
                                          (0.01, 10, 12), (0.999, 7, 9)])
def test_sample_features_bit_for_bit(frac, count, F):
    """One mask per key; the f32 ceil (16 of 50 at 0.3, 16 of 25 at 0.6);
    features outside the base mask never drawn."""
    rng = np.random.RandomState(count)
    base = np.zeros(F, bool)
    base[rng.choice(F, count, replace=False)] = True
    for seed in range(4):
        want = np.asarray(jax_features(_jkey(seed, 0xC0), jnp.asarray(base),
                                       frac))
        got = sample_features(_tkey(seed, 0xC0), torch.from_numpy(base),
                              frac).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[~base].any()
    k = int(np.ceil(np.float32(frac) * np.float32(count)))
    assert got.sum() == min(max(k, 1), F)
    if (frac, count) in ((0.3, 50), (0.6, 25)):
        assert got.sum() == 16


def _jax_tree_masks(tkey, n_real, p: JaxTrainParam, depth):
    """The JAX package's masks of one tree, as ``TreeGrower.grow`` and
    ``_grow`` draw them: [level][n_level or 1, F]."""
    tree = jax_features(jax.random.fold_in(tkey, 0xC0),
                        jnp.asarray(n_real > 0), p.colsample_bytree)
    key = jax.random.fold_in(tkey, 0x5EED)
    out = []
    for d in range(depth):
        lk = jax.random.fold_in(key, d)
        level = jax_features(lk, tree, p.colsample_bylevel)
        if p.colsample_bynode < 1.0:
            nk = jax.random.split(jax.random.fold_in(lk, 1), 2 ** d)
            out.append(np.asarray(jax.vmap(lambda k: jax_features(
                k, level, p.colsample_bynode))(nk)))
        else:
            out.append(np.asarray(level)[None])
    return out


@pytest.mark.parametrize("cols", [(0.6, 1.0, 1.0), (1.0, 0.7, 1.0),
                                  (1.0, 1.0, 0.5), (0.8, 0.8, 0.8),
                                  (0.3, 1.0, 0.6)])
def test_tree_level_node_masks_bit_for_bit(cols):
    """``draw_feature_masks`` (every tree of a round at once) against the
    JAX package's per-tree draws, at depth 6 over 54 features of which
    four have no real bins."""
    n_real = np.full(54, 256)
    n_real[[3, 17, 40, 53]] = 0
    keys = dict(zip(("colsample_bytree", "colsample_bylevel",
                     "colsample_bynode"), cols))
    jp, tp = JaxTrainParam(**keys), TrainParam(**keys)
    round_key_j, round_key_t = _jkey(0, 4), _tkey(0, 4)
    tkeys = [xrandom.fold_in(round_key_t, i) for i in range(7)]
    got = draw_feature_masks(tkeys, torch.from_numpy(n_real > 0), tp, 6)
    for i in range(7):
        want = _jax_tree_masks(jax.random.fold_in(round_key_j, i), n_real,
                               jp, 6)
        for d in range(6):
            np.testing.assert_array_equal(got[i][d].numpy(), want[d])
            assert not got[i][d].numpy()[:, [3, 17, 40, 53]].any()
    assert draw_feature_masks(tkeys, torch.ones(54, dtype=torch.bool),
                              TrainParam(), 6) is None


# ---- trained models ------------------------------------------------------------

ROUNDS = 6


def _data(n=3000, F=10, K=1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if K == 1:
        y = (X @ rng.randn(F) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    else:
        y = np.argmax(X @ rng.randn(F, K) + 0.5 * rng.randn(n, K),
                      axis=1).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    return X, y


def check_against_jax(X, y, params, rounds, full_min, clean_min):
    """Both packages train ``rounds`` rounds of ``params`` (JAX with
    ``prehot``, the port with ``auto``: the same int8x2 sums). End to end:
    trees compared until the first with a near tie (at least
    ``full_min`` equal in full) and predictions of those rounds. Round by
    round: the port grows round r (its key included, through
    ``Booster.update(dm, r)``) from the JAX model's margin before it; at
    least ``clean_min`` rounds with no near tie. Returns both boosters."""
    jb = xgb.train(dict(params, hist_method="prehot"),
                   xgb.DMatrix(X, label=y), rounds, verbose_eval=False)
    tb = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y),
                  rounds, verbose_eval=False)
    assert tb.gbm.tree_info == jb.gbm.tree_info
    assert tb.gbm.iteration_indptr == jb.gbm.iteration_indptr
    eta = params.get("eta", 0.3) / params.get("num_parallel_tree", 1)
    ind = jb.gbm.iteration_indptr
    full, drift = 0, 0.0
    for r in range(rounds):
        ties = []
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]],
                        tb.gbm.trees[ind[r]:ind[r + 1]]):
            t, d = compare_tree(a, b, eta, r=r)
            ties += t
            drift = max(drift, d)
        if ties:
            break
        full += 1
    print(f"{params}: {full} of {rounds} rounds equal in full end to end, "
          f"largest leaf drift {drift:.3e}")
    assert full >= full_min
    dj, dt = xgb.DMatrix(X), xt.DMatrix(X)
    if full:
        np.testing.assert_allclose(
            tb.predict(dt, iteration_range=(0, full)),
            jb.predict(dj, iteration_range=(0, full)), rtol=1e-5,
            atol=LEAF_ATOL)
    jmodel = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    clean = 0
    for r in range(rounds):
        margin = jmodel.predict(dt, output_margin=True, strict_shape=True,
                                iteration_range=(0, r)) if r else None
        one = xt.Booster(dict(params, device="cpu"))
        one.update(xt.DMatrix(X, label=y, base_margin=margin), r)
        ties = []
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]], one.gbm.trees):
            ties += compare_tree(a, b, eta, r=r)[0]
        clean += not ties
    print(f"round by round: {clean} of {rounds} rounds with no near tie")
    assert clean >= clean_min
    return jb, tb


# (params, rounds equal in full end to end, rounds with no near tie round
# by round), the last two as measured on the CPU
SAMPLED_CASES = [
    ({"subsample": 0.7}, 6, 6),
    ({"subsample": 0.5, "sampling_method": "gradient_based"}, 4, 6),
    ({"colsample_bytree": 0.6, "colsample_bylevel": 0.7,
      "colsample_bynode": 0.8}, 6, 6),
    ({"num_parallel_tree": 3, "subsample": 0.8, "colsample_bynode": 0.5},
     6, 6),
]


@pytest.mark.parametrize("extra,full_min,clean_min", SAMPLED_CASES)
def test_sampled_training_matches_jax(extra, full_min, clean_min,
                                      monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = _data()
    params = dict({"objective": "binary:logistic", "max_depth": 5,
                   "eta": 0.3, "base_score": 0.5}, **extra)
    check_against_jax(X, y, params, ROUNDS, full_min, clean_min)


def test_sampling_draws_the_same_on_every_call():
    """Two trainings of one configuration save the same bytes; another
    seed draws other rows (the port's ``seed`` reaches the stream)."""
    X, y = _data(n=2000)
    p = {"objective": "binary:logistic", "max_depth": 4, "subsample": 0.6,
         "colsample_bynode": 0.5, "device": "cpu"}
    raw = [bytes(xt.train(p, xt.DMatrix(X, label=y), 3,
                          verbose_eval=False).save_raw("ubj"))
           for _ in range(2)]
    assert raw[0] == raw[1]
    other = xt.train(dict(p, seed=7), xt.DMatrix(X, label=y), 3,
                     verbose_eval=False)
    assert other.gbm.to_json()["trees"] != xt.Booster(
        {"device": "cpu"}, model_file=raw[0]).gbm.to_json()["trees"]


def test_sampled_training_continues_from_a_model():
    """Round r draws from ``fold_in(key(seed), r)`` whoever trained the
    rounds before it: 3 rounds, saved and loaded (the seed travels in the
    model's parameters), then 2 more grow the trees of 5 straight
    rounds."""
    X, y = _data(n=2000, K=3)
    p = {"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
         "subsample": 0.7, "colsample_bynode": 0.6, "seed": 11,
         "device": "cpu"}
    five = xt.train(p, xt.DMatrix(X, label=y), 5, verbose_eval=False)
    three = xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)
    loaded = xt.Booster({"device": "cpu"}, model_file=three.save_raw("ubj"))
    assert loaded.ctx.seed == 11
    more = xt.train({"device": "cpu"}, xt.DMatrix(X, label=y), 2,
                    verbose_eval=False, xgb_model=loaded)
    assert more.num_boosted_rounds() == 5
    for a, b in zip(five.gbm.trees, more.gbm.trees):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)
