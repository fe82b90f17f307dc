"""Categorical features in the port against the JAX package, on the CPU
(``feature_types`` with ``"c"``, ``enable_categorical``):

- ``auto`` never takes the sorted build (K4) on categorical data, and
  ``coarse`` / ``fused`` / ``scan`` refuse it, as the JAX package's do
  (the repair of ROADMAP C's ``auto_selects_scan`` fault);
- cuts and bins bit for bit (``arange(n_cat)`` cuts: bin == code);
- ``evaluate_splits`` with a ``CatInfo`` on seeded histograms (one-hot
  and sorted partition, both missing directions, empty categories,
  equal ratios, more categories than ``max_cat_threshold``): equal
  feature / bin / default_left / is_cat / left-set words, gains to 1e-6
  of the node's scale;
- positions bit for bit at categorical splits;
- a 3,000 x 12 Covertype-like multiclass run (10 continuous features,
  codes of 4 and 40 categories) at depth 4: trees node by node under the
  near-tie certificate (``tests/test_torch_train.py compare_tree``),
  predictions to rtol 1e-5 plus 1e-4;
- unseen and out-of-range codes go where the JAX package sends them;
- saved models load both ways and predict the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import LEAF_ATOL, compare_tree
from xgboost_tpu.data.binned import BinnedMatrix as JaxBinned
from xgboost_tpu.data.quantile import sketch_matrix as jax_sketch
from xgboost_tpu.ops.partition import advance_positions_level
from xgboost_tpu.ops.partition import update_positions as jax_update
from xgboost_tpu.ops.split import CatInfo as JaxCatInfo
from xgboost_tpu.ops.split import evaluate_splits as jax_evaluate
from xgboost_tpu.tree.grow import auto_selects_coarse
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.data.binned import BinnedMatrix
from xgboost_tpu_torch.data.quantile import sketch_matrix
from xgboost_tpu_torch.ops import histogram as H
from xgboost_tpu_torch.ops.partition import (LevelSplits, advance_level,
                                             update_positions)
from xgboost_tpu_torch.ops.split import CatInfo, evaluate_splits
from xgboost_tpu_torch.tree.param import TrainParam

CPU = torch.device("cpu")
TYPES = ["q"] * 10 + ["c", "c"]
# covtype's 7 classes in their shares of its 581,012 rows
CLASS_SHARE = np.asarray([211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                          20_510]) / 581_012


def covtype_codes(n, seed, missing=0.02):
    """[n, 12] f32: 10 N(0, 1) columns, a wilderness area code (4
    categories, skewed) and a soil type code (40, Zipf-like), and labels
    of 7 classes in covtype's shares from a fixed rule plus noise; a
    ``missing`` share of every column NaN."""
    rng = np.random.RandomState(seed)
    cont = rng.randn(n, 10).astype(np.float32)
    area = rng.choice(4, n, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = 1.0 / np.arange(1, 41) ** 1.1
    soil = rng.choice(40, n, p=soil_p / soil_p.sum())
    score = (cont @ rng.randn(10) + rng.randn(4)[area]
             + 1.5 * rng.randn(40)[soil] + 0.5 * rng.randn(n))
    order = (1, 0, 6, 2, 5, 4, 3)            # class of each score band
    cuts = np.quantile(score, np.cumsum(CLASS_SHARE[list(order)])[:-1])
    y = np.asarray(order, np.float32)[np.searchsorted(cuts, score)]
    X = np.concatenate([cont, area[:, None], soil[:, None]], 1).astype(
        np.float32)
    X[rng.rand(n, 12) < missing] = np.nan
    return X, y


def dmatrices(X, y=None):
    """(JAX, port) matrices of ``X`` with :data:`TYPES`."""
    kw = dict(feature_types=TYPES, enable_categorical=True)
    return xgb.DMatrix(X, label=y, **kw), xt.DMatrix(X, label=y, **kw)


# ---- the repaired kernel choice ------------------------------------------------

def test_auto_never_takes_the_sorted_build_on_categorical_data():
    """``auto`` with a categorical feature: K2 up to 128 nodes within the
    int8x2 guard, K3 elsewhere, never K4; numeric data at the same sizes
    does take K4 where the JAX package promotes ``auto``."""
    for n in (1000, 1 << 16, 581_012, H.INT8X2_MAX_ROWS + 1):
        for B, miss in ((256, False), (257, True), (16, False)):
            for N in (1, 8, 128, 256, 512):
                got = H.resolve_hist_kernel("auto", n, N, B, miss,
                                            numeric=False)
                assert got != "scan"
                assert got == ("int8x2" if N <= 128 and H.int8x2_fits(n)
                               else "f32")
                assert not H.auto_selects_scan(n, B, miss, numeric=False)
                assert not auto_selects_coarse(n, B, miss, numeric=False,
                                               col_split=False,
                                               backend="tpu")
    assert H.resolve_hist_kernel("auto", 581_012, 128, 256, False) == "scan"
    assert auto_selects_coarse(581_012, 256, False, numeric=True,
                               col_split=False, backend="tpu")


def test_auto_on_categorical_training_builds_with_k2(monkeypatch):
    """At 70,000 rows of 256 bins, where numeric data takes the sorted
    build at every level, a categorical matrix's levels take K2."""
    seen = []
    real = H.resolve_hist_kernel

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(H, "resolve_hist_kernel", spy)
    X, y = covtype_codes(70_000, seed=8, missing=0.0)
    y = (y == 1).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 2, "device": "cpu"}
    for types, want in ((TYPES, {"int8x2"}), (None, {"scan"})):
        seen.clear()
        xt.train(p, xt.DMatrix(X, label=y, feature_types=types,
                               enable_categorical=True), 1)
        assert set(seen) == want


@pytest.mark.parametrize("method", ["coarse", "fused", "scan"])
def test_two_level_methods_refuse_categorical(method):
    X, y = covtype_codes(500, seed=1)
    jd, td = dmatrices(X, y)
    p = {"objective": "multi:softprob", "num_class": 7, "max_depth": 3,
         "hist_method": method}
    with pytest.raises(NotImplementedError, match="numeric"):
        xgb.train(p, jd, 1, verbose_eval=False)
    with pytest.raises(NotImplementedError, match="numeric"):
        xt.train(dict(p, device="cpu"), td, 1)


def test_categorical_matrices_need_enable_categorical():
    X, y = covtype_codes(100, seed=2)
    for pkg in (xgb, xt):
        with pytest.raises(ValueError, match="enable_categorical"):
            pkg.DMatrix(X, label=y, feature_types=TYPES)


# ---- cuts, bins, splits, positions ---------------------------------------------

@pytest.mark.parametrize("missing", [0.0, 0.05])
def test_cuts_and_bins_bit_for_bit(missing):
    X, _ = covtype_codes(3000, seed=4, missing=missing)
    cj = jax_sketch(X, 256, feature_types=TYPES)
    cp = sketch_matrix(X, 256, feature_types=TYPES)
    assert cp.to_json() == cj.to_json()
    assert cp.is_cat().tolist() == [False] * 10 + [True, True]
    assert cp.n_real_bins()[10:].tolist() == [4, 40]
    np.testing.assert_array_equal(cp.values[cp.ptrs[11]:cp.ptrs[12]],
                                  np.arange(40, dtype=np.float32))
    bj = JaxBinned.from_dense(X, cj)
    bp = BinnedMatrix.from_dense(X, cp, CPU)
    assert (bp.max_nbins, bp.has_missing) == (bj.max_nbins, bj.has_missing)
    got = bp.bins.numpy()
    np.testing.assert_array_equal(got, np.asarray(bj.bins))
    codes = X[:, 10:]
    present = ~np.isnan(codes)
    np.testing.assert_array_equal(got[:, 10:][present],
                                  codes[present].astype(got.dtype))


def _cat_hist(N, F, nb, has_missing, seed):
    """A seeded histogram [N, F, nb (+1), 2]: g ~ N(0, 1) a bin, h in
    (0, 2], both on a grid of 2^-8 as dequantised int8x2 sums are on a
    grid (so that every cumulative sum is exact in either order); features
    0-1 numeric, 2 one-hot (4 codes), 3-4 partition (40 and 100 codes,
    the last above ``max_cat_threshold``); some categories empty, and in
    feature 3 pairs of categories with equal (g, h)."""
    rng = np.random.RandomState(seed)
    B = nb + int(has_missing)
    hist = np.zeros((N, F, B, 2), np.float32)
    hist[..., 0] = rng.randn(N, F, B)
    hist[..., 1] = rng.rand(N, F, B) * 2 + 0.01
    hist = np.round(hist * 256) / 256
    n_real = np.asarray([nb, nb // 2, 4, 40, 100], np.int64)[:F]
    for f in range(F):
        hist[:, f, n_real[f]:nb] = 0.0
    empty = rng.rand(N, F, nb) < 0.15
    hist[:, 2:, :nb][empty[:, 2:]] = 0.0
    hist[:, 3, 20:30] = hist[:, 3, 10:20]         # equal ratios
    hist[:, 3, 5] = hist[:, 3, 6] = 0.0           # empty ties too
    if not has_missing:
        return hist, n_real
    hist[:, :, nb] = np.abs(hist[:, :, nb]) * 0.5  # the missing slot
    return hist, n_real


CAT_CASES = [  # (has_missing, min_child_weight, lambda, max_cat_threshold)
    (True, 1.0, 1.0, 64),
    (False, 1.0, 1.0, 64),
    (True, 0.1, 3.0, 8),
    (False, 5.0, 0.5, 64),
]


@pytest.mark.parametrize("has_missing,mcw,lam,thr", CAT_CASES)
def test_evaluate_splits_categorical_matches_jax(has_missing, mcw, lam, thr):
    N, F, nb = 64, 5, 128
    hist, n_real = _cat_hist(N, F, nb, has_missing, seed=int(mcw * 7 + lam))
    # each node's winner among a few features, so every kind wins somewhere
    rng = np.random.RandomState(9)
    fmask = rng.rand(N, F) < 0.5
    fmask[np.arange(N), rng.randint(0, F, N)] = True
    parent = hist.sum(axis=2)
    parent = parent[:, 0] + rng.rand(N, 2).astype(np.float32)
    is_cat = np.asarray([False, False, True, True, True])
    onehot = is_cat & (n_real <= 4)
    jp = JaxTrainParam(min_child_weight=mcw, reg_lambda=lam,
                       max_cat_threshold=thr)
    tp = TrainParam(min_child_weight=mcw, reg_lambda=lam,
                    max_cat_threshold=thr)
    want = jax_evaluate(jnp.asarray(hist), jnp.asarray(parent),
                        jnp.asarray(n_real.astype(np.int32)), jp,
                        feature_mask=jnp.asarray(fmask),
                        cat=JaxCatInfo(jnp.asarray(is_cat),
                                       jnp.asarray(onehot)),
                        has_missing=has_missing)
    got = evaluate_splits(torch.from_numpy(hist), torch.from_numpy(parent),
                          torch.from_numpy(n_real), tp,
                          has_missing=has_missing,
                          feature_mask=torch.from_numpy(fmask),
                          cat=CatInfo(torch.from_numpy(is_cat),
                                      torch.from_numpy(onehot)))
    for field in ("feature", "bin", "default_left", "is_cat"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    words = np.asarray(want.cat_words)
    assert got.cat_words.shape == words.shape == (N, (nb - 1) // 32 + 1)
    np.testing.assert_array_equal(got.cat_words.numpy(),
                                  words.astype(np.int64))
    # every categorical feature wins a node (one-hot's one category holds
    # too little hessian for min_child_weight 5)
    chosen = got.feature.numpy()[got.is_cat.numpy()]
    assert set(chosen.tolist()) == ({2, 3, 4} if mcw <= 1 else {3, 4})
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.left_sum.numpy(),
                                  np.asarray(want.left_sum))


def test_positions_bit_for_bit_at_categorical_splits():
    rng = np.random.RandomState(6)
    n, F, B, depth = 5000, 5, 41, 3
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)   # B - 1: missing
    max_nodes = 2 ** (depth + 2) - 1
    lo, n_level = 2 ** depth - 1, 2 ** depth
    positions = rng.randint(lo, lo + n_level, n).astype(np.int32)
    positions[::9] = rng.randint(0, lo, len(positions[::9]))
    sf = rng.randint(0, F, max_nodes).astype(np.int32)
    sb = rng.randint(0, B - 1, max_nodes).astype(np.int32)
    dl = rng.rand(max_nodes) < 0.5
    is_split = np.zeros(max_nodes, bool)
    is_split[lo:lo + n_level] = rng.rand(n_level) < 0.8
    is_cat = rng.rand(max_nodes) < 0.6
    words = rng.randint(0, 2 ** 32, (max_nodes, 2), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax_update(
        jnp.asarray(bins), jnp.asarray(positions), jnp.asarray(sf),
        jnp.asarray(sb), jnp.asarray(dl), jnp.asarray(is_split), B - 1,
        is_cat_split=jnp.asarray(is_cat), cat_words=jnp.asarray(words)))
    got = update_positions(
        torch.from_numpy(bins), torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(sf.astype(np.int64)),
        torch.from_numpy(sb.astype(np.int64)), torch.from_numpy(dl),
        torch.from_numpy(is_split), B - 1, torch.from_numpy(is_cat),
        torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # the level payload form (the TPU's matmul advance) agrees too
    rel = np.where((positions >= lo) & (positions < lo + n_level),
                   positions - lo, n_level).astype(np.int32)
    cs = is_split[lo:lo + n_level]
    feat = np.where(cs, sf[lo:lo + n_level], -1).astype(np.int64)
    thr = np.where(cs, sb[lo:lo + n_level], 0).astype(np.int64)
    dleft = cs & dl[lo:lo + n_level]
    dense = np.asarray(advance_positions_level(
        jnp.asarray(bins.astype(np.float32)), jnp.asarray(positions),
        jnp.asarray(rel), jnp.asarray(feat.astype(np.int32)),
        jnp.asarray(thr.astype(np.int32)), jnp.asarray(dleft),
        jnp.asarray(cs), B - 1, is_cat=jnp.asarray(is_cat[lo:lo + n_level]),
        cat_words=jnp.asarray(words[lo:lo + n_level])))
    splits = LevelSplits(
        lo, torch.from_numpy(feat), torch.from_numpy(thr),
        torch.from_numpy(dleft), torch.from_numpy(cs.copy()),
        torch.from_numpy(is_cat[lo:lo + n_level].copy()),
        torch.from_numpy(words[lo:lo + n_level].astype(np.int64)))
    adv = advance_level(torch.from_numpy(bins),
                        torch.from_numpy(positions.astype(np.int64)),
                        splits, B - 1).numpy()
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(adv, want)
    numeric = update_positions(
        torch.from_numpy(bins), torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(sf.astype(np.int64)),
        torch.from_numpy(sb.astype(np.int64)), torch.from_numpy(dl),
        torch.from_numpy(is_split), B - 1).numpy()
    assert (numeric != got).any()


# ---- the whole slice -------------------------------------------------------------

# min_child_weight 5 keeps the deepest nodes above a few rows, where
# features that cut a node's rows alike tie to rounding (ROADMAP C)
PARAMS = {"objective": "multi:softprob", "num_class": 7, "max_depth": 4,
          "eta": 0.3, "min_child_weight": 5}


def compare_rounds(jb, tb, eta, rounds):
    """Trees round by round until the first near tie; returns the rounds
    equal in full."""
    ind = jb.gbm.iteration_indptr
    assert tb.gbm.iteration_indptr == ind
    assert tb.gbm.tree_info == jb.gbm.tree_info
    for r in range(rounds):
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]],
                        tb.gbm.trees[ind[r]:ind[r + 1]]):
            if compare_tree(a, b, eta, r=r)[0]:
                return r
    return rounds


@pytest.fixture(scope="module")
def covtype():
    """Both packages' categorical multiclass models (4 rounds), the data
    and the JAX model's predictions."""
    X, y = covtype_codes(3000, seed=0)
    jd, td = dmatrices(X, y)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        jb = xgb.train(dict(PARAMS, hist_method="prehot"), jd, 4,
                       verbose_eval=False)
    tb = xt.train(dict(PARAMS, device="cpu"), td, 4, verbose_eval=False)
    return X, y, jb, tb, jb.predict(dmatrices(X)[0])


def test_categorical_training_matches_jax(covtype):
    """End to end: every node of every tree up to the first near tie
    under the certificate. Round by round (the port grows round r from
    the JAX model's margin before it, its key included): at least 3 of 4
    rounds with no near tie, as measured (round 0 has two, where a soil
    partition and numeric cuts of a small node tie to 2e-7), and in each
    such round the margin equal to the JAX model's to rtol 1e-5 plus
    1e-4. Both split kinds appear in the port's trees."""
    X, y, jb, tb, _ = covtype
    compare_rounds(jb, tb, PARAMS["eta"], 4)
    jd, td = dmatrices(X)
    jmodel = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    clean = 0
    ind = jb.gbm.iteration_indptr
    for r in range(4):
        margin = jmodel.predict(td, output_margin=True, strict_shape=True,
                                iteration_range=(0, r)) if r else None
        one = xt.Booster(dict(PARAMS, device="cpu"))
        dm = xt.DMatrix(X, label=y, base_margin=margin, feature_types=TYPES,
                        enable_categorical=True)
        one.update(dm, r)
        ties = []
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]], one.gbm.trees):
            ties += compare_tree(a, b, PARAMS["eta"], r=r)[0]
        if not ties:
            clean += 1
            np.testing.assert_allclose(
                one.predict(dm, output_margin=True),
                jmodel.predict(td, output_margin=True,
                               iteration_range=(0, r + 1)),
                rtol=1e-5, atol=LEAF_ATOL)
    assert clean >= 3
    kinds = set()
    for t in tb.gbm.trees:
        for i in np.nonzero(t.is_cat_split)[0]:
            kinds.add("one-hot" if t.split_feature[i] == 10 else "partition")
            bits = sum(bin(int(w)).count("1") for w in t.cat_words[i])
            if t.split_feature[i] == 11:
                assert 1 <= bits <= 39
    assert kinds == {"one-hot", "partition"}


def test_unseen_categories_go_where_jax_sends_them(covtype):
    """Codes past the training categories (inside the left-set words and
    beyond them), negative and fractional codes, NaN. A fresh tree keeps
    its left sets at the training width in both packages (8 words over
    255 bins) and a reloaded one at ``max_cat // 32 + 1`` (ROADMAP C's
    first pinned difference), so codes from 64 on route apart fresh and
    reloaded in both packages alike; each package's saved model predicts
    the same in the other."""
    X, _, jb, tb, _ = covtype
    assert {t.cat_words.shape[1] for t in tb.gbm.trees} == \
        {t.cat_words.shape[1] for t in jb.gbm.trees} == {8}
    Xu = X[:400].copy()
    rng = np.random.RandomState(7)
    Xu[:, 10] = rng.choice([0, 3, 4, 5, 31, 32, 64, 1e6, -1, 2.5, np.nan],
                           400)
    Xu[:, 11] = rng.choice([0, 39, 40, 41, 63, 64, 65, 1e9, -3, np.nan], 400)
    jd, td = dmatrices(Xu)
    for raw in (jb.save_raw("json"), tb.save_raw("json")):
        port = xt.Booster({"device": "cpu"}, model_file=raw)
        np.testing.assert_allclose(port.predict(td),
                                   xgb.Booster(model_file=raw).predict(jd),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ["json", "ubj"])
def test_saved_models_load_both_ways(covtype, fmt, tmp_path):
    """A port model loads into the JAX package (its feature types too)
    and predicts the same; a JAX model loads into the port, predicts the
    same and saves the bytes it was read from; a file round trip
    predicts the same bits."""
    X, _, jb, tb, pj = covtype
    jd, td = dmatrices(X)
    pt = tb.predict(td)
    back = xgb.Booster(model_file=bytearray(tb.save_raw(fmt)))
    assert back.feature_types == TYPES
    np.testing.assert_allclose(back.predict(jd), pt, rtol=1e-6, atol=1e-6)
    jraw = bytes(jb.save_raw(fmt))
    port = xt.Booster({"device": "cpu"}, model_file=jraw)
    np.testing.assert_allclose(port.predict(td), pj, rtol=1e-6, atol=1e-6)
    assert bytes(port.save_raw(fmt)) == jraw
    path = str(tmp_path / f"m.{fmt}")
    tb.save_model(path)
    again = xt.Booster({"device": "cpu"}, model_file=path)
    assert np.array_equal(again.predict(td), pt)


def test_root_sum_gap_is_certified_at_min_child_weight_1(monkeypatch):
    """ROADMAP C's input for the root's f32 sum: at ``min_child_weight`` 1
    the node three right turns below the root of round 0's class-4 tree
    (heap node 14, a cover of ~2.4) splits alike in both packages, with
    gains 4e-4 apart, twice ``GAIN_RTOL`` of its scale: the two root
    sums differ by ~6e-4 in H and the node, its sums its parents' less
    the left children's, carries the whole of it. ``compare_tree``
    certifies the tree with that gap taken through the gain formula."""
    from test_torch_train import GAIN_RTOL, _parent_term, root_carry, \
        root_gap

    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = covtype_codes(3000, seed=0)
    jd, td = dmatrices(X, y)
    params = dict(PARAMS, min_child_weight=1)
    jb = xgb.train(dict(params, hist_method="prehot"), jd, 1,
                   verbose_eval=False)
    tb = xt.train(dict(params, device="cpu"), td, 1, verbose_eval=False)
    a, b = jb.gbm.trees[4], tb.gbm.trees[4]
    gap = root_gap(a, b, PARAMS["eta"])
    assert gap[1] > 1e-4                        # the two f32 root sums
    i = j = 0
    for _ in range(3):                          # heap nodes 2, 6, 14
        i, j = a.right_child[i], b.right_child[j]
    assert (a.split_feature[i], a.split_bin[i]) == \
        (b.split_feature[j], b.split_bin[j])
    scale = _parent_term(a, i, PARAMS["eta"], 1.0) + abs(float(a.gain[i]))
    diff = abs(float(a.gain[i]) - float(b.gain[j]))
    assert diff > GAIN_RTOL * scale             # the fault's field
    assert diff <= GAIN_RTOL * scale + root_carry(a, i, PARAMS["eta"], 1.0,
                                                  gap)
    assert compare_tree(a, b, PARAMS["eta"])[0] == []
