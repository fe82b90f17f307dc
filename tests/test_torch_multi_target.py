"""Multi-target data, objectives, metrics, the K-target histogram and
split search, vector-leaf model files, dumps and refusals: the port
against the JAX package on the CPU.

Integer results are held bit for bit (each target's quantised
histogram, split features, bins and directions); float results to the
stated tolerances (see ``tests/test_torch_train.py``). Whole models
trained both ways are in ``tests/test_torch_multi_target_train.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.data.binned import BinnedMatrix as JaxBinned
from xgboost_tpu.data.quantile import sketch_matrix as jax_sketch
from xgboost_tpu.metric import get_metric as jax_metric
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu.ops.histogram import (build_hist as jax_build_hist,
                                       build_hist_multi as jax_hist_multi)
from xgboost_tpu.ops.split import evaluate_splits_multi as jax_eval_multi
from xgboost_tpu.tree.param import TrainParam as JaxTrainParam
from xgboost_tpu_torch.metric import get_metric
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.ops.histogram import build_hist_multi
from xgboost_tpu_torch.ops import split as split_mod
from xgboost_tpu_torch.ops.split import evaluate_splits_multi
from xgboost_tpu_torch.ops.xla_order import (cumsum_in_xla_order,
                                             sum_in_xla_order)
from xgboost_tpu_torch.tree.multi import MultiTargetTreeModel
from xgboost_tpu_torch.tree.param import TrainParam

CPU = {"device": "cpu"}


def _data(n=1200, F=8, K=3, seed=3, binary=False, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    Y = X @ rng.randn(F, K) + 0.3 * rng.randn(n, K)
    Y = (Y > 0.5).astype(np.float32) if binary else Y.astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return X, Y


class _Info:
    def __init__(self, labels, weights=None):
        self.labels, self.weights = labels, weights


@pytest.fixture(scope="module")
def vector_model():
    """A JAX-trained vector-leaf model (depthwise, 3 targets) and its
    data."""
    X, Y = _data(n=600)
    jb = xgb.train({"objective": "reg:squarederror", "max_depth": 3,
                    "multi_strategy": "multi_output_tree",
                    "base_score": 0.25}, xgb.DMatrix(X, label=Y), 3,
                   verbose_eval=False)
    return jb, X, Y


# ---- data ----------------------------------------------------------------------

def test_label_matrix_through_dmatrix(tmp_path):
    """Labels [n, K] through DMatrix, set_label / get_label, slice and
    save_binary's npz both ways; a [n, 1] label stays [n]."""
    X, Y = _data(n=50)
    dm = xt.DMatrix(X, label=Y)
    np.testing.assert_array_equal(dm.get_label(), Y)
    np.testing.assert_array_equal(dm.get_float_info("label"), Y)
    assert xt.DMatrix(X, label=Y[:, :1]).get_label().shape == (50,)
    rows = np.asarray([3, 1, 4, 1, 5])
    np.testing.assert_array_equal(dm.slice(rows).get_label(), Y[rows])
    np.testing.assert_array_equal(
        dm.slice(rows).get_label(),
        xgb.DMatrix(X, label=Y).slice(rows).get_label())
    dm.set_label(2 * Y)
    np.testing.assert_array_equal(dm.get_label(), 2 * Y)
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    dm.save_binary(port_file)
    xgb.DMatrix(X, label=Y).save_binary(jax_file)
    np.testing.assert_array_equal(xgb.DMatrix(port_file).get_label(), 2 * Y)
    np.testing.assert_array_equal(xt.DMatrix(jax_file).get_label(), Y)
    with pytest.raises(ValueError, match="entries, expected 50"):
        xt.DMatrix(X, label=Y[:40])


@pytest.mark.parametrize("objective", ["reg:squarederror", "reg:logistic",
                                       "binary:logistic"])
def test_targets_and_intercepts(objective):
    """``n_targets`` from the label matrix, and one intercept a target,
    bit for bit: the gradient sums add in the JAX package's order
    (``ops/xla_order.py``), with weights and without, on labels whose
    partial sums are exact in f32 (0/1, a 1/64 grid) and on float
    labels, whose sums round."""
    rng = np.random.RandomState(0)
    n, K = 3000, 4
    grid = np.round(rng.rand(n, K) * 64) / 64
    exact = (grid > 0.6) if objective == "binary:logistic" else grid
    floats = (rng.rand(n, K) > 0.6) if objective == "binary:logistic" \
        else rng.rand(n, K)
    w = (1 + np.arange(n) % 3).astype(np.float32)
    for labels, weights in ((exact, None), (exact, w), (floats, None),
                            (floats, w)):
        labels = labels.astype(np.float32)
        info = _Info(labels, weights)
        jobj, tobj = jax_objective(objective), get_objective(objective)
        assert tobj.n_targets(info) == jobj.n_targets(info) == K
        want = np.asarray(jobj.init_estimation(info))
        got = tobj.init_estimation(
            torch.from_numpy(labels),
            None if weights is None else torch.from_numpy(weights))
        assert got.shape == want.shape == (K,)
        np.testing.assert_array_equal(got, want)
    assert get_objective(objective).n_targets(_Info(labels[:, 0])) == 1


@pytest.mark.parametrize("metric", ["rmse", "logloss", "mae", "mape",
                                    "rmsle"])
def test_weighted_metrics_over_targets(metric):
    """Rows weighted, targets averaged: the JAX package's metrics on a
    [n, K] prediction of weighted rows, to float64 rounding."""
    rng = np.random.RandomState(1)
    n, K = 500, 5
    labels = (rng.rand(n, K) > 0.5).astype(np.float32) \
        if metric == "logloss" else rng.rand(n, K).astype(np.float32)
    preds = np.clip(rng.rand(n, K), 0.01, 0.99).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    info = _Info(labels, w)
    want = jax_metric(metric)(preds, info)
    got = get_metric(metric)(preds, info)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a row's weight stands for each of its targets
    flat = _Info(labels.reshape(-1), np.repeat(w, K))
    np.testing.assert_allclose(got, get_metric(metric)(preds.reshape(-1),
                                                       flat), rtol=1e-12)


def test_error_metric_over_targets():
    """``error`` over a label matrix: the weighted share of wrong entries
    (the JAX package's ``error`` cannot broadcast a row weight over the
    targets; the port reads it as the other elementwise metrics do)."""
    rng = np.random.RandomState(2)
    labels = (rng.rand(300, 4) > 0.5).astype(np.float32)
    preds = rng.rand(300, 4).astype(np.float32)
    w = rng.rand(300).astype(np.float32)
    wrong = (preds > 0.5) != (labels > 0.5)
    w64 = w.astype(np.float64)
    want = float((wrong * w64[:, None]).sum() / (4 * w64.sum()))
    np.testing.assert_allclose(get_metric("error")(preds, _Info(labels, w)),
                               want, rtol=1e-12)


# ---- the K-target histogram and split search ------------------------------------

@pytest.mark.parametrize("N,B", [(1, 257), (4, 64), (32, 17)])
def test_hist_multi_each_target_bit_for_bit(N, B):
    """Each target's slice of the K-target build equals the JAX package's
    ``prehot`` build of that target's gradients alone, bit for bit: every
    target is quantised with its own scale (targets here differ in scale
    by 1,000x, so a shared scale would change all but the largest)."""
    rng = np.random.RandomState(N + B)
    n, F, K = 2500, 5, 3
    bins = rng.randint(0, B, (n, F)).astype(np.uint8 if B <= 256
                                            else np.uint16)
    g = rng.randn(n, K, 2).astype(np.float32) * np.asarray(
        [1.0, 1e-3, 30.0], np.float32)[None, :, None]
    g[..., 1] = np.abs(g[..., 1])
    rel = rng.randint(0, N + 1, n).astype(np.int32)     # N: inactive
    got = build_hist_multi(torch.from_numpy(bins), torch.from_numpy(g),
                           torch.from_numpy(rel), N, B).numpy()
    assert got.shape == (N, F, B, K, 2)
    for k in range(K):
        want = np.asarray(jax_build_hist(
            jnp.asarray(bins), jnp.asarray(g[:, k]), jnp.asarray(rel), N, B,
            method="prehot"))
        np.testing.assert_array_equal(got[:, :, :, k], want)
    np.testing.assert_array_equal(got, np.asarray(jax_hist_multi(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(rel), N, B,
        method="prehot")))


@pytest.mark.parametrize("n,length,dim", [
    ((3, 6), 3, 0), ((32, 5), 32, 0), ((33, 5), 33, 0), ((101, 40), 101, 0),
    ((2, 101, 9), 101, 1), ((1100, 4), 1100, 0), ((30993, 3, 2), 30993, 0)])
def test_sum_in_xla_order_equals_jnp_sum(n, length, dim):
    """``sum_in_xla_order`` gives ``jnp.sum``'s bits on the CPU: a left
    fold up to 32 terms, windows of 32 above (one and two levels)."""
    rng = np.random.RandomState(length)
    x = (rng.randn(*n) * 10.0 ** rng.randn(*n)).astype(np.float32)
    assert x.shape[dim] == length
    np.testing.assert_array_equal(
        sum_in_xla_order(torch.from_numpy(x), dim).numpy(),
        np.asarray(jnp.sum(jnp.asarray(x), axis=dim)))


@pytest.mark.parametrize("length", [1, 16, 17, 63, 256, 300, 5000])
def test_cumsum_in_xla_order_equals_jnp_cumsum(length):
    """``cumsum_in_xla_order`` gives ``jnp.cumsum``'s bits on the CPU: a
    left fold up to 16 terms, blocks of 16 above (one and two levels)."""
    rng = np.random.RandomState(length)
    x = (rng.randn(3, 2, length)
         * 10.0 ** rng.randn(3, 2, length)).astype(np.float32)
    np.testing.assert_array_equal(
        cumsum_in_xla_order(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=2)))


@pytest.mark.parametrize("has_missing,masked,node_chunks", [
    pytest.param(True, False, False, id="True-False"),
    pytest.param(True, True, False, id="True-True"),
    pytest.param(False, False, False, id="False-False"),
    pytest.param(True, True, True, id="True-True-node_chunks")])
def test_evaluate_splits_multi_same_histogram(has_missing, masked,
                                              node_chunks, monkeypatch):
    """Both packages search the same K-target histogram and give the same
    bits: feature, bin, default direction, the gain summed over the
    targets and the children's sums (the prefix sums and the sums over
    the targets add in the JAX package's order). With ``node_chunks``
    the port searches one node at a time, as a deep level's chunks do."""
    if node_chunks:
        monkeypatch.setattr(split_mod, "MULTI_SPLIT_CHUNK_BYTES", 1)
    X, _ = _data(n=3000, F=6, missing=0.05 if has_missing else 0.0)
    cuts = jax_sketch(X, 32)
    binned = JaxBinned.from_dense(X, cuts)
    assert binned.has_missing == has_missing
    rng = np.random.RandomState(4)
    N, K = 8, 4
    g = np.stack([rng.randn(len(X), K), rng.rand(len(X), K)],
                 -1).astype(np.float32)
    rel = rng.randint(0, N, len(X)).astype(np.int32)
    hist = np.array(jax_hist_multi(binned.bins, jnp.asarray(g),
                                   jnp.asarray(rel), N, binned.max_nbins,
                                   method="prehot"))
    parent = hist[:, 0].sum(axis=1)                         # [N, K, 2]
    n_real = cuts.n_real_bins()
    fmask = rng.rand(N, X.shape[1]) < 0.6 if masked else None
    jp = JaxTrainParam(min_child_weight=2.0, reg_lambda=1.5)
    tp = TrainParam(min_child_weight=2.0, reg_lambda=1.5)
    want = jax_eval_multi(jnp.asarray(hist), jnp.asarray(parent),
                          jnp.asarray(n_real), jp,
                          feature_mask=None if fmask is None
                          else jnp.asarray(fmask), has_missing=has_missing)
    got = evaluate_splits_multi(
        torch.from_numpy(hist), torch.from_numpy(parent),
        torch.from_numpy(n_real.astype(np.int64)), tp,
        has_missing=has_missing,
        feature_mask=None if fmask is None else torch.from_numpy(fmask))
    for f in ("feature", "bin", "default_left", "gain", "left_sum",
              "right_sum"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---- model files, prediction, dumps ---------------------------------------------

def test_jax_vector_model_loads_both_ways(vector_model, tmp_path):
    """A JAX-written vector-leaf model loads into the port from the
    native JSON (and saves back to the same bytes) and from the
    reference schema, and predicts the same [n, K] to rtol 1e-6; the
    port's files load into the JAX package."""
    jb, X, Y = vector_model
    want = jb.predict(xgb.DMatrix(X))
    assert want.shape == Y.shape
    raw = bytes(jb.save_raw("json"))
    tb = xt.Booster(CPU, model_file=raw)
    assert isinstance(tb.gbm.trees[0], MultiTargetTreeModel)
    assert tb.gbm.multi_strategy == "multi_output_tree" and tb.n_groups == 3
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)), want, rtol=1e-6,
                               atol=1e-7)
    assert json.loads(bytes(tb.save_raw("json"))) == json.loads(raw)
    back = xgb.Booster(model_file=bytes(tb.save_raw("ubj")))
    np.testing.assert_array_equal(back.predict(xgb.DMatrix(X)), want)

    ref = str(tmp_path / "ref.json")
    xgb.save_xgboost_model(jb, ref)
    tr = xt.load_xgboost_model(ref, device="cpu")
    np.testing.assert_allclose(tr.predict(xt.DMatrix(X)), want, rtol=1e-6,
                               atol=1e-7)
    mine = str(tmp_path / "mine.json")
    xt.save_xgboost_model(tr, mine)
    assert json.load(open(mine)) == json.load(open(ref))
    np.testing.assert_allclose(
        xgb.load_xgboost_model(mine).predict(xgb.DMatrix(X)), want,
        rtol=1e-6, atol=1e-7)


def test_reference_schema_keeps_target_zero_intercept():
    """The reference schema's ``base_score`` is a scalar: a model whose
    targets' intercepts differ keeps target 0's, with the JAX package's
    warning."""
    X, Y = _data(n=300)
    Y[:, 1] += 5.0
    tb = xt.train({"objective": "reg:squarederror", "max_depth": 2,
                   "multi_strategy": "multi_output_tree", **CPU},
                  xt.DMatrix(X, label=Y), 1)
    assert tb.base_margin_[1] > tb.base_margin_[0] + 4
    with pytest.warns(UserWarning, match="target 0's value"):
        ref = xt.interop.native_to_reference_json(tb)
    assert float(ref["learner"]["learner_model_param"]["base_score"]) == \
        pytest.approx(float(tb.base_margin_[0]), rel=1e-7)


def test_pred_leaf_and_dumps(vector_model):
    """``pred_leaf``, the text / JSON / dot dumps (a vector leaf as
    ``[a,b,c]``), ``trees_to_dataframe`` and the importances of a
    vector-leaf model equal the JAX package's."""
    jb, X, _ = vector_model
    tb = xt.Booster(CPU, model_file=bytes(jb.save_raw("json")))
    np.testing.assert_array_equal(
        tb.predict(xt.DMatrix(X), pred_leaf=True),
        jb.predict(xgb.DMatrix(X), pred_leaf=True))
    for fmt in ("text", "json", "dot"):
        assert tb.get_dump(with_stats=True, dump_format=fmt) == \
            jb.get_dump(with_stats=True, dump_format=fmt)
    assert "leaf=[" in tb.get_dump()[0]
    for kind in ("weight", "gain", "cover", "total_gain", "total_cover"):
        assert tb.get_score(importance_type=kind) == \
            jb.get_score(importance_type=kind)
    import pandas  # noqa: F401  (installed here, not on the card)
    a, b = tb.trees_to_dataframe(), jb.trees_to_dataframe()
    assert a.equals(b)


def test_served_vector_model_equals_predict(vector_model):
    """A vector-leaf model, which has no packed form, serves through its
    torch walk; the answers equal ``Booster.predict`` (a scalar forest
    still serves only through the packed walk)."""
    jb, X, _ = vector_model
    raw = bytes(jb.save_raw("json"))
    want = xt.Booster(CPU, model_file=raw).predict(xt.DMatrix(X[:40]))
    with xt.serve.Server(models={"m": raw}, device="cpu",
                         max_batch=16) as srv:
        got = srv.predict(X[:40])
        assert srv.registry.describe()[0]["n_trees"] == 3
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(xt.serve.PackError, match="no packed form"):
        xt.serve.PackedForest.from_booster(
            xt.Booster(CPU, model_file=raw))


# ---- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {"monotone_constraints": "(1,0,0,0,0,0,0,0)"},
    {"booster": "dart"},
    {"hist_method": "coarse"},
    {"hist_method": "scan"},
])
def test_refusals_match_jax(extra):
    """What vector-leaf training does not take, refused with the JAX
    package's error and text."""
    X, Y = _data(n=100)
    p = dict({"objective": "reg:squarederror", "max_depth": 2,
              "multi_strategy": "multi_output_tree"}, **extra)
    with pytest.raises(NotImplementedError) as je:
        xgb.train(p, xgb.DMatrix(X, label=Y), 1, verbose_eval=False)
    with pytest.raises(NotImplementedError) as te:
        xt.train(dict(p, **CPU), xt.DMatrix(X, label=Y), 1)
    assert str(te.value) == str(je.value)


def test_update_refuses_vector_leaves(vector_model):
    """``process_type="update"`` refuses a vector-leaf model, as the JAX
    package does."""
    jb, X, Y = vector_model
    p = {"objective": "reg:squarederror", "process_type": "update",
         "updater": "refresh", "multi_strategy": "multi_output_tree"}
    raw = bytes(jb.save_raw("json"))
    with pytest.raises(NotImplementedError) as je:
        xgb.train(p, xgb.DMatrix(X, label=Y), 1,
                  xgb_model=xgb.Booster(model_file=raw), verbose_eval=False)
    with pytest.raises(NotImplementedError) as te:
        xt.train(dict(p, **CPU), xt.DMatrix(X, label=Y), 1, xgb_model=raw)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown multi_strategy"):
        xt.train({"multi_strategy": "both", **CPU}, xt.DMatrix(X, label=Y),
                 1)


class _Batches(xt.DataIter):
    def __init__(self, X, Y, n_batches):
        super().__init__(None)
        self.parts = list(zip(np.array_split(X, n_batches),
                              np.array_split(Y, n_batches)))
        self.i = 0

    def next(self, input_data):
        if self.i == len(self.parts):
            return 0
        input_data(data=self.parts[self.i][0], label=self.parts[self.i][1])
        self.i += 1
        return 1

    def reset(self):
        self.i = 0


def test_label_matrix_from_an_iterator_walks_its_bins():
    """An iterator's label-matrix batches make one [n, K] label; an
    evaluation matrix that keeps only its bins (built with the training
    matrix's cuts) moves its margin cache by the vector-leaf walk over
    its bins (``margin_binned``), which gives ``predict``'s margins (the
    walk over each bin's value)."""
    X, Y = _data(n=1200)
    dm = xt.QuantileDMatrix(_Batches(X[:900], Y[:900], 3), max_bin=32)
    dv = xt.QuantileDMatrix(_Batches(X[900:], Y[900:], 2), max_bin=32,
                            ref=dm)
    np.testing.assert_array_equal(dm.get_label(), Y[:900])
    res = {}
    bst = xt.train({"objective": "reg:squarederror", "max_depth": 3,
                    "max_bin": 32, "multi_strategy": "multi_output_tree",
                    **CPU}, dm, 3, evals=[(dv, "valid")], evals_result=res)
    margin = bst.predict(dv, output_margin=True)
    assert margin.shape == (300, 3)
    cached = bst._caches[id(dv)]["margin"].numpy()
    np.testing.assert_allclose(cached, margin, rtol=1e-6, atol=1e-6)
    rmse = np.sqrt(np.mean((margin.astype(np.float64) - Y[900:]) ** 2))
    np.testing.assert_allclose(res["valid"]["rmse"][-1], rmse, atol=1e-6)
