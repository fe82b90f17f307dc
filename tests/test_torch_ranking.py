"""The port's ranking path against the JAX package, on the CPU.

Queries of uneven sizes (one of a single document), graded labels 0-4
(binary for ``rank:map``), scores from a seed:

- query groups on ``DMatrix``: ``group=``, ``qid=`` (sorted, else an
  error), ``set_group`` / ``set_info`` / ``get_group`` / ``get_uint_info``
  / ``set_uint_info``, and ``qid`` batches of a ``DataIter``, the same
  offsets as the JAX package's;
- the ``mean`` method's label buckets and sampled rivals bit for bit
  (k = 1 and 3, several chunks of queries);
- the LambdaRank gradients of ``rank:ndcg`` / ``rank:pairwise`` /
  ``rank:map`` under ``mean`` and ``topk``, biased and unbiased, against
  the JAX package's device functions over two rounds, within
  ``GRAD_RTOL`` of each value plus ``GRAD_ATOL`` of the largest |value|
  of its column (f32 ``exp2``, ``log2``, ``exp``, cumulative sums and the
  order of the sums differ), and the unbiased ti+ / tj- after two rounds
  to rtol 1e-6;
- three rounds of ``rank:ndcg`` training, tree by tree under the
  near-tie certificate (``tests/test_torch_train.py compare_tree``),
  predictions to rtol 1e-5 plus 1e-4;
- models the JAX package saved (an unbiased one with its ti+ / tj-, and
  in the reference schema) load into the port and predict the same, and
  back.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_train import LEAF_ATOL, compare_tree
from xgboost_tpu.data.dmatrix import MetaInfo as JaxInfo
from xgboost_tpu.interop import native_to_reference_json
from xgboost_tpu.objective import get_objective as jax_objective
from xgboost_tpu_torch.objective import get_objective
from xgboost_tpu_torch.objective.ranking import (draw_rivals,
                                                 ordered_scatter_sum)
from xgboost_tpu_torch.utils import random as xrandom

# gradients: rtol of each value plus an atol of its column's largest
# |value|. Measured: up to 8.1e-5 relative on values above 1e-6 (sums
# whose terms cancel), and past 1e-5 relative at most 2.9e-8 of the
# column's largest |value|
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-6
SIZES = [9, 31, 1, 17, 4, 40, 12, 23, 2, 35, 6, 28, 14, 3, 19, 25, 8, 11,
         37, 5]


def queries(seed, binary=False, sizes=SIZES):
    """(labels [n] f32, scores [n] f32, offsets [G + 1]) of ``sizes``
    queries: graded labels 0-4, most of them 0 and 1, or binary."""
    rng = np.random.RandomState(seed)
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(ptr[-1])
    p = (0.5, 0.5) if binary else (0.42, 0.33, 0.15, 0.07, 0.03)
    y = rng.choice(len(p), n, p=p).astype(np.float32)
    s = rng.randn(n).astype(np.float32)
    return y, s, ptr


def _jax_info(y, ptr, w=None):
    return JaxInfo(labels=y, weights=w, group_ptr=ptr)


def _port_grad(obj, s, y, ptr, w, it):
    return obj.get_gradient(torch.from_numpy(s)[:, None],
                            torch.from_numpy(y),
                            None if w is None else torch.from_numpy(w), it,
                            group_ptr=ptr).numpy()


def assert_grad_close(got, want):
    scale = np.abs(want).max(axis=0, keepdims=True)
    err = np.abs(got - want) - GRAD_RTOL * np.abs(want)
    assert (err <= GRAD_ATOL * scale).all(), float((err / scale).max())


# ---- query groups on DMatrix -----------------------------------------------

def test_dmatrix_query_groups_match_jax():
    y, _, ptr = queries(0)
    X = np.random.RandomState(1).randn(len(y), 3).astype(np.float32)
    qid = np.repeat(np.arange(len(SIZES)) * 3 + 7, SIZES)
    for kw in ({"group": SIZES}, {"qid": qid}):
        jd, td = xgb.DMatrix(X, label=y, **kw), xt.DMatrix(X, label=y, **kw)
        np.testing.assert_array_equal(td.info.group_ptr, jd.info.group_ptr)
        np.testing.assert_array_equal(td.get_group(), jd.get_group())
        got, want = td.get_uint_info("group_ptr"), \
            jd.get_uint_info("group_ptr")
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    td = xt.DMatrix(X, label=y)
    assert td.get_group().size == 0 and td.get_uint_info("group_ptr").size == 0
    td.set_group(SIZES)
    np.testing.assert_array_equal(td.info.group_ptr, ptr)
    td.set_info(group=SIZES[::-1])
    np.testing.assert_array_equal(td.get_group(), SIZES[::-1])
    td.set_uint_info("group_ptr", ptr)
    np.testing.assert_array_equal(td.get_group(), SIZES)
    # one weight a query is taken beside one a row
    td.set_info(weight=np.arange(len(SIZES), dtype=np.float32))
    np.testing.assert_array_equal(td.info.row_weights(),
                                  np.repeat(np.arange(len(SIZES)), SIZES))
    with pytest.raises(ValueError, match="qid must be sorted"):
        xgb.DMatrix(X, label=y, qid=qid[::-1])
    with pytest.raises(ValueError, match="qid must be sorted"):
        xt.DMatrix(X, label=y, qid=qid[::-1])
    with pytest.raises(ValueError, match="cover all"):
        xt.DMatrix(X, label=y, group=SIZES[:-1])
    with pytest.raises(ValueError, match="weight has 3 entries"):
        xt.DMatrix(X, label=y, group=SIZES, weight=[1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="unknown uint field"):
        td.get_uint_info("label")


def test_iterator_qid_batches_make_the_jax_offsets():
    y, _, ptr = queries(2)
    X = np.random.RandomState(3).randn(len(y), 4).astype(np.float32)
    qid = np.repeat(np.arange(len(SIZES)), SIZES)
    cut = [0, 100, 250, len(y)]

    def iterator(pkg):
        class It(pkg.DataIter):
            def __init__(self):
                super().__init__()
                self.i = 0

            def next(self, input_data):
                if self.i == 3:
                    return 0
                s = slice(cut[self.i], cut[self.i + 1])
                input_data(data=X[s], label=y[s], qid=qid[s])
                self.i += 1
                return 1

            def reset(self):
                self.i = 0
        return It()

    jd = xgb.QuantileDMatrix(iterator(xgb), max_bin=16)
    td = xt.QuantileDMatrix(iterator(xt), max_bin=16)
    np.testing.assert_array_equal(td.info.group_ptr, jd.info.group_ptr)
    np.testing.assert_array_equal(td.info.group_ptr, ptr)
    res = {}
    xt.train({"objective": "rank:ndcg", "device": "cpu", "max_bin": 16,
              "eval_metric": "ndcg@5"}, td, 2, evals=[(td, "train")],
             evals_result=res, verbose_eval=False)
    assert res["train"]["ndcg@5"][1] >= res["train"]["ndcg@5"][0]


# ---- the mean method's draws ------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_mean_rivals_equal_jax_bit_for_bit(k):
    """The label buckets of each query, and the rivals of every chunk of
    5 queries (the chunk fixes the stream: one key of ``split(key, Gp //
    chunk)`` a chunk), equal the JAX package's draws."""
    y, _, ptr = queries(4)
    jobj = jax_objective("rank:ndcg")
    jlay = jobj._mean_stats(jobj._device_layout(_jax_info(y, ptr)))
    tobj = get_objective("rank:ndcg")
    tlay = tobj._mean_stats(tobj._layout(torch.from_numpy(y), None, ptr))
    for name in ("y_order", "n_lefts", "n_geq"):
        np.testing.assert_array_equal(tlay[name].numpy(),
                                      np.asarray(jlay[name]))
    G, L, chunk = len(SIZES), max(SIZES), 5
    it = 6
    jkeys = jax.random.split(jax.random.fold_in(jax.random.key(0), it),
                             G // chunk)
    tkeys = xrandom.split(xrandom.fold_in(xrandom.key(0), it), G // chunk)
    sz = np.asarray(SIZES, np.int32)
    for c in range(G // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        yo, nl, ng = (np.asarray(jlay[n])[rows]
                      for n in ("y_order", "n_lefts", "n_geq"))
        # the JAX package's draw (objective/ranking.py:307-314)
        n_riv = nl + (sz[rows][:, None] - ng)
        u = (jax.random.uniform(jkeys[c], (chunk, L, k))
             * jnp.asarray(n_riv)[:, :, None].astype(jnp.float32)).astype(
                 jnp.int32)
        u = jnp.clip(u, 0, jnp.maximum(n_riv[:, :, None] - 1, 0))
        ridx = jnp.where(u < nl[:, :, None], u,
                         u - nl[:, :, None] + ng[:, :, None])
        want = jnp.take_along_axis(jnp.asarray(yo), ridx.reshape(
            chunk, L * k), axis=1).reshape(chunk, L, k)
        got, _ = draw_rivals(tkeys[c], tlay["n_lefts"][rows],
                             tlay["n_geq"][rows],
                             torch.from_numpy(sz[rows]).long(),
                             tlay["y_order"][rows], k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ordered_scatter_sum_adds_in_a_fixed_order():
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 50, 4000)
    vals = rng.randn(4000, 3).astype(np.float32)
    got = ordered_scatter_sum(torch.from_numpy(idx), torch.from_numpy(vals),
                              60).numpy()
    want = np.zeros((60, 3))
    np.add.at(want, idx, vals.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[50:] == 0).all()
    # each target's rows in their order: a sequential f32 sum
    for t in (0, 17, 49):
        acc = np.float32(0)
        for v in vals[idx == t, 0]:
            acc = np.float32(acc + v)
        assert got[t, 0] == acc


# ---- gradients against the JAX package's device functions -------------------

@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("method", ["mean", "topk"])
@pytest.mark.parametrize("objective", ["rank:ndcg", "rank:pairwise",
                                       "rank:map"])
def test_gradient_matches_jax(objective, method, unbiased, monkeypatch):
    monkeypatch.delenv("XTPU_RANK_HOST", raising=False)
    y, s0, ptr = queries(7, binary=objective == "rank:map")
    s1 = s0 + np.random.RandomState(8).randn(len(s0)).astype(np.float32)
    params = {"lambdarank_pair_method": method,
              "lambdarank_unbiased": str(unbiased).lower()}
    jobj, tobj = jax_objective(objective, dict(params)), \
        get_objective(objective, dict(params))
    info = _jax_info(y, ptr)
    for it, s in enumerate((s0, s1)):
        want = np.asarray(jobj.get_gradient(s, info, it))
        got = _port_grad(tobj, s, y, ptr, None, it)
        assert got.shape == want.shape == (len(y), 1, 2)
        assert_grad_close(got[:, 0], want[:, 0])
    if unbiased:
        assert len(tobj.ti_plus) == (32 if method == "mean" else max(SIZES))
        np.testing.assert_allclose(tobj.ti_plus, jobj._ti_plus, rtol=1e-6)
        np.testing.assert_allclose(tobj.tj_minus, jobj._tj_minus, rtol=1e-6)
        assert not np.allclose(tobj.ti_plus, 1.0)


@pytest.mark.parametrize("case", ["mean_k3_query_weights",
                                  "topk_cap_row_weights"])
def test_gradient_options_match_jax(case, monkeypatch):
    """``mean`` with three rivals a document and one weight a query;
    ``topk`` with a cap of 4 anchors (unbiased: 4 positions), one weight a
    row, linear gains."""
    monkeypatch.delenv("XTPU_RANK_HOST", raising=False)
    y, s, ptr = queries(9)
    rng = np.random.RandomState(10)
    if case == "mean_k3_query_weights":
        params = {"lambdarank_num_pair_per_sample": 3, "seed": 5}
        w = (rng.rand(len(SIZES)) + 0.5).astype(np.float32)
    else:
        params = {"lambdarank_pair_method": "topk", "ndcg_exp_gain": "false",
                  "lambdarank_num_pair_per_sample": 4,
                  "lambdarank_unbiased": "true"}
        w = (rng.rand(len(y)) + 0.5).astype(np.float32)
    jobj, tobj = jax_objective("rank:ndcg", dict(params)), \
        get_objective("rank:ndcg", dict(params))
    for it in range(2):
        want = np.asarray(jobj.get_gradient(s, _jax_info(y, ptr, w), it))
        got = _port_grad(tobj, s, y, ptr, w, it)
        assert_grad_close(got[:, 0], want[:, 0])
    if params.get("lambdarank_unbiased"):
        assert len(tobj.ti_plus) == 4
        np.testing.assert_allclose(tobj.ti_plus, jobj._ti_plus, rtol=1e-6)
        np.testing.assert_allclose(tobj.tj_minus, jobj._tj_minus, rtol=1e-6)


def test_gradient_refusals():
    y, s, ptr = queries(11)
    st, yt = torch.from_numpy(s)[:, None], torch.from_numpy(y)
    with pytest.raises(ValueError, match="binary relevance"):
        get_objective("rank:map").get_gradient(st, yt, group_ptr=ptr)
    with pytest.raises(ValueError, match="query group"):
        get_objective("rank:ndcg").get_gradient(st, yt)
    with pytest.raises(ValueError, match="lambdarank_pair_method"):
        get_objective("rank:ndcg", {"lambdarank_pair_method": "all"}
                      ).get_gradient(st, yt, group_ptr=ptr)
    X = np.zeros((len(y), 2), np.float32)
    with pytest.raises(ValueError, match="query group"):
        xt.train({"objective": "rank:ndcg", "device": "cpu"},
                 xt.DMatrix(X, label=y), 1)


# ---- training ----------------------------------------------------------------

RANK_PARAMS = {"objective": "rank:ndcg", "max_depth": 4, "eta": 0.3,
               "eval_metric": ["ndcg@10", "map@10"]}


def ranking_data(seed, n_queries=40):
    """[n, 8] features and labels 0-4 quantised within each query from a
    hidden linear score, queries of 5-40 documents."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 41, n_queries)
    n = int(sizes.sum())
    X = rng.randn(n, 8).astype(np.float32)
    score = X @ rng.randn(8) + 0.7 * rng.randn(n)
    y = np.zeros(n, np.float32)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    for a, b in zip(ptr[:-1], ptr[1:]):
        q = np.quantile(score[a:b], (0.45, 0.75, 0.9, 0.97))
        y[a:b] = np.searchsorted(q, score[a:b])
    return X, y, sizes


@pytest.fixture(scope="module")
def trained():
    X, y, sizes = ranking_data(12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        mp.delenv("XTPU_RANK_HOST", raising=False)
        jd = xgb.DMatrix(X, label=y, group=sizes)
        jres = {}
        jb = xgb.train(dict(RANK_PARAMS, hist_method="prehot"), jd, 3,
                       evals=[(jd, "train")], evals_result=jres,
                       verbose_eval=False)
        ub = xgb.train(dict(RANK_PARAMS, lambdarank_unbiased=True,
                            hist_method="prehot"), jd, 2, verbose_eval=False)
    td = xt.DMatrix(X, label=y, group=sizes)
    tres = {}
    tb = xt.train(dict(RANK_PARAMS, device="cpu"), td, 3,
                  evals=[(td, "train")], evals_result=tres,
                  verbose_eval=False)
    return X, y, sizes, jb, tb, jres, tres, ub


def test_ranking_training_matches_jax(trained):
    """Every tree node by node under the certificate (no near tie in
    these three rounds, as measured), predictions to rtol 1e-5 plus
    1e-4, and the eval lines to the same."""
    X, y, sizes, jb, tb, jres, tres, _ = trained
    assert len(tb.gbm.trees) == len(jb.gbm.trees) == 3
    for r, (a, b) in enumerate(zip(jb.gbm.trees, tb.gbm.trees)):
        assert compare_tree(a, b, RANK_PARAMS["eta"], r=r)[0] == []
    assert tb.base_margin_.tolist() == [0.0]
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)),
                               jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                               atol=LEAF_ATOL)
    for m in ("ndcg@10", "map@10"):
        np.testing.assert_allclose(tres["train"][m], jres["train"][m],
                                   rtol=1e-5, atol=1e-5)
    assert tres["train"]["ndcg@10"][-1] > tres["train"]["ndcg@10"][0]


def test_early_stopping_on_ndcg_maximises(trained):
    X, y, sizes = ranking_data(13, n_queries=30)
    half = int(sizes[:20].sum())
    dtr = xt.DMatrix(X[:half], label=y[:half], group=sizes[:20])
    dte = xt.DMatrix(X[half:], label=y[half:], group=sizes[20:])
    res = {}
    b = xt.train(dict(RANK_PARAMS, device="cpu", eval_metric="ndcg@10"),
                 dtr, 40, evals=[(dte, "test")], evals_result=res,
                 early_stopping_rounds=3, verbose_eval=False)
    hist = res["test"]["ndcg@10"]
    assert b.best_score == max(hist)
    assert b.best_iteration == int(np.argmax(hist))
    assert b.num_boosted_rounds() == b.best_iteration + 4


def test_jax_saved_ranking_models_load_and_predict(trained):
    """The unbiased model the JAX package saved: the port reads its ti+ /
    tj- and predicts the same, in the native schema and in the reference
    schema (ti+ / tj- under the reference's keys); the port's model loads
    back into the JAX package with the same state, and trains on."""
    X, y, sizes, _, _, _, _, ub = trained
    want = ub.predict(xgb.DMatrix(X))
    ref = native_to_reference_json(ub)
    assert ref["learner"]["objective"]["lambdarank_param"][
        "lambdarank_pair_method"] == "mean"
    # the reference's objective: every lambdarank_param field, ti+ / tj-
    ref["learner"]["objective"]["lambdarank_param"]["lambdarank_unbiased"] \
        = "1"
    ref["learner"]["objective"]["ti+"] = list(ub.obj._ti_plus)
    ref["learner"]["objective"]["tj-"] = list(ub.obj._tj_minus)
    for raw in (json.dumps(ref).encode(), bytes(ub.save_raw("json"))):
        port = xt.Booster({"device": "cpu"}, model_file=raw)
        assert port.obj.name == "rank:ndcg"
        assert str(port.obj.params["lambdarank_unbiased"]) in ("1", "True")
        np.testing.assert_array_equal(port.obj.ti_plus, ub.obj._ti_plus)
        np.testing.assert_array_equal(port.obj.tj_minus, ub.obj._tj_minus)
        np.testing.assert_allclose(port.predict(xt.DMatrix(X)), want,
                                   rtol=1e-6, atol=1e-6)
    back = xgb.Booster(model_file=port.save_raw("json"))
    np.testing.assert_array_equal(back.obj._ti_plus, ub.obj._ti_plus)
    np.testing.assert_allclose(back.predict(xgb.DMatrix(X)), want, rtol=1e-6,
                               atol=1e-6)
    more = xt.train({"device": "cpu"}, xt.DMatrix(X, label=y, group=sizes),
                    1, xgb_model=port)
    assert more.num_boosted_rounds() == 3
    assert not np.array_equal(more.obj.ti_plus, ub.obj._ti_plus)
