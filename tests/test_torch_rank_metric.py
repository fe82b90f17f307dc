"""The port's ranking metrics and AUC against the JAX package, on the CPU.

``ndcg@k``, ``ndcg@k-``, ``ndcg``, ``map@k``, ``map``, ``pre@k``,
``ams@0.15``, ``auc`` and ``aucpr`` on the same seeded labels and scores
(rounded so that ties occur) through the JAX package's metric classes
and the port's: binary without groups, with row weights, multiclass (one
class against the rest, weighted), and over query groups of uneven sizes
(one of a single document) with and without one weight a query. All are
float64 on the host in both packages and agree to rtol 1e-12.
"""

import numpy as np
import pytest

import xgboost_tpu_torch as xt
from xgboost_tpu.data.dmatrix import MetaInfo as JaxInfo
from xgboost_tpu.metric import get_metric as jax_metric
from xgboost_tpu_torch.data.dmatrix import MetaInfo
from xgboost_tpu_torch.metric import get_metric

RANK_METRICS = ["ndcg@5", "ndcg@5-", "ndcg", "map@5", "map", "pre@3",
                "ams@0.15", "auc", "aucpr"]
SIZES = [7, 1, 23, 4, 16, 30, 2, 11, 9, 19, 5, 26]


def _case(kind, seed=0):
    """(labels, predictions, row or query weights or None, offsets or
    None) of one case."""
    rng = np.random.RandomState(seed)
    ptr = None
    if kind.startswith("grouped"):
        ptr = np.concatenate([[0], np.cumsum(SIZES)]).astype(np.int64)
        n = int(ptr[-1])
        y = rng.choice(5, n, p=(0.4, 0.3, 0.15, 0.1, 0.05)).astype(np.float32)
    else:
        n = 500
        y = (rng.rand(n) < 0.35).astype(np.float32)
    if kind == "multiclass":
        y = rng.randint(0, 4, n).astype(np.float32)
        p = rng.dirichlet(np.ones(4), n).astype(np.float32)
        p = np.round(p * 20) / 20                   # ties
    else:
        p = np.round(rng.randn(n) * 4).astype(np.float32) / 4
    w = None
    if kind in ("weighted", "multiclass"):
        w = (rng.rand(n) + 0.25).astype(np.float32)
    elif kind == "grouped_query_weights":
        w = (rng.rand(len(SIZES)) + 0.25).astype(np.float32)
    return y, p, w, ptr


# multiclass scores go to the AUCs only (one class against the rest); the
# JAX package's ams cannot take one weight a query (its row weights
# index past them), the port's spreads them over the rows
CASES = [(name, kind) for name in RANK_METRICS
         for kind in ("binary", "weighted", "multiclass", "grouped",
                      "grouped_query_weights")
         if (kind != "multiclass" or name.startswith("auc"))
         and (name, kind) != ("ams@0.15", "grouped_query_weights")]


@pytest.mark.parametrize("name,kind", CASES)
def test_metric_matches_jax(name, kind):
    y, p, w, ptr = _case(kind)
    jinfo = JaxInfo(labels=y, weights=w, group_ptr=ptr)
    tinfo = MetaInfo(labels=y, weights=w, group_ptr=ptr)
    want = jax_metric(name)(p, jinfo)
    got = get_metric(name)(p, tinfo)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert get_metric(name).full_name == jax_metric(name).full_name == name


def test_ams_spreads_query_weights_over_rows():
    y, p, w, ptr = _case("grouped_query_weights")
    rows = np.repeat(w, np.diff(ptr))
    got = get_metric("ams@0.15")(p, MetaInfo(labels=y, weights=w,
                                             group_ptr=ptr))
    want = jax_metric("ams@0.15")(p, JaxInfo(labels=y, weights=rows,
                                             group_ptr=ptr))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_degenerate_inputs_match_jax():
    """One class only, every query without a relevant document, a zero
    weight sum: the same number (NaN where the JAX package gives NaN)."""
    y = np.zeros(40, np.float32)
    p = np.linspace(0, 1, 40).astype(np.float32)
    ptr = np.asarray([0, 10, 25, 40])
    for name in ("auc", "aucpr", "ndcg@3", "map", "pre@2", "ams@0.15"):
        for g in (None, ptr):
            want = jax_metric(name)(p, JaxInfo(labels=y, group_ptr=g))
            got = get_metric(name)(p, MetaInfo(labels=y, group_ptr=g))
            np.testing.assert_equal(got, want)


def test_eval_lines_use_the_port_metrics():
    """``train``'s eval lines over a grouped matrix: each metric as the
    metric class computes it on ``Booster.predict``; an unknown metric
    raises."""
    rng = np.random.RandomState(3)
    y, _, _, ptr = _case("grouped", seed=3)
    X = rng.randn(len(y), 5).astype(np.float32)
    dm = xt.DMatrix(X, label=y, group=SIZES)
    res = {}
    names = ["ndcg@5", "map@5", "pre@3", "auc", "aucpr"]
    b = xt.train({"objective": "rank:pairwise", "device": "cpu",
                  "max_depth": 3, "eval_metric": names}, dm, 2,
                 evals=[(dm, "train")], evals_result=res, verbose_eval=False)
    p = b.predict(dm)
    for n in names:
        assert res["train"][n][-1] == float(f"{get_metric(n)(p, dm.info):.6f}")
    assert get_metric("map").__class__ is \
        get_metric(xt.Booster({"device": "cpu"}, model_file=b.save_raw())
                   .obj.default_metric).__class__
    with pytest.raises(ValueError, match="unknown metric"):
        get_metric("ndcg-no-such")
