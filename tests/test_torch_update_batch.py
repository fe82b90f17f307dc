"""``Booster.update_batch`` in the port against the JAX package: the same
bool in every case the JAX package lists (its fused binding), and a
batch's model equal to the same rounds run through ``update`` and
through ``train`` bit for bit."""

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt

BASE = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
        "base_score": 0.5}


def _data(seed=0, n=300, F=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y, rng


def _labels(kind, X, y, rng):
    if kind == "multiclass":
        return np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    if kind == "matrix":
        return np.stack([y, 1.0 - y], axis=1)
    if kind == "regression":
        return (X[:, 0] + 0.1 * rng.randn(len(X))).astype(np.float32)
    if kind == "survival":
        return np.exp(X[:, 0]).astype(np.float32)
    return y


# (case, params over BASE, labels, qid): the JAX package's answer is read
# from it in the test, never written here
CASES = [
    ("binary", {}, "binary", False),
    ("multiclass", {"objective": "multi:softprob", "num_class": 3},
     "multiclass", False),
    ("label_matrix", {}, "matrix", False),
    ("monotone", {"monotone_constraints": "(1,0,0,0,0)"}, "binary", False),
    ("dart", {"booster": "dart", "rate_drop": 0.3}, "binary", False),
    ("lossguide", {"grow_policy": "lossguide", "max_leaves": 8}, "binary",
     False),
    ("max_leaves", {"max_leaves": 6}, "binary", False),
    ("parallel_trees", {"num_parallel_tree": 2, "subsample": 0.8},
     "binary", False),
    ("vector_leaf", {"multi_strategy": "multi_output_tree"}, "matrix",
     False),
    ("ranking", {"objective": "rank:ndcg"}, "binary", True),
    ("cox", {"objective": "survival:cox"}, "survival", False),
    ("absolute_error", {"objective": "reg:absoluteerror"}, "regression",
     False),
    ("approx", {"tree_method": "approx"}, "binary", False),
    ("exact", {"tree_method": "exact"}, "binary", False),
]


def _booster(pkg, params, X, y, qid):
    p = dict(BASE, **params)
    if pkg is xgb:
        p["hist_method"] = "prehot"
    else:
        p["device"] = "cpu"
    kw = {"qid": np.repeat(np.arange(len(X) // 20), 20)} if qid else {}
    return pkg.Booster(p), pkg.DMatrix(X, label=y, **kw)


@pytest.mark.parametrize("case,params,labels,qid", CASES,
                         ids=[c[0] for c in CASES])
def test_bool_matches_jax(case, params, labels, qid):
    X, y, rng = _data()
    y = _labels(labels, X, y, rng)
    got = {}
    for pkg in (xgb, xt):
        bst, dm = _booster(pkg, params, X, y, qid)
        got[pkg.__name__] = bst.update_batch(dm, [0, 1])
        # a batch ran two rounds, a refusal none
        assert bst.num_boosted_rounds() == (2 if got[pkg.__name__] else 0)
    assert got["xgboost_tpu_torch"] == got["xgboost_tpu"], case


def test_scan_classes_switch_matches_jax(monkeypatch):
    monkeypatch.setenv("XTPU_SCAN_CLASSES", "0")
    X, y, rng = _data()
    y = _labels("multiclass", X, y, rng)
    got = []
    for pkg in (xgb, xt):
        bst, dm = _booster(pkg, {"objective": "multi:softprob",
                                 "num_class": 3}, X, y, False)
        got.append(bst.update_batch(dm, [0, 1]))
    assert got == [False, False]


def test_continuation_and_update_process_refuse_as_jax():
    X, y, _ = _data()
    raws = {}
    for pkg in (xgb, xt):
        bst, dm = _booster(pkg, {}, X, y, False)
        for i in range(2):
            bst.update(dm, i)
        raws[pkg] = bytes(bst.save_raw("json"))
    for pkg in (xgb, xt):
        extra = {"hist_method": "prehot"} if pkg is xgb else {"device": "cpu"}
        # a loaded model: the cache has not walked its trees yet
        cont = pkg.Booster(dict(BASE, **extra), model_file=raws[xt])
        dm = pkg.DMatrix(X, label=y)
        assert cont.update_batch(dm, [2, 3]) is False
        cont.update(dm, 2)               # walks the loaded trees
        assert cont.update_batch(dm, [3, 4]) is True
        assert cont.num_boosted_rounds() == 5
        upd = pkg.Booster(dict(BASE, process_type="update",
                               updater="refresh", **extra),
                          model_file=raws[xt])
        assert upd.update_batch(dm, [0, 1]) is False


@pytest.mark.parametrize("case", ["binary", "multiclass", "label_matrix",
                                  "monotone"])
def test_batch_bytes_equal_sequential_updates(case):
    params, labels = next((p, lab) for c, p, lab, _ in CASES if c == case)
    X, y, rng = _data(seed=3)
    y = _labels(labels, X, y, rng)
    batched, dm = _booster(xt, params, X, y, False)
    assert batched.update_batch(dm, range(4))
    seq, dm2 = _booster(xt, params, X, y, False)
    for i in range(4):
        seq.update(dm2, i)
    assert bytes(batched.save_raw("ubj")) == bytes(seq.save_raw("ubj"))


@pytest.mark.parametrize("rounds", [5, 9])
def test_train_equals_one_batch(rounds):
    X, y, _ = _data(seed=4)
    p = dict(BASE, device="cpu")
    trained = xt.train(p, xt.DMatrix(X, label=y), rounds, verbose_eval=False)
    assert trained.num_boosted_rounds() == rounds
    batched, dm = _booster(xt, {}, X, y, False)
    assert batched.update_batch(dm, range(rounds))
    assert bytes(trained.save_raw("ubj")) == bytes(batched.save_raw("ubj"))


def test_divergence_in_a_batch_keeps_no_tree(monkeypatch):
    """The JAX package checks a batch once, after its last round, and
    commits none of its trees when one diverged; the port drops the
    batch's trees too."""
    monkeypatch.setenv("XTPU_NAN_POLICY", "raise")
    X, y, _ = _data(seed=6)
    bst, dm = _booster(xt, {}, X, y, False)
    assert bst.update_batch(dm, [0, 1])
    before = bytes(bst.save_raw("ubj"))
    grad = bst.obj.get_gradient

    def poisoned(preds, labels, weights=None, iteration=0, **kw):
        if iteration == 3:
            labels = labels.clone()
            labels[7] = float("nan")
        return grad(preds, labels, weights, iteration, **kw)

    bst.obj.get_gradient = poisoned
    with pytest.raises(xt.NumericalDivergence) as e:
        bst.update_batch(dm, [2, 3, 4])
    assert e.value.iteration == 3 and e.value.bad_rows == 1
    assert bst.num_boosted_rounds() == 2
    assert bytes(bst.save_raw("ubj")) == before
    bst.obj.get_gradient = grad
    assert bst.update_batch(dm, [2, 3])      # the cache was restored
    seq, dm2 = _booster(xt, {}, X, y, False)
    for i in range(4):
        seq.update(dm2, i)
    assert bytes(bst.save_raw("ubj")) == bytes(seq.save_raw("ubj"))
