"""The dart booster in the port against the JAX package, on the CPU:

- each round's drop set and every ``weight_drop`` equal to the JAX
  package's (``uniform`` / ``weighted``, ``tree`` / ``forest``,
  ``one_drop``, ``skip_drop``), and after continuing from a saved model;
- ``rate_drop=0`` with ``skip_drop=1`` grows gbtree's trees, byte for
  byte;
- the margin rolled forward from the ring of round deltas equal to a
  full re-walk of the weighted forest (rtol 1e-5), the ring's dropped
  sum to a walk of the dropped trees (rtol 1e-6);
- trained trees node by node under the near-tie certificate, and
  predictions;
- JAX-saved dart models predict the same in the port and back, and a
  reference-schema dart payload reads;
- the port's ``seed`` reaches the drop stream (upstream XGBoost's rule;
  the JAX package always draws from ``RandomState(0)``, ROADMAP C), and
  a slice keeps its trees' weights.
"""

import json
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_categorical import TYPES, covtype_codes, dmatrices
from test_torch_train import LEAF_ATOL, compare_tree
from xgboost_tpu.boosting.dart import Dart as JaxDart
from xgboost_tpu.interop import native_to_reference_json
from xgboost_tpu_torch.boosting.dart import Dart
from xgboost_tpu_torch.boosting.predict import margin_binned, stack_trees
from xgboost_tpu_torch.serve import Server

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CPU = {"device": "cpu"}
BINARY = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
          "booster": "dart"}


def _binary(n=1000, F=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


@pytest.fixture
def drops(monkeypatch):
    """Record every round's drop set of both packages' dart boosters:
    {"jax": [...], "port": [...]}."""
    logs = {"jax": [], "port": []}
    for name, cls in (("jax", JaxDart), ("port", Dart)):
        real = cls._select_drop

        def spy(self, real=real, log=logs[name]):
            out = real(self)
            log.append(list(out))
            return out

        monkeypatch.setattr(cls, "_select_drop", spy)
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    return logs


DROP_CASES = [
    {"rate_drop": 0.3},
    {"rate_drop": 0.3, "sample_type": "weighted", "normalize_type": "forest"},
    {"rate_drop": 0.0, "one_drop": 1},
    {"rate_drop": 0.2, "skip_drop": 0.5, "sample_type": "weighted"},
]


@pytest.mark.parametrize("extra", DROP_CASES)
def test_drops_and_weights_match_jax(extra, drops):
    X, y = _binary()
    p = dict(BINARY, **extra)
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=y), 8,
                   verbose_eval=False)
    tb = xt.train(dict(p, **CPU), xt.DMatrix(X, label=y), 8,
                  verbose_eval=False)
    assert len(drops["jax"]) == len(drops["port"]) == 8
    assert drops["port"] == drops["jax"]
    assert any(drops["port"])
    assert tb.gbm.weight_drop == jb.gbm.weight_drop
    assert len(set(tb.gbm.weight_drop)) > 1


def test_continuing_a_saved_model_draws_as_jax(drops):
    """A loaded dart model starts a new drop stream in both packages."""
    X, y = _binary(seed=1)
    p = dict(BINARY, rate_drop=0.4)
    out = {}
    for name, pkg, extra in (("jax", xgb, {"hist_method": "prehot"}),
                             ("port", xt, CPU)):
        dm = pkg.DMatrix(X, label=y)
        first = pkg.train(dict(p, **extra), dm, 3, verbose_eval=False)
        again = pkg.train(dict(p, **extra), dm, 3, verbose_eval=False,
                          xgb_model=bytes(first.save_raw("json")))
        out[name] = again.gbm.weight_drop
        assert again.num_boosted_rounds() == 6
    assert drops["port"] == drops["jax"]
    rng = np.random.RandomState(0)          # a new stream at the load
    want = []
    for n in (3, 4, 5):                     # trees before each round
        rng.rand()
        want.append([int(i) for i in np.nonzero(rng.rand(n) < 0.4)[0]])
    assert drops["port"][3:] == want
    assert out["port"] == out["jax"]


def test_seed_reaches_the_drop_stream(drops):
    """Upstream XGBoost's rule: the drops follow ``seed`` (the JAX package
    draws from RandomState(0) whatever the seed). Uniform drops of round
    r over its r trees: RandomState(seed).rand() for the skip test, then
    rand(r) < rate_drop."""
    X, y = _binary(seed=2)
    p = dict(BINARY, rate_drop=0.5, seed=5, **CPU)
    bst = xt.train(p, xt.DMatrix(X, label=y), 6, verbose_eval=False)
    rng = np.random.RandomState(5)
    want = [[]]
    for r in range(1, 6):
        rng.rand()
        want.append([int(i) for i in np.nonzero(rng.rand(r) < 0.5)[0]])
    assert drops["port"] == want
    again = xt.train(p, xt.DMatrix(X, label=y), 6, verbose_eval=False)
    assert bytes(again.save_raw()) == bytes(bst.save_raw())
    jb = xgb.train(dict(p, device="cpu", hist_method="prehot"),
                   xgb.DMatrix(X, label=y), 6, verbose_eval=False)
    assert drops["jax"] != want         # the JAX package keeps seed 0
    assert jb.gbm.weight_drop != bst.gbm.weight_drop


@pytest.mark.parametrize("skip", [1.0, 0.0])
def test_no_drop_grows_gbtree_trees(skip):
    X, y = _binary(seed=3)
    gb = xt.train(dict(BINARY, booster="gbtree", **CPU),
                  xt.DMatrix(X, label=y), 5, verbose_eval=False)
    dt = xt.train(dict(BINARY, rate_drop=0.0, skip_drop=skip, **CPU),
                  xt.DMatrix(X, label=y), 5, verbose_eval=False)
    a = json.loads(gb.save_raw("json"))["learner"]["gradient_booster"]
    b = json.loads(dt.save_raw("json"))["learner"]["gradient_booster"]
    assert (b.pop("name"), a.pop("name")) == ("dart", "gbtree")
    assert b.pop("weight_drop") == [1.0] * 5
    assert json.dumps(a) == json.dumps(b)


# ---- categorical multiclass dart ------------------------------------------------

DART = {"objective": "multi:softprob", "num_class": 7, "max_depth": 3,
        "eta": 0.3, "min_child_weight": 5, "booster": "dart",
        "rate_drop": 0.3, "skip_drop": 0.2}


@pytest.fixture(scope="module")
def covdart():
    """Both packages' dart models (5 rounds) on Covertype-like codes."""
    X, y = covtype_codes(2000, seed=5)
    jd, td = dmatrices(X, y)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTPU_BATCH_ROUNDS", "1")
        jb = xgb.train(dict(DART, hist_method="prehot"), jd, 5,
                       verbose_eval=False)
    tb = xt.train(dict(DART, **CPU), td, 5, verbose_eval=False)
    return X, y, jb, tb


def test_dart_training_matches_jax(covdart):
    """The same drops and weights; trees node by node (every round in
    full, as measured: no near tie) and the predictions."""
    X, _, jb, tb = covdart
    assert tb.gbm.weight_drop == jb.gbm.weight_drop
    ind = jb.gbm.iteration_indptr
    assert tb.gbm.iteration_indptr == ind
    full = 0
    for r in range(5):
        ties = []
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]],
                        tb.gbm.trees[ind[r]:ind[r + 1]]):
            ties += compare_tree(a, b, DART["eta"], r=r)[0]
        if ties:
            break
        full += 1
    print(f"dart: {full} of 5 rounds equal in full end to end")
    assert full == 5
    jd, td = dmatrices(X)
    np.testing.assert_allclose(
        tb.predict(td, iteration_range=(0, full)),
        jb.predict(jd, iteration_range=(0, full)), rtol=1e-5,
        atol=LEAF_ATOL)
    assert any(t.is_cat_split.any() for t in tb.gbm.trees)


def test_ring_margin_equals_a_full_rewalk(covdart, monkeypatch):
    """The training margin rolled forward each round (ring of round
    deltas) against the weighted forest walked over the bins; the ring's
    dropped sum against the dropped trees walked; and a run without the
    ring (``XTPU_DART_CACHE_BYTES=0``) draws the same drops."""
    X, y, _, tb = covdart
    td = xt.DMatrix(X, label=y, feature_types=TYPES,
                    enable_categorical=True)
    bst = xt.Booster(dict(DART, **CPU))
    for r in range(5):
        bst.update(td, r)
    st = bst._caches[id(td)]
    assert st["dart_deltas"]["n_rounds"] == 5
    binned = st["binned"]
    walked = st["base"] + bst.gbm.margin_delta_binned(
        binned, 0, len(bst.gbm.trees), torch.device("cpu"))
    np.testing.assert_allclose(st["margin"].numpy(), walked.numpy(),
                               rtol=1e-5, atol=1e-6)
    idx = [0, 3, 9, 15, 22, 30]
    ring = bst.gbm._cached_drop_sum(st, idx)
    w = bst.gbm.tree_weights()
    forest = stack_trees([bst.gbm.trees[i] for i in idx],
                         [bst.gbm.tree_info[i] for i in idx], 7,
                         torch.device("cpu"), w[idx])
    walk = margin_binned(forest, binned.bins, binned.missing_bin,
                         torch.zeros(7))
    np.testing.assert_allclose(ring.numpy(), walk.numpy(), rtol=1e-6,
                               atol=1e-7)
    monkeypatch.setenv("XTPU_DART_CACHE_BYTES", "0")
    plain = xt.Booster(dict(DART, **CPU))
    for r in range(5):
        plain.update(td, r)
    assert "dart_deltas" not in plain._caches[id(td)]
    assert plain.gbm.weight_drop == bst.gbm.weight_drop == \
        tb.gbm.weight_drop


def test_dart_models_predict_the_same_both_ways(covdart):
    """A JAX dart model loads into the port, predicts the same and saves
    the bytes it was read from; the port's loads into the JAX package;
    a ``Server`` of the port's model answers ``Booster.predict``'s
    bits."""
    X, _, jb, tb = covdart
    jd, td = dmatrices(X)
    raw = bytes(jb.save_raw("json"))
    port = xt.Booster(CPU, model_file=raw)
    assert isinstance(port.gbm, Dart)
    assert port.gbm.weight_drop == jb.gbm.weight_drop
    np.testing.assert_allclose(port.predict(td), jb.predict(jd), rtol=1e-6,
                               atol=1e-6)
    assert bytes(port.save_raw("json")) == raw
    back = xgb.Booster(model_file=tb.save_raw("ubj"))
    pt = tb.predict(td)
    np.testing.assert_allclose(back.predict(jd), pt, rtol=1e-6, atol=1e-6)
    with Server(models={"dart": bytes(tb.save_raw("json"))},
                device="cpu") as srv:
        for lo, n in ((0, 1), (5, 64), (100, 512)):
            assert np.array_equal(np.asarray(srv.predict(X[lo:lo + n])),
                                  pt[lo:lo + n])


def test_slices_keep_their_weights(covdart):
    """``bst[a:b]`` predicts as ``iteration_range=(a, b)``, weights
    included (upstream's ``Dart::Slice``; the JAX package's slice drops
    them, ROADMAP C)."""
    X, _, _, tb = covdart
    _, td = dmatrices(X)
    part = tb[1:4]
    assert isinstance(part.gbm, Dart)
    lo, hi = tb.gbm.iteration_indptr[1], tb.gbm.iteration_indptr[4]
    assert part.gbm.weight_drop == tb.gbm.weight_drop[lo:hi]
    np.testing.assert_array_equal(part.predict(td),
                                  tb.predict(td, iteration_range=(1, 4)))


def test_reference_dart_payloads_read(covdart):
    """The reference-schema fixture (weights 0.7 / 0.3) and the JAX
    package's reference export of a trained dart model."""
    port = xt.Booster(CPU, model_file=os.path.join(
        FIXDIR, "dart_squarederror.json"))
    X = np.asarray([[-1.0, 0.0], [1.0, 3.0]], np.float32)
    np.testing.assert_allclose(port.predict(xt.DMatrix(X)), [-0.55, 0.55],
                               atol=1e-6)
    assert port.gbm.weight_drop == [0.7, 0.3]
    Xc, _, jb, _ = covdart
    ref = native_to_reference_json(jb)
    assert ref["learner"]["gradient_booster"]["name"] == "dart"
    port = xt.Booster(CPU, model_file=json.dumps(ref).encode())
    jd, td = dmatrices(Xc)
    np.testing.assert_allclose(port.predict(td), jb.predict(jd), rtol=1e-6,
                               atol=1e-6)
