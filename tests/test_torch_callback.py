"""Training callbacks and early stopping in the port against the JAX
package, on the CPU: ``train(early_stopping_rounds=)`` stops at the JAX
package's round with its ``best_iteration`` / ``best_score`` and the same
``evals_result``; ``EarlyStopping(save_best=True)`` keeps the same
rounds; a run resumed from a saved model picks its patience up from the
model's attributes and stops where the straight run stops;
``LearningRateScheduler`` grows the JAX package's trees; and the
remaining stock callbacks (``EvaluationMonitor``, ``AbortAtRound``,
``TrainingCheckPoint``) do what they say."""

import json
import os

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu.callback as jcb
import xgboost_tpu_torch as xt
import xgboost_tpu_torch.callback as tcb
from test_torch_train import compare_tree


def _data(K=1, n=4000, F=8, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if K == 1:
        y = (X @ rng.randn(F) + 2.0 * rng.randn(n) > 0).astype(np.float32)
    else:
        y = np.argmax(X @ rng.randn(F, K) + 1.5 * rng.randn(n, K),
                      axis=1).astype(np.float32)
    return X, y


def _both(params, X, y, rounds, **kw):
    """Train both packages on the same split (JAX with ``prehot``, the
    port with ``auto``: the same int8x2 sums) -> (jax booster, jax
    evals_result, port booster, port evals_result)."""
    n = int(0.8 * X.shape[0])
    out = []
    for pkg, extra in ((xgb, {"hist_method": "prehot"}),
                       (xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X[:n], label=y[:n])
        dte = pkg.DMatrix(X[n:], label=y[n:])
        res = {}
        cbs = kw.get("callbacks")
        b = pkg.train(dict(params, **extra), dtr, rounds,
                      evals=[(dtr, "train"), (dte, "test")],
                      evals_result=res, verbose_eval=False,
                      early_stopping_rounds=kw.get("early_stopping_rounds"),
                      callbacks=None if cbs is None else cbs[pkg is xt]())
        out += [b, res]
    return out


# configurations whose trees have no near tie (tests/test_torch_train.py)
# before the run stops, so that both packages see the same scores (a tie
# in a small deep node, where several features cut the same rows, would
# make the two runs' later rounds differ; see ROADMAP C)
CASES = [
    ({"objective": "binary:logistic", "max_depth": 3, "eta": 0.6,
      "min_child_weight": 2}, 1),
    ({"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
      "eta": 0.6, "min_child_weight": 5,
      "eval_metric": ["merror", "mlogloss"]}, 3),
    ({"objective": "multi:softmax", "num_class": 3, "max_depth": 4,
      "eta": 0.6, "min_child_weight": 5, "subsample": 0.8,
      "colsample_bynode": 0.7}, 3),
]


@pytest.mark.parametrize("params,K", CASES)
def test_early_stopping_stops_where_jax_stops(params, K, monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = _data(K)
    jb, jr, tb, tr = _both(params, X, y, 60, early_stopping_rounds=3)
    assert jb.num_boosted_rounds() < 60, "the run did not stop early"
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds()
    assert tb.best_iteration == jb.best_iteration
    assert tb.best_score == jb.best_score
    assert tb.attributes() == jb.attributes()
    assert tr == jr
    print(f"{params['objective']}: stopped after "
          f"{tb.num_boosted_rounds()} rounds, best {tb.best_iteration} "
          f"({tb.best_score})")


@pytest.mark.parametrize("rounds", [1, 10])
def test_early_stopping_without_evals_raises(rounds):
    X, y = _data(n=200)
    with pytest.raises(ValueError, match="at least 1 validation dataset"):
        xt.train({"objective": "binary:logistic", "device": "cpu"},
                 xt.DMatrix(X, label=y), rounds, early_stopping_rounds=3,
                 verbose_eval=False)


def test_save_best_keeps_the_same_rounds(monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = _data(3)
    params = CASES[1][0]
    mods = (jcb, tcb)
    jb, jr, tb, tr = _both(params, X, y, 60, callbacks=[
        lambda i=i: [mods[i].EarlyStopping(rounds=3, save_best=True)]
        for i in range(2)])
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() \
        == tb.best_iteration + 1 == jb.best_iteration + 1
    assert tb.gbm.iteration_indptr == jb.gbm.iteration_indptr
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)),
                               jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                               atol=1e-4)
    assert tr == jr
    # the slice saves and loads like any model
    again = xt.Booster({"device": "cpu"}, model_file=tb.save_raw("ubj"))
    np.testing.assert_array_equal(again.predict(xt.DMatrix(X)),
                                  tb.predict(xt.DMatrix(X)))


def test_booster_slicing_matches_jax():
    X, y = _data(3, n=1500)
    p = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 6,
                  verbose_eval=False)
    jb = xgb.Booster(model_file=tb.save_raw("json"))
    for sl in (slice(0, 3), slice(2, 5), slice(1, None, 2), slice(None, 4)):
        ts, js = tb[sl], jb[sl]
        assert ts.num_boosted_rounds() == js.num_boosted_rounds()
        assert ts.gbm.tree_info == js.gbm.tree_info
        np.testing.assert_allclose(ts.predict(xt.DMatrix(X)),
                                   js.predict(xgb.DMatrix(X)), rtol=1e-6,
                                   atol=1e-7)
    assert tb.num_boosted_rounds() == 6           # the booster itself
    with pytest.raises(TypeError):
        tb[2]


def test_slice_takes_its_own_seed():
    """A slice shares the booster's trees, not its random stream: a seed
    set on the slice leaves the booster's as it was."""
    X, y = _data(1, n=600)
    tb = xt.train({"objective": "binary:logistic", "max_depth": 2,
                   "seed": 3, "device": "cpu"}, xt.DMatrix(X, label=y), 4,
                  verbose_eval=False)
    part = tb[0:2]
    part.set_param({"seed": 11, "seed_per_iteration": True})
    assert (part.ctx.seed, part.ctx.seed_per_iteration) == (11, True)
    assert (tb.ctx.seed, tb.ctx.seed_per_iteration) == (3, False)
    assert tb.ctx.make_key(5) == xt.Booster(
        {"seed": 3, "device": "cpu"}).ctx.make_key(5)


def test_resumed_run_stops_where_the_straight_run_stops(tmp_path):
    X, y = _data(1)
    params = dict(CASES[0][0], device="cpu")
    n = 3200
    dtr = xt.DMatrix(X[:n], label=y[:n])
    dte = xt.DMatrix(X[n:], label=y[n:])
    evals = [(dte, "test")]
    straight = xt.train(params, dtr, 60, evals=evals, verbose_eval=False,
                        early_stopping_rounds=3)
    stop = straight.num_boosted_rounds()
    assert 4 < stop < 60
    # the first part stops by an abort two rounds before the end; its
    # checkpoints are written after EarlyStopping has marked the round
    # (``early_stopping_rounds=`` would append it after the checkpoint,
    # whose files would then carry the round before's attributes)
    path = str(tmp_path)
    with pytest.raises(RuntimeError, match="AbortAtRound"):
        xt.train(params, dtr, 60, evals=evals, verbose_eval=False,
                 callbacks=[tcb.AbortAtRound(stop - 2),
                            tcb.EarlyStopping(rounds=3),
                            tcb.TrainingCheckPoint(path, interval=1)])
    saved = sorted(os.listdir(path), key=lambda f: int(f[6:-5]))
    assert saved[-1] == f"model_{stop - 3}.json"
    first = xt.Booster({"device": "cpu"},
                       model_file=os.path.join(path, saved[-1]))
    assert first.num_boosted_rounds() == stop - 2
    assert first.attr("rounds_since_improvement") is not None
    resumed = xt.train(params, dtr, 60, evals=evals, verbose_eval=False,
                       early_stopping_rounds=3, xgb_model=first)
    assert resumed.num_boosted_rounds() == stop
    assert resumed.best_iteration == straight.best_iteration
    assert resumed.best_score == straight.best_score


def test_learning_rate_scheduler_grows_jax_trees(monkeypatch):
    """Each round grows at its scheduled rate, as the JAX package grows a
    round when each round is a new training call at that rate continuing
    from the saved model. (The JAX package's own ``LearningRateScheduler``
    keeps the first rate: its round program is cached on the
    ``TrainParam`` object that ``set_param`` changes in place; ROADMAP
    C.)"""
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    X, y = _data(3, n=2000)
    rates = [0.5, 0.4, 0.3, 0.2, 0.1]
    params = {"objective": "multi:softprob", "num_class": 3,
              "max_depth": 4}
    tb = xt.train(dict(params, device="cpu"), xt.DMatrix(X, label=y), 5,
                  verbose_eval=False,
                  callbacks=[tcb.LearningRateScheduler(rates)])
    assert tb.tree_param.eta == pytest.approx(0.1)
    raw = None
    for r, eta in enumerate(rates):
        # a loaded Booster: its set_param(eta) follows the load (a model
        # file given as xgb_model= brings its own saved rate)
        jb = xgb.train(dict(params, hist_method="prehot", eta=eta),
                       xgb.DMatrix(X, label=y), 1, verbose_eval=False,
                       xgb_model=None if raw is None
                       else xgb.Booster(model_file=raw))
        raw = jb.save_raw("json")
    ind = jb.gbm.iteration_indptr
    assert tb.gbm.iteration_indptr == ind
    for r, eta in enumerate(rates):
        for a, b in zip(jb.gbm.trees[ind[r]:ind[r + 1]],
                        tb.gbm.trees[ind[r]:ind[r + 1]]):
            assert not compare_tree(a, b, eta, r=r)[0]
    np.testing.assert_allclose(tb.predict(xt.DMatrix(X)),
                               jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                               atol=1e-4)


def test_evaluation_monitor_prints_every_period(capsys):
    X, y = _data(1, n=600)
    dm = xt.DMatrix(X, label=y)
    xt.train({"objective": "binary:logistic", "max_depth": 2,
              "device": "cpu"}, dm, 5, evals=[(dm, "train")],
              verbose_eval=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == ["[0]", "[2]", "[4]"]
    assert lines[0].startswith("[0]\ttrain-logloss:")


def test_checkpoint_keeps_the_newest(tmp_path):
    X, y = _data(1, n=600)
    dm = xt.DMatrix(X, label=y)
    xt.train({"objective": "binary:logistic", "max_depth": 2,
              "device": "cpu"}, dm, 7, verbose_eval=False,
             callbacks=[tcb.TrainingCheckPoint(str(tmp_path), interval=2,
                                               keep=2)])
    assert sorted(os.listdir(tmp_path)) == ["model_4.json", "model_6.json"]
    obj = json.loads((tmp_path / "model_6.json").read_bytes())
    assert obj["learner"]["gradient_booster"]["iteration_indptr"][-1] == 7
    with pytest.raises(ValueError, match="keep"):
        tcb.TrainingCheckPoint(str(tmp_path), keep=0)
    # pickled checkpoints hold the model (a Booster pickles as its bytes)
    import pickle

    pk = tmp_path / "pk"
    pk.mkdir()
    bst = xt.train({"objective": "binary:logistic", "max_depth": 2,
                    "device": "cpu"}, dm, 2, verbose_eval=False,
                   callbacks=[tcb.TrainingCheckPoint(str(pk), interval=1,
                                                     as_pickle=True)])
    again = pickle.loads((pk / "model_1.pkl").read_bytes())
    assert again.ctx.device == "cpu"
    np.testing.assert_array_equal(again.predict(dm), bst.predict(dm))
