"""Training snapshots and auto-resume in the port, on the CPU.

The port's ``utils/checkpoint.py`` writes the JAX package's snapshot
format (UBJSON with a CRC32 sidecar, written atomically), and
``train(checkpoint=)`` resumes from the newest valid snapshot of the same
data. Held here (the JAX package's ``tests/test_checkpoint.py`` cases):

- a run killed at a round and resumed saves the straight run's model
  bytes: resident, row- and column-sampled; paged (external memory);
  dart (its drop stream and its ring of round deltas); gblinear;
  lossguide; and on a matrix that grew by ``append``;
- the newest snapshot truncated: the resume falls back to the one
  before and still ends at the straight run's bytes; a snapshot of other
  data is not resumed;
- early stopping's patience and ``evals_result`` across a resume;
- snapshot files that one package writes and the other loads, field by
  field, and the fingerprint equal to the JAX package's;
- the background writer, ``keep`` pruning and the CLI's checkpoint
  keys.
"""

import os

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.utils import checkpoint as jck
from xgboost_tpu_torch.utils import checkpoint as tck

from test_torch_paged import PortIter, _set

PARAMS = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
          "device": "cpu"}
SAMPLED = dict(PARAMS, subsample=0.7, colsample_bytree=0.8,
               colsample_bynode=0.8, seed=5)


def _data(n=2000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X @ rng.randn(f) + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


class DieAtRound(xt.callback.TrainingCallback):
    def __init__(self, round_):
        self.round_ = round_

    def after_iteration(self, model, epoch, evals_log):
        if epoch == self.round_:
            raise RuntimeError("injected crash")
        return False


def _crash_and_resume(params, make_dm, ckdir, n_rounds=10, die_at=5,
                      every=2, **kw):
    straight = xt.train(params, make_dm(), n_rounds, verbose_eval=False,
                        **kw)
    ck = xt.CheckpointConfig(directory=ckdir, every_n_rounds=every)
    with pytest.raises(RuntimeError, match="injected crash"):
        xt.train(params, make_dm(), n_rounds, checkpoint=ck,
                 callbacks=[DieAtRound(die_at)], verbose_eval=False, **kw)
    resumed = xt.train(params, make_dm(), n_rounds, checkpoint=ck,
                       verbose_eval=False, **kw)
    assert resumed.num_boosted_rounds() == n_rounds
    return straight, resumed


RESUME_CASES = {
    "resident": SAMPLED,
    "multiclass": dict(SAMPLED, objective="multi:softprob", num_class=3),
    "dart": dict(PARAMS, booster="dart", rate_drop=0.3, one_drop=True,
                 seed=3),
    "gblinear": {"booster": "gblinear", "objective": "binary:logistic",
                 "device": "cpu"},
    "lossguide": dict(SAMPLED, grow_policy="lossguide", max_leaves=8,
                      max_depth=0),
}


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resume_bitexact_resident(name, tmp_path):
    X, y = _data(seed=1)
    if name == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(np.float32)
    straight, resumed = _crash_and_resume(
        RESUME_CASES[name], lambda: xt.DMatrix(X, label=y), str(tmp_path))
    assert bytes(straight.save_raw("ubj")) == bytes(resumed.save_raw("ubj"))


@pytest.mark.parametrize("extra", [{}, {"booster": "dart", "rate_drop": 0.3},
                                   {"hist_method": "fused"}])
def test_resume_bitexact_paged(extra, tmp_path, monkeypatch):
    """Every page uploaded each pass (a budget of 0); each segment builds
    its matrix from the iterator anew."""
    _set(monkeypatch, XTPU_PAGE_ROWS=400, XTPU_PAGE_CACHE_BYTES=0)
    X, y = _data(seed=2)
    tags = iter(range(10))

    def make_dm():
        return xt.QuantileDMatrix(PortIter(X, y, 3, cache_prefix=str(
            tmp_path / f"p{next(tags)}")), max_bin=32)

    params = dict(SAMPLED, max_bin=32, **extra)
    straight, resumed = _crash_and_resume(params, make_dm,
                                          str(tmp_path / "ck"), n_rounds=8,
                                          die_at=4)
    assert bytes(straight.save_raw("ubj")) == bytes(resumed.save_raw("ubj"))


def test_resume_after_append(tmp_path):
    """A matrix that grew by ``append``: its snapshots carry the append
    chain, so the resumed run is the straight run on the grown matrix,
    and the un-grown matrix does not resume from them."""
    X, y = _data(seed=3)
    Xa, ya = _data(n=300, seed=4)

    def grown():
        dm = xt.DMatrix(X, label=y)
        dm.append(Xa, label=ya)
        return dm

    straight, resumed = _crash_and_resume(SAMPLED, grown, str(tmp_path))
    assert bytes(straight.save_raw("ubj")) == bytes(resumed.save_raw("ubj"))
    fresh = xt.train(SAMPLED, xt.DMatrix(X, label=y), 4, verbose_eval=False,
                     checkpoint=xt.CheckpointConfig(str(tmp_path),
                                                    every_n_rounds=2))
    assert fresh.num_boosted_rounds() == 4


def test_resume_skips_corrupt_newest_snapshot(tmp_path):
    X, y = _data(seed=5)

    def dmf():
        return xt.DMatrix(X, label=y)

    straight = xt.train(SAMPLED, dmf(), 12, verbose_eval=False)
    ck = xt.CheckpointConfig(directory=str(tmp_path), every_n_rounds=3)
    with pytest.raises(RuntimeError):
        xt.train(SAMPLED, dmf(), 12, checkpoint=ck,
                 callbacks=[DieAtRound(7)], verbose_eval=False)
    newest = tck.list_snapshots(str(tmp_path))[0][1]
    with open(newest, "r+b") as fh:
        fh.truncate(os.path.getsize(newest) // 2)
    with pytest.raises(tck.SnapshotCorrupt):
        tck.load_snapshot(newest)
    resumed = xt.train(SAMPLED, dmf(), 12, checkpoint=ck, verbose_eval=False)
    assert bytes(straight.save_raw("ubj")) == bytes(resumed.save_raw("ubj"))


def test_resume_ignores_snapshot_of_other_data(tmp_path):
    X, y = _data(seed=6)
    ck = xt.CheckpointConfig(directory=str(tmp_path), every_n_rounds=2)
    xt.train(PARAMS, xt.DMatrix(X, label=y), 4, checkpoint=ck,
             verbose_eval=False)
    X2, y2 = _data(seed=7)
    bst = xt.train(PARAMS, xt.DMatrix(X2, label=y2), 4, checkpoint=ck,
                   verbose_eval=False)
    fresh = xt.train(PARAMS, xt.DMatrix(X2, label=y2), 4,
                     verbose_eval=False)
    assert bytes(bst.save_raw("ubj")) == bytes(fresh.save_raw("ubj"))


def test_early_stopping_window_and_history_survive_resume(tmp_path):
    """A run killed inside early stopping's patience and resumed stops at
    the straight run's round with its best iteration, bytes and
    ``evals_result`` (the snapshot's training log)."""
    X, y = _data(seed=8)
    Xv, yv = _data(n=600, seed=9)
    dv = xt.DMatrix(Xv, label=yv)
    p = dict(PARAMS, eta=0.6, max_depth=6)
    kw = dict(evals=[(dv, "val")], early_stopping_rounds=3)
    res_s, res_r = {}, {}
    straight = xt.train(p, xt.DMatrix(X, label=y), 60, evals_result=res_s,
                        verbose_eval=False, **kw)
    stop = straight.num_boosted_rounds()
    assert stop < 60
    ck = xt.CheckpointConfig(directory=str(tmp_path), every_n_rounds=1)
    with pytest.raises(RuntimeError):
        xt.train(p, xt.DMatrix(X, label=y), 60, checkpoint=ck,
                 callbacks=[DieAtRound(stop - 2)], verbose_eval=False, **kw)
    resumed = xt.train(p, xt.DMatrix(X, label=y), 60, checkpoint=ck,
                       evals_result=res_r, verbose_eval=False, **kw)
    assert resumed.num_boosted_rounds() == stop
    assert resumed.best_iteration == straight.best_iteration
    assert res_r == res_s
    assert bytes(straight.save_raw("ubj")) == bytes(resumed.save_raw("ubj"))


def _fields(snap):
    return (snap.round, snap.model, snap.fingerprint, snap.rng, snap.extra)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_files_load_in_the_other_package(writer, tmp_path):
    """A dart run's snapshot (margin, drop stream, training log): the
    reader's fields equal the writer's, and the reader's Booster loads the
    model and predicts the writer's margins."""
    X, y = _data(seed=10)
    p = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
         "booster": "dart", "rate_drop": 0.3}
    d = str(tmp_path)
    if writer == "port":
        pkg, rd = xt, jck
        ck = xt.CheckpointConfig(directory=d, every_n_rounds=2)
        b = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 4,
                     evals=[(xt.DMatrix(X, label=y), "train")],
                     checkpoint=ck, verbose_eval=False)
        wr = tck
    else:
        pkg, rd = xgb, tck
        ck = xgb.CheckpointConfig(directory=d, every_n_rounds=2)
        b = xgb.train(p, xgb.DMatrix(X, label=y), 4,
                      evals=[(xgb.DMatrix(X, label=y), "train")],
                      checkpoint=ck, verbose_eval=False)
        wr = jck
    path = wr.list_snapshots(d)[0][1]
    mine, theirs = wr.load_snapshot(path), rd.load_snapshot(path)
    assert mine.round == theirs.round == 4
    assert mine.model == theirs.model == bytes(b.save_raw("ubj"))
    assert mine.fingerprint == theirs.fingerprint
    assert mine.rng == theirs.rng
    np.testing.assert_array_equal(mine.margin, theirs.margin)
    assert mine.margin.shape == (len(X), 1) and mine.margin.dtype == np.float32
    assert theirs.extra["training_log"] == mine.extra["training_log"]
    assert len(theirs.extra["training_log"]["history"]["train"][
        "logloss"]) == 4
    for k in ("alg", "pos", "has_gauss", "cached"):
        assert theirs.extra["booster_rng"][k] == mine.extra["booster_rng"][k]
    np.testing.assert_array_equal(theirs.extra["booster_rng"]["keys"],
                                  mine.extra["booster_rng"]["keys"])
    other = (xgb.Booster(model_file=theirs.model) if pkg is xt
             else xt.Booster({"device": "cpu"}, model_file=theirs.model))
    dm = (xgb.DMatrix(X) if pkg is xt else xt.DMatrix(X))
    np.testing.assert_allclose(
        other.predict(dm, output_margin=True).reshape(-1),
        mine.margin.reshape(-1), rtol=1e-5, atol=1e-5)


def test_fingerprints_equal_jax():
    X, y = _data(seed=11)
    w = np.random.RandomState(0).rand(len(y)).astype(np.float32)
    jd, td = (xgb.DMatrix(X, label=y, weight=w),
              xt.DMatrix(X, label=y, weight=w))
    assert tck.dmatrix_fingerprint(td) == jck.dmatrix_fingerprint(jd)
    jd.append(X[:10], label=y[:10], weight=w[:10])
    td.append(X[:10], label=y[:10], weight=w[:10])
    fp = tck.dmatrix_fingerprint(td)
    assert fp == jck.dmatrix_fingerprint(jd)
    assert fp["n_appends"] == 1 and fp["n_rows"] == len(X) + 10
    assert not tck.fingerprints_match(fp, tck.dmatrix_fingerprint(
        xt.DMatrix(X, label=y, weight=w)))


def test_background_writer_and_keep(tmp_path):
    X, y = _data(seed=12)
    a = xt.train(PARAMS, xt.DMatrix(X, label=y), 6, verbose_eval=False,
                 checkpoint=xt.CheckpointConfig(
                     directory=str(tmp_path / "sync"), every_n_rounds=2,
                     keep=None))
    b = xt.train(PARAMS, xt.DMatrix(X, label=y), 6, verbose_eval=False,
                 checkpoint=xt.CheckpointConfig(
                     directory=str(tmp_path / "bg"), every_n_rounds=2,
                     background=True, keep=None))
    assert bytes(a.save_raw("ubj")) == bytes(b.save_raw("ubj"))
    sync = [(r, tck.load_snapshot(p).model)
            for r, p in tck.list_snapshots(str(tmp_path / "sync"))]
    bg = [(r, tck.load_snapshot(p).model)
          for r, p in tck.list_snapshots(str(tmp_path / "bg"))]
    assert sync == bg and [r for r, _ in sync] == [6, 4, 2]
    xt.train(PARAMS, xt.DMatrix(X, label=y), 10, verbose_eval=False,
             checkpoint=xt.CheckpointConfig(
                 directory=str(tmp_path / "keep"), every_n_rounds=2, keep=2,
                 resume=False))
    assert [r for r, _ in tck.list_snapshots(str(tmp_path / "keep"))] == \
        [10, 8]
    with pytest.raises(ValueError):
        xt.CheckpointConfig(directory=str(tmp_path), every_n_rounds=0)


def test_cli_checkpoint_keys(tmp_path):
    """``checkpoint_dir`` / ``checkpoint_every`` / ``checkpoint_keep`` /
    ``resume``: a CLI run writes snapshots, and the same command run
    again with more rounds resumes from them (the JAX package's keys)."""
    from xgboost_tpu_torch.cli import main
    from xgboost_tpu_torch.testing import (agaricus_rows, write_libsvm,
                                           write_mushroom_conf)

    y, idx = agaricus_rows(1000, seed=13)
    d = str(tmp_path)
    write_libsvm(f"{d}/ag.train", y[:800], idx[:800])
    write_libsvm(f"{d}/ag.test", y[800:], idx[800:])
    write_mushroom_conf(f"{d}/m.conf", f"{d}/ag.train", f"{d}/ag.test")
    args = [f"{d}/m.conf", "device=cpu", "silent=1",
            f"checkpoint_dir={d}/ck", "checkpoint_every=2",
            "checkpoint_keep=2"]
    main(args + ["num_round=4", f"model_out={d}/a.model"])
    assert [r for r, _ in tck.list_snapshots(f"{d}/ck")] == [4, 2]
    main(args + ["num_round=6", f"model_out={d}/b.model"])
    assert [r for r, _ in tck.list_snapshots(f"{d}/ck")] == [6, 4]
    b = xt.Booster({"device": "cpu"}, model_file=f"{d}/b.model")
    assert b.num_boosted_rounds() == 6
    main(args + ["num_round=2", "resume=false", f"model_out={d}/c.model"])
    c = xt.Booster({"device": "cpu"}, model_file=f"{d}/c.model")
    assert c.num_boosted_rounds() == 2
