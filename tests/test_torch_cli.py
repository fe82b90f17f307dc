"""The port's command line (``python -m xgboost_tpu_torch``) against the
JAX package's ``xgboost_tpu.cli.main``, on the CPU, over the same
libsvm files with the settings of XGBoost's mushroom demo.

What is compared: both CLIs parse a config to the same pairs; ``train``
grows the same trees node by node (``compare_forests``) and the port's
model file is ``xt.train``'s with the same (string) parameters, byte
for byte; ``dump`` writes the same text for the same model file;
``pred`` of one model file writes predictions within ``PRED_TOL`` of
each other (f32 sums over the trees in another order; ``%.9g`` text),
and of each CLI's own model within ``test_torch_train``'s leaf
tolerance (the same trees, leaves within ``LEAF_ATOL``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.cli import main as jax_main
from xgboost_tpu.cli import parse_config_file as jax_parse
from xgboost_tpu_torch.cli import main, parse_config_file
from xgboost_tpu_torch.serve import ModelLoadError
from xgboost_tpu_torch.testing import (agaricus_rows, write_libsvm,
                                       write_mushroom_conf)

from test_torch_train import LEAF_ATOL, compare_forests

PRED_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    y, idx = agaricus_rows(2500, seed=4)
    train, test = str(d / "ag.train"), str(d / "ag.test")
    write_libsvm(train, y[:2000], idx[:2000])
    write_libsvm(test, y[2000:], idx[2000:])
    conf = str(d / "mushroom.conf")
    write_mushroom_conf(conf, train, test)
    return d, conf, train, test


def _run_both(files, *extra):
    d = files[0]
    out = {}
    for name, fn, dev in (("jax", jax_main, []), ("port", main,
                                                  ["device=cpu"])):
        args = [a.format(d=d, pkg=name) for a in extra]
        assert fn([files[1], *args, *dev]) == 0
        out[name] = args
    return out


def test_config_parses_as_in_jax(files):
    pairs = parse_config_file(files[1])
    assert pairs == jax_parse(files[1])
    assert ("eval[test]", f"{files[3]}?format=libsvm") in pairs
    assert ("eta", "1.0") in pairs


def test_train_dump_pred_match_jax(files, capsys):
    d = files[0]
    _run_both(files, "model_out={d}/{pkg}.model")
    printed = capsys.readouterr().out
    assert "test-logloss" in printed and "saved model to" in printed
    jb = xgb.Booster(model_file=f"{d}/jax.model")
    tb = xt.Booster({"device": "cpu"}, model_file=f"{d}/port.model")
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 2
    full, ties, _ = compare_forests(jb.gbm.trees, tb.gbm.trees, 1.0)
    assert (full, ties) == (2, [])
    # the port's file is xt.train's from the same string parameters
    params = {k: v for k, v in parse_config_file(files[1])
              if k in ("booster", "objective", "eta", "gamma",
                       "min_child_weight", "max_depth")}
    bst = xt.train(dict(params, device="cpu"), xt.DMatrix(
        f"{files[2]}?format=libsvm"), 2, verbose_eval=False)
    with open(f"{d}/port.model", "rb") as fh:
        assert fh.read() == bytes(bst.save_raw("json"))
    # dump: one model file, the same text from both CLIs
    for fmt in ("text", "json"):
        _run_both(files, "task=dump", f"model_in={d}/jax.model",
                  f"dump_format={fmt}", "dump_stats=1",
                  "name_dump={d}/{pkg}.dump")
        with open(f"{d}/jax.dump") as a, open(f"{d}/port.dump") as b:
            want, got = a.read(), b.read()
        assert got == want and "booster[0]" in got or fmt == "json"
    # pred: both CLIs on one model file, then each on its own model
    _run_both(files, "task=pred", f"model_in={d}/jax.model",
              "name_pred={d}/{pkg}.pred")
    want = np.loadtxt(f"{d}/jax.pred")
    got = np.loadtxt(f"{d}/port.pred")
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(got, want, rtol=PRED_TOL, atol=PRED_TOL)
    _run_both(files, "task=pred", "model_in={d}/{pkg}.model",
              "name_pred={d}/{pkg}.own")
    np.testing.assert_allclose(np.loadtxt(f"{d}/port.own"),
                               np.loadtxt(f"{d}/jax.own"), rtol=1e-5,
                               atol=LEAF_ATOL)
    main([files[1], "task=pred", f"model_in={d}/jax.model",
          f"name_pred={d}/cross.pred", "device=cpu", "pred_margin=1",
          "iteration_begin=0", "iteration_end=1"])
    margin = jb.predict(xgb.DMatrix(f"{files[3]}?format=libsvm"),
                        output_margin=True, iteration_range=(0, 1))
    np.testing.assert_allclose(np.loadtxt(f"{d}/cross.pred"), margin,
                               rtol=PRED_TOL, atol=PRED_TOL)


def test_continuation_and_save_period(files):
    d = files[0]
    main([files[1], "device=cpu", f"model_out={d}/first.model", "silent=1"])
    os.makedirs(f"{d}/ck")
    main([files[1], "device=cpu", f"model_in={d}/first.model",
          f"model_out={d}/more.model", "num_round=2", "save_period=1",
          f"model_dir={d}/ck", "silent=1"])
    more = xt.Booster({"device": "cpu"}, model_file=f"{d}/more.model")
    assert more.num_boosted_rounds() == 4
    assert os.listdir(f"{d}/ck")


@pytest.mark.parametrize("argv,exc,match", [
    (["serve", "model={d}/absent.json"], ModelLoadError, "cannot load"),
    (["pipeline", "workdir={d}/pw"], ValueError, "needs data"),
    (["{conf}", "task=cook"], ValueError, "unknown task"),
    (["{conf}", "oops"], ValueError, "key=value"),
])
def test_refusals(files, argv, exc, match):
    d, conf = files[0], files[1]
    with pytest.raises(exc, match=match):
        main([a.format(conf=conf, d=d) for a in argv] + ["device=cpu"])


def test_help_and_module_entry(files):
    assert main(["--help"]) == 0
    assert main([]) == 1
    r = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch", "-h"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "task" in r.stdout
