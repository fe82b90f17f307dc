"""Model I/O and Booster.predict of the port against the JAX package:
UBJSON, save_raw bytes, the reference-schema fixtures, and the predict
options."""

import json
import os

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.utils import ubjson as jax_ubjson
from xgboost_tpu_torch.utils.ubjson import dumps_ubjson, loads_ubjson

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CPU = {"device": "cpu"}
# f32 sums taken in another order (torch's CPU matmul against XLA's dot);
# 1e-6 is also the bound tests/fixtures/README.md sets for the fixtures
TOL = 1e-6


@pytest.fixture(scope="module")
def trained():
    """name -> (JAX booster, X): a binary and a categorical model."""
    rng = np.random.RandomState(21)
    X = rng.randn(300, 6).astype(np.float32)
    X[rng.rand(300, 6) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 3]) > 0
         ).astype(np.float32)
    binary = xgb.train({"objective": "binary:logistic", "max_depth": 4,
                        "eta": 0.3}, xgb.DMatrix(X, label=y), 8,
                       verbose_eval=False)
    Xc = np.concatenate([rng.randint(0, 6, (300, 1)).astype(np.float32),
                         X[:, 1:]], axis=1)
    yc = ((Xc[:, 0] % 2 == 0) ^ (np.nan_to_num(Xc[:, 1]) > 0)
          ).astype(np.float32)
    types = ["c"] + ["q"] * 5
    cat = xgb.train({"objective": "reg:squarederror", "max_depth": 3,
                     "eta": 0.5},
                    xgb.DMatrix(Xc, label=yc, enable_categorical=True,
                                feature_types=types), 6, verbose_eval=False)
    return {"binary": (binary, X), "cat": (cat, Xc)}


def test_ubjson_round_trip_and_bytes():
    obj = {"a": 1, "b": [1.5, -2, "x", None, True, False],
           "c": {"n": 2 ** 40, "m": -300, "u": 200},
           "t": np.arange(5, dtype=np.int32),
           "f": np.asarray([0.5, -1.25], np.float32)}
    raw = dumps_ubjson(obj)
    assert raw == jax_ubjson.dumps_ubjson(obj)
    back = loads_ubjson(raw)
    assert back["a"] == 1 and back["b"] == [1.5, -2, "x", None, True, False]
    assert back["c"] == {"n": 2 ** 40, "m": -300, "u": 200}
    np.testing.assert_array_equal(back["t"], np.arange(5))
    np.testing.assert_array_equal(back["f"], [0.5, -1.25])
    assert loads_ubjson(dumps_ubjson(back)) is not None


@pytest.mark.parametrize("fmt", ["json", "ubj"])
@pytest.mark.parametrize("name", ["binary", "cat"])
def test_save_raw_bytes_equal(trained, name, fmt):
    """A JAX-saved model, loaded into the port and saved again in the same
    format, gives back the same bytes."""
    bst, _ = trained[name]
    raw = bytes(bst.save_raw(fmt))
    port = xt.Booster(CPU, model_file=raw)
    assert bytes(port.save_raw(fmt)) == raw


@pytest.mark.parametrize("name", ["binary", "cat"])
def test_predict_matches_jax(trained, name):
    bst, X = trained[name]
    port = xt.Booster(CPU, model_file=bst.save_raw("ubj"))
    want = bst.predict(xgb.DMatrix(X, enable_categorical=True,
                                   feature_types=bst.feature_types))
    got = port.predict(xt.DMatrix(X))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


_FIXTURE_X = {
    "gbtree_squarederror.json": [[-1.0, 0.0], [1.0, 2.0], [np.nan, 1.0],
                                 [0.0, np.nan], [2.5, -3.0]],
    "gbtree_logistic.json": [[0.0, -2.0], [0.0, 0.0], [1.0, 5.0],
                             [np.nan, -1.5]],
    "gbtree_categorical.json": [[0.0, 9.9], [1.0, 9.9], [2.0, 9.9],
                                [3.0, 9.9], [np.nan, 9.9], [7.0, 0.0]],
}


@pytest.mark.parametrize("name", sorted(_FIXTURE_X))
def test_reference_fixtures_predict_as_jax(name):
    X = np.asarray(_FIXTURE_X[name], np.float32)
    path = os.path.join(FIXDIR, name)
    jb = xgb.Booster()
    jb.load_model(path)
    want = jb.predict(xgb.DMatrix(X))
    port = xt.Booster(CPU)
    port.load_model(path)
    got = port.predict(xt.DMatrix(X))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # and from bytes, the way the server loads models
    with open(path, "rb") as fh:
        again = xt.Booster(CPU, model_file=fh.read())
    np.testing.assert_array_equal(again.predict(xt.DMatrix(X)), got)


def test_fixture_anchor_values():
    """The hand-computed anchors of tests/test_interop.py hold for the
    port too (squared error: leaves + base 0.5)."""
    port = xt.Booster(CPU, model_file=os.path.join(
        FIXDIR, "gbtree_squarederror.json"))
    got = port.predict(xt.DMatrix(np.asarray(
        _FIXTURE_X["gbtree_squarederror.json"], np.float32)))
    np.testing.assert_allclose(got[:4], [0.2, 0.9, -0.1, 0.9], atol=TOL)


@pytest.mark.parametrize("case", [
    dict(output_margin=True),
    dict(strict_shape=True),
    dict(output_margin=True, strict_shape=True),
    dict(iteration_range=(0, 3)),
    dict(iteration_range=(2, 6), output_margin=True),
    dict(iteration_range=(3, 3), output_margin=True),
    dict(iteration_range=(0, 0)),
])
def test_predict_options_match_jax(trained, case):
    bst, X = trained["binary"]
    port = xt.Booster(CPU, model_file=bst.save_raw("json"))
    want = bst.predict(xgb.DMatrix(X), **case)
    got = port.predict(xt.DMatrix(X), **case)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_base_margin_rows_match_jax(trained):
    bst, X = trained["binary"]
    port = xt.Booster(CPU, model_file=bst.save_raw("json"))
    bm = np.linspace(-1, 1, X.shape[0]).astype(np.float32)
    want = bst.predict(xgb.DMatrix(X, base_margin=bm))
    got = port.predict(xt.DMatrix(X, base_margin=bm))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_model_files_load_by_path(trained, tmp_path):
    bst, X = trained["cat"]
    port = xt.Booster(CPU, model_file=bst.save_raw("json"))
    want = port.predict(xt.DMatrix(X))
    for fmt in ("json", "ubj"):
        path = tmp_path / f"m.{fmt}"
        path.write_bytes(bytes(port.save_raw(fmt)))
        back = xt.Booster(CPU, model_file=str(path))
        np.testing.assert_array_equal(back.predict(xt.DMatrix(X)), want)
        assert bytes(back.save_raw("json")) == bytes(port.save_raw("json"))
    assert json.loads(bytes(port.save_raw("json")))["learner"][
        "feature_types"] == ["c"] + ["q"] * 5


def test_load_refusals(trained):
    with pytest.raises(ValueError, match="legacy binary"):
        xt.Booster(CPU, model_file=b"binf" + b"\x00" * 32)
    bst, X = trained["binary"]
    port = xt.Booster(CPU, model_file=bst.save_raw("json"))
    with pytest.raises(ValueError, match="feature count mismatch"):
        port.predict(xt.DMatrix(X[:, :4]))
    with pytest.raises(ValueError, match="no model loaded"):
        xt.Booster(CPU).predict(xt.DMatrix(X))
    with pytest.raises(NotImplementedError, match="multi:softprob"):
        obj = json.loads(bytes(bst.save_raw("json")))
        obj["learner"]["objective"] = {"name": "multi:softprob"}
        xt.Booster(CPU, model_file=json.dumps(obj).encode())


def test_dmatrix_missing_and_names():
    X = np.asarray([[1.0, -999.0], [3.0, 4.0]], np.float32)
    dm = xt.DMatrix(X, missing=-999.0, feature_names=["a", "b"])
    assert np.isnan(dm.values()[0, 1]) and dm.values()[1, 1] == 4.0
    assert (dm.num_row(), dm.num_col()) == (2, 2)
    assert dm.feature_names == ["a", "b"]
    with pytest.raises(ValueError, match="unique"):
        xt.DMatrix(X, feature_names=["a", "a"])
    with pytest.raises(ValueError, match="base_margin"):
        xt.DMatrix(X, base_margin=[0.0])
