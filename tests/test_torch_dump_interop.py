"""Dumps, importances, ``pred_leaf`` and the reference-schema writer of
the port (``xgboost_tpu_torch/dump.py``, ``interop.py``,
``Booster.predict(pred_leaf=True)``) against the JAX package, on the
CPU.

Each case is one model file, trained by the port and loaded into both
packages (``load_model``), so the two hold the same trees bit for bit:
``get_dump`` (text, json, dot; with and without statistics; ``fmap``
ignored), ``trees_to_dataframe``, ``get_score`` for every importance
type, ``inspect`` and ``save_xgboost_model``'s bytes (JSON and UBJSON)
must be equal, and ``pred_leaf`` equal exactly. Cases: an agaricus-shape
``binary:logistic`` model with feature names, a 3-class model with
``num_parallel_tree`` 2 (the leaf ids in ``iteration_indptr``'s tree
order), a dart model with categorical splits, and a model of each
objective with a parameter block or transform of its own (Poisson,
Gamma, Tweedie, pseudo-Huber, squared-log, hinge, MAE, three quantiles,
AFT, Cox); for those the JAX package's own save of the model also loads
into the port and predicts the same.
"""

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu import interop as jax_interop
from xgboost_tpu_torch.testing import agaricus_rows

from test_torch_adaptive import _data as adaptive_data
from test_torch_objectives import objective_data
from test_torch_survival import survival_data

IMPORTANCE = ("weight", "gain", "cover", "total_gain", "total_cover")


def _agaricus_X(n, seed):
    y, idx = agaricus_rows(n, seed)
    X = np.full((n, 127), np.nan, np.float32)
    X[np.arange(n)[:, None], idx] = 1.0
    return X, y


def _case(name):
    """(model bytes, X, DMatrix keywords) of one case, trained by the
    port on the CPU."""
    rng = np.random.RandomState(7)
    if name == "agaricus":
        X, y = _agaricus_X(1500, seed=2)
        kw = {"feature_names": [f"a{i}" for i in range(127)]}
        p = {"objective": "binary:logistic", "max_depth": 2, "eta": 1.0}
        rounds = 3
    elif name == "multiclass_npt2":
        X = rng.randn(900, 6).astype(np.float32)
        X[rng.rand(900, 6) < 0.1] = np.nan
        y = np.argmax(np.nan_to_num(X[:, :3]) + rng.randn(900, 3), 1) \
            .astype(np.float32)
        kw = {}
        p = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
             "num_parallel_tree": 2, "subsample": 0.8}
        rounds = 2
    elif name in OBJECTIVE_CASES:
        objective, extra = OBJECTIVE_CASES[name]
        kw = {}
        if objective.startswith("survival"):
            X, t, lo, hi = survival_data(n=900, seed=3)
            y = np.where(np.arange(900) % 4 == 1, -t, t) \
                if objective == "survival:cox" else t
            if objective == "survival:aft":
                kw = {"label_lower_bound": lo, "label_upper_bound": hi}
        elif objective in ("reg:absoluteerror", "reg:quantileerror"):
            X, y, _ = adaptive_data(n=900, seed=3)
        else:
            X, y = objective_data(objective, n=900, seed=3)
        p = dict({"objective": objective, "max_depth": 3}, **extra)
        rounds = 3
        b = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y, **kw),
                     rounds, verbose_eval=False)
        return bytes(b.save_raw("json")), X, {}
    else:
        X = rng.randn(900, 4).astype(np.float32)
        X[:, 3] = rng.randint(0, 12, 900)
        y = (X[:, 0] + (X[:, 3] % 3 == 0) > 0.5).astype(np.float32)
        kw = {"feature_types": ["q", "q", "q", "c"],
              "enable_categorical": True}
        p = {"objective": "binary:logistic", "max_depth": 3,
             "booster": "dart", "rate_drop": 0.3}
        rounds = 4
    b = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y, **kw),
                 rounds, verbose_eval=False)
    return bytes(b.save_raw("json")), X, kw


# the objectives with their own parameter blocks or transforms
OBJECTIVE_CASES = {
    "poisson": ("count:poisson", {"max_delta_step": 0.5}),
    "gamma": ("reg:gamma", {}),
    "tweedie": ("reg:tweedie", {"tweedie_variance_power": 1.3}),
    "pseudohuber": ("reg:pseudohubererror", {"huber_slope": 2.0}),
    "squaredlog": ("reg:squaredlogerror", {}),
    "hinge": ("binary:hinge", {}),
    "mae": ("reg:absoluteerror", {}),
    "quantile3": ("reg:quantileerror",
                  {"quantile_alpha": [0.05, 0.5, 0.95]}),
    "aft": ("survival:aft", {"aft_loss_distribution": "logistic",
                             "aft_loss_distribution_scale": 1.2}),
    "cox": ("survival:cox", {}),
}


@pytest.fixture(scope="module", params=["agaricus", "multiclass_npt2",
                                        "dart_categorical",
                                        *OBJECTIVE_CASES])
def shared(request):
    raw, X, kw = _case(request.param)
    jb = xgb.Booster(model_file=raw)
    tb = xt.Booster({"device": "cpu"}, model_file=raw)
    return request.param, jb, tb, X, kw


@pytest.mark.parametrize("fmt", ["text", "json", "dot"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_dumps_equal(shared, fmt, with_stats):
    _, jb, tb, _, _ = shared
    want = jb.get_dump(with_stats=with_stats, dump_format=fmt)
    assert tb.get_dump(with_stats=with_stats, dump_format=fmt) == want
    # fmap is taken and ignored, as in the JAX package
    assert tb.get_dump(fmap="featmap.txt", with_stats=with_stats,
                       dump_format=fmt) == want


def test_dump_model_file_frame_scores_and_report(shared, tmp_path):
    name, jb, tb, _, _ = shared
    for fmt in ("text", "json"):
        jb.dump_model(str(tmp_path / "j.txt"), dump_format=fmt,
                      with_stats=True)
        tb.dump_model(str(tmp_path / "t.txt"), dump_format=fmt,
                      with_stats=True)
        assert (tmp_path / "t.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()
    pytest.importorskip("pandas")
    assert tb.trees_to_dataframe().equals(jb.trees_to_dataframe())
    for kind in IMPORTANCE:
        assert tb.get_score(importance_type=kind) == \
            jb.get_score(importance_type=kind)
    assert tb.get_fscore() == jb.get_fscore()
    assert tb.inspect() == jb.inspect()
    feature = tb.get_dump()[0].split("[", 1)[1].split("<")[0]
    if name != "dart_categorical":
        np.testing.assert_array_equal(
            tb.get_split_value_histogram(feature, as_pandas=False),
            jb.get_split_value_histogram(feature, as_pandas=False))


@pytest.mark.parametrize("ext", ["json", "ubj"])
def test_writer_bytes_equal_and_load_both_ways(shared, tmp_path, ext):
    _, jb, tb, X, kw = shared
    jp, tp = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    jax_interop.save_xgboost_model(jb, jp)
    xt.save_xgboost_model(tb, tp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    back = xt.load_xgboost_model(tp, device="cpu")
    jback = jax_interop.load_xgboost_model(tp)
    base = tb._base_np()
    if not np.all(base == base[0]):
        # the schema's scalar base_score keeps target 0's intercept (with
        # both writers' warning): each row's base margin is given instead
        kw = dict(kw, base_margin=np.broadcast_to(
            base, (len(X), len(base))).astype(np.float32))
    dt, dj = xt.DMatrix(X, **kw), xgb.DMatrix(X, **kw)
    # the file's base_score is in the user's space: its transform and
    # inverse move the base margin by an f32 rounding or so
    np.testing.assert_allclose(back.predict(dt), tb.predict(dt), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(jback.predict(dj), back.predict(dt),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("iteration_range", [None, (0, 1), (1, 2)])
def test_pred_leaf_equal(shared, iteration_range):
    _, jb, tb, X, kw = shared
    got = tb.predict(xt.DMatrix(X, **kw), pred_leaf=True,
                     iteration_range=iteration_range)
    want = jb.predict(xgb.DMatrix(X, **kw), pred_leaf=True,
                      iteration_range=iteration_range)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    lo, hi = tb.gbm._tree_range(iteration_range)
    assert got.shape == (len(X), hi - lo)
    for t in range(hi - lo):
        assert tb.gbm.trees[lo + t].is_leaf[got[:, t]].all()


def test_jax_saved_model_loads_into_the_port(shared):
    """The JAX package's native save of the model loads into the port with
    the objective's parameters, and both predict the same (rtol 1e-6:
    the two walks add the leaves in their own orders)."""
    name, jb, tb, X, kw = shared
    back = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    assert back.obj.name == tb.obj.name
    assert {k: str(v) for k, v in back.obj.params.items()} == \
        {k: str(v) for k, v in tb.obj.params.items()}
    np.testing.assert_allclose(back.predict(xt.DMatrix(X, **kw)),
                               jb.predict(xgb.DMatrix(X, **kw)), rtol=1e-6,
                               atol=1e-7)
