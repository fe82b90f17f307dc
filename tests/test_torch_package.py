"""Package rules of the port, and the slice at full width on the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.serve import Server
from xgboost_tpu_torch.serve.packed import PackedForest
from xgboost_tpu_torch.testing import make_forest, make_forest_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "xgboost_tpu")
# the training slice's modules, each held to the same rule
TRAINING_MODULES = (
    "params.py", "config.py", "tree/param.py", "tree/grow.py",
    "data/quantile.py", "data/binned.py", "data/dmatrix.py",
    "objective/base.py", "objective/regression.py", "ops/histogram.py",
    "ops/split.py", "ops/partition.py", "ops/cuda/hist.py",
    "boosting/gbtree.py", "core.py", "metric/base.py",
    "metric/elementwise.py", "boosting/gblinear.py", "boosting/shap.py",
    "ops/shap.py", "training.py", "sklearn.py", "cli.py", "__main__.py",
    "logging_utils.py", "obs/metrics.py", "parallel/resilience.py",
    "data/fileio.py", "serve/server.py", "serve/registry.py",
    "serve/client.py", "serve/frontend.py", "serve/fleet.py")


def _port_sources():
    root = os.path.join(REPO, "xgboost_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    """An exact match on the top-level module name, so xgboost_tpu_torch
    itself passes and xgboost_tpu (or any of its modules) does not."""
    paths = list(_port_sources())
    assert len(paths) > 20
    scanned = {os.path.relpath(p, REPO) for p in paths}
    for mod in TRAINING_MODULES:
        assert os.path.join("xgboost_tpu_torch", mod) in scanned, mod
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("call", ["booster", "booster_params", "server",
                                  "margin", "resolve"])
def test_entry_points_raise_without_cuda(call):
    """Without a GPU the entry points raise, naming the device, unless
    the caller asks for the CPU; nothing falls back quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    raw = make_forest_model(3, 3, 4)
    trees, info = make_forest(3, 3, 4)
    pf = PackedForest.from_trees(trees, info, 1)
    X = np.zeros((2, 4), np.float32)
    fn = {
        "booster": lambda: xt.Booster(model_file=raw),
        "booster_params": lambda: xt.Booster({"device": "cuda:0"}),
        "server": lambda: Server(models={"m": raw}),
        "margin": lambda: pf.margin(X, np.zeros(1, np.float32)),
        "resolve": lambda: xt.resolve_device("auto"),
    }[call]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()


def test_device_strings():
    assert xt.resolve_device("cpu") == torch.device("cpu")
    assert xt.resolve_device("CPU") == torch.device("cpu")
    for bad in ("tpu", "gpu", "cuda:x"):
        with pytest.raises(ValueError, match="unknown device"):
            xt.resolve_device(bad)
    b = xt.Booster({"device": "cpu"})
    assert b.device == torch.device("cpu")


def test_make_forest_shape():
    trees, info = make_forest(50, 8, 28, seed=0)
    assert len(trees) == 50 and (info == 0).all()
    assert max(t.max_depth() for t in trees) == 8
    mean_nodes = np.mean([t.num_nodes() for t in trees])
    assert 250 < mean_nodes < 480          # 511 before the 10% pruning
    for t in trees:
        internal = ~t.is_leaf
        assert (t.parent[1:] < np.arange(1, t.num_nodes())).all()
        assert (t.split_feature[internal] < 28).all()
        assert (t.sum_hess > 0).all()
    trees3, info3 = make_forest(7, 4, 5, n_groups=3, cat_features=(2,),
                                seed=1)
    assert list(info3) == [0, 1, 2, 0, 1, 2, 0]
    assert any(t.is_cat_split.any() for t in trees3)
    again, _ = make_forest(7, 4, 5, n_groups=3, cat_features=(2,), seed=1)
    assert all((a.split_value == b.split_value).all()
               for a, b in zip(trees3, again))


def test_slice_at_full_width_matches_jax():
    """The slice's model: 500 trees of depth 8 over 28 features (the
    HIGGS shape), binary:logistic. Both packages load the same bytes and
    predict 64 rows, 10% NaN, alike (f32 sums in another order)."""
    raw = make_forest_model(500, 8, 28)
    port = xt.Booster({"device": "cpu"}, model_file=raw)
    jb = xgb.Booster(model_file=raw)
    pf = port.packed_forest()
    assert pf.n_trees == 500 and pf.tree_offsets.shape == (512,)
    assert pf.max_depth == 8 and pf.max_feature == 27
    rng = np.random.RandomState(0)
    X = rng.randn(64, 28).astype(np.float32)
    X[rng.rand(64, 28) < 0.1] = np.nan
    got = port.predict(xt.DMatrix(X))
    want = jb.predict(xgb.DMatrix(X))
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        port.predict(xt.DMatrix(X), output_margin=True),
        jb.predict(xgb.DMatrix(X), output_margin=True), rtol=1e-6,
        atol=1e-6)
