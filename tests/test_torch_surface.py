"""The package surface of the port against the JAX package's, on the CPU:
the plotting helpers, the six component registries (a plugin objective
trains: the JAX package's ``tests/test_reference_data.py:65`` on the
port; a plugin linear updater is reached by its name), ``build_info``,
the ``TrainParam`` export and the training observer
(``XGBOOST_TPU_DEBUG_OUTPUT``).

``plot_tree``'s PNG needs the ``graphviz`` package and its ``dot``
program: without the package ``to_graphviz`` gives the dot text, and
without either ``plot_tree`` raises, as in the JAX package.
"""

import importlib.util
import shutil

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu import registry as jax_registry
from xgboost_tpu_torch.objective.base import Objective

REGISTRIES = ("OBJECTIVES", "METRICS", "BOOSTERS", "TREE_UPDATERS",
              "PREDICTORS", "LINEAR_UPDATERS")


def _data(n=2000, F=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def booster():
    X, y = _data()
    return xt.train({"objective": "binary:logistic", "max_depth": 3,
                     "device": "cpu"},
                    xt.DMatrix(X, label=y, feature_names=[
                        f"f{i}" for i in range(6)]), 3, verbose_eval=False)


def test_to_graphviz_is_the_dot_dump(booster):
    out = xt.to_graphviz(booster, num_trees=1, rankdir="LR")
    dot = (out if isinstance(out, str) else out.source).rstrip("\n")
    assert dot.startswith("digraph") and "rankdir=LR" in dot
    assert dot == xt.dump.dump_dot(booster.gbm.trees[1], booster.feature_names
                                   ).replace("rankdir=TB", "rankdir=LR")
    with pytest.raises(ValueError, match="out of range"):
        xt.to_graphviz(booster, num_trees=99)
    sk = xt.XGBClassifier(n_estimators=2, max_depth=2, device="cpu")
    sk.fit(*_data(500))
    assert "digraph" in str(xt.to_graphviz(sk))


def test_plot_importance_bars_are_the_scores(booster):
    import matplotlib

    matplotlib.use("Agg")
    ax = xt.plot_importance(booster, importance_type="gain",
                            max_num_features=4)
    scores = booster.get_score(importance_type="gain")
    top = sorted(scores.items(), key=lambda kv: kv[1])[-4:]
    assert [t.get_text() for t in ax.get_yticklabels()] == [k for k, _ in
                                                           top]
    widths = [p.get_width() for p in ax.patches]
    np.testing.assert_allclose(widths, [v for _, v in top])
    assert ax.get_title() == "Feature importance"

    class NoSplits:             # a model of stumps scores no feature
        @staticmethod
        def get_score(importance_type):
            return {}

    with pytest.raises(ValueError, match="empty"):
        xt.plot_importance(NoSplits())


def test_plot_tree_needs_graphviz(booster):
    """``plot_tree`` draws through graphviz's ``dot``: without the package
    it raises ImportError, without the program graphviz's own error (the
    JAX package's behaviour), and with both it returns the axes."""
    import matplotlib

    matplotlib.use("Agg")
    if importlib.util.find_spec("graphviz") is None:
        with pytest.raises(ImportError, match="graphviz"):
            xt.plot_tree(booster)
        return
    import graphviz

    assert isinstance(xt.to_graphviz(booster), graphviz.Source)
    if shutil.which("dot") is None:
        with pytest.raises(graphviz.ExecutableNotFound):
            xt.plot_tree(booster)
    else:
        assert xt.plot_tree(booster, num_trees=2).axison is False


def test_registries_resolve_every_jax_name():
    """The six registries import from the package, filled at import, and
    resolve every name and alias the JAX package's resolve."""
    for name in REGISTRIES:
        reg = getattr(xt, name)
        assert reg is getattr(xt.registry, name)
        jreg = getattr(jax_registry, name)
        for key in jreg.names() + list(jreg._aliases):
            assert key in reg, (name, key)
            assert reg.get(key) is not None
    assert xt.BOOSTERS.get("dart").__name__ == "Dart"
    assert xt.TREE_UPDATERS.get("grow_gpu_hist").__name__ == "TreeGrower"
    assert xt.PREDICTORS.get("auto").__name__ == "PackedForest"
    with pytest.raises(ValueError, match="already registered"):
        xt.OBJECTIVES.register("binary:logistic")(Objective)
    with pytest.raises(ValueError, match="Unknown metric"):
        xt.METRICS.create("no-such-metric")


def test_custom_objective_plugin_registration():
    """A registered objective trains by its name (the reference's example
    plugin 'mylogistic', ``plugin/example/custom_obj.cc``; the JAX
    package's ``tests/test_reference_data.py:65`` on the port), to the
    JAX package's model."""
    from xgboost_tpu.objective.base import Objective as JaxObjective
    import jax.numpy as jnp

    if "mylogistic" not in xt.OBJECTIVES:
        @xt.OBJECTIVES.register("mylogistic")
        class MyLogistic(Objective):
            name = "mylogistic"
            default_metric = "logloss"

            def gradient(self, preds, labels, iteration=0):
                p = torch.sigmoid(preds)
                return torch.stack([p - labels, p * (1.0 - p)], dim=-1)

            def pred_transform(self, margin):
                return torch.sigmoid(margin)

    if "mylogistic" not in jax_registry.OBJECTIVES:
        @jax_registry.OBJECTIVES.register("mylogistic")
        class JaxMyLogistic(JaxObjective):
            name = "mylogistic"
            default_metric = "logloss"

            def gradient(self, preds, labels, iteration=0):
                p = 1.0 / (1.0 + jnp.exp(-preds))
                return jnp.stack([p - labels, p * (1.0 - p)], axis=-1)

            def pred_transform(self, margin):
                return 1.0 / (1.0 + jnp.exp(-margin))

    X, y = _data()
    p = {"objective": "mylogistic", "max_depth": 4, "base_score": 0.5}
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 5,
                  verbose_eval=False)
    pred = tb.predict(xt.DMatrix(X))
    assert float(np.mean((pred > 0.5) == y)) > 0.9
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=y),
                   5, verbose_eval=False)
    np.testing.assert_allclose(pred, jb.predict(xgb.DMatrix(X)), rtol=1e-5,
                               atol=1e-5)


def test_linear_updater_plugin_is_reached_by_name():
    """``GBLinear`` runs the ``LINEAR_UPDATERS`` entry its ``updater``
    names (an unknown name keeps ``shotgun``, as the JAX package's)."""
    from xgboost_tpu_torch.boosting.gblinear import shotgun

    calls = []
    if "counted_shotgun" not in xt.LINEAR_UPDATERS:
        @xt.LINEAR_UPDATERS.register("counted_shotgun")
        def counted_shotgun(*args, **kwargs):
            calls.append(1)
            return shotgun(*args, **kwargs)
    X, y = _data(500)
    p = {"booster": "gblinear", "objective": "binary:logistic",
         "device": "cpu"}
    a = xt.train(dict(p, updater="counted_shotgun"),
                 xt.DMatrix(X, label=y), 3, verbose_eval=False)
    b = xt.train(dict(p, updater="shotgun"), xt.DMatrix(X, label=y), 3,
                 verbose_eval=False)
    assert len(calls) == 3
    np.testing.assert_array_equal(a.gbm.W.numpy(), b.gbm.W.numpy())


def test_build_info_keys_are_the_jax_packages():
    """``build_info`` has the JAX package's keys, its ``jax`` version
    replaced by ``torch`` (and ``cuda``, ``device``, ``kernels_loaded``
    beside them), as the torch build reports them."""
    info, jinfo = xt.build_info(), xgb.build_info()
    assert set(jinfo) - {"jax"} <= set(info)
    assert info["torch"] == torch.__version__
    assert info["cuda"] == torch.version.cuda
    assert info["USE_CUDA"] == torch.backends.cuda.is_built()
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert isinstance(info["kernels_loaded"], list)
    assert info["version"] == xt.__version__


def test_train_param_export():
    from xgboost_tpu_torch.tree.param import TrainParam

    assert xt.TrainParam is TrainParam
    assert set(xt.__all__) >= {"TrainParam", "build_info", "plot_importance",
                               "plot_tree", "to_graphviz", *REGISTRIES}
    jp, tp = xgb.TrainParam(), xt.TrainParam()
    for k in ("eta", "max_depth", "reg_lambda", "min_child_weight",
              "max_bin", "max_leaves"):
        assert getattr(tp, k) == getattr(jp, k), k


def test_observer_prints_gradient_and_margin(monkeypatch, capsys):
    """``XGBOOST_TPU_DEBUG_OUTPUT``: a gradient and a margin line a round,
    in the JAX package's format; round 0's gradient sum is that of the
    logistic gradient at margin 0 (``base_score`` 0.5). Unset: no
    line."""
    X, y = _data(1000)
    p = {"objective": "binary:logistic", "max_depth": 3, "base_score": 0.5}
    monkeypatch.setenv("XGBOOST_TPU_DEBUG_OUTPUT", "1")
    capsys.readouterr()
    xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 2,
             verbose_eval=False)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[observer]")]
    assert [ln.split()[1:3] for ln in lines] == [
        ["iter=0", "gpair:"], ["iter=0", "margin:"],
        ["iter=1", "gpair:"], ["iter=1", "margin:"]]
    assert "shape=(1000, 1, 2)" in lines[0]
    first_sum = float(lines[0].split("sum=")[1].split()[0])
    grad = 0.5 - y                  # round 0 at margin 0; hessian 0.25
    np.testing.assert_allclose(first_sum, grad.sum() + 0.25 * len(y),
                               rtol=1e-6)
    monkeypatch.delenv("XGBOOST_TPU_DEBUG_OUTPUT")
    xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 1,
             verbose_eval=False)
    assert "[observer]" not in capsys.readouterr().out
