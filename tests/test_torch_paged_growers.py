"""The paged tier's growers and data paths against the JAX package's, on
the CPU.

Every configuration the JAX package's single-device paged tier trains,
past the depthwise one-pass schedule of ``tests/test_torch_paged.py``,
goes through both packages from the same seeded batches (6,000 rows,
pages of 500, 3 rounds), the JAX package's page builds under
``hist_method="prehot"`` (the int8x2 arithmetic of K2 and K4):

- leaf-wise growth (``max_leaves``, ``max_depth=0``, packed pages, both
  constraints), depthwise monotone and interaction constraints and
  ``max_leaves``, categorical features (one-hot and partition splits,
  depthwise and leaf-wise), vector leaves (depthwise and leaf-wise) and
  ``tree_method="approx"``: structure node by node with the near-tie
  certificate of ``tests/test_torch_train.py``, leaves and predictions
  at rtol 1e-5 plus 1e-4, the eval history to its six digits (1e-5),
  and the port's bytes equal under page-cache budgets of 0 and all
  pages;
- ``booster="gblinear"`` (``shotgun`` over pages): weights and margins
  at the tolerances of ``tests/test_torch_gblinear.py``;
- an iterator's categorical cuts, types announced on a later batch
  too, and the paged re-sketch's cuts and bins bit for bit;
- ``append`` / ``append_rows``: appended bins bit for bit and the
  fingerprint's CRC chain equal, then a round on the grown matrix.
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.utils.checkpoint import dmatrix_fingerprint as jax_fp
from xgboost_tpu_torch.utils.checkpoint import dmatrix_fingerprint as port_fp

from test_data_iterator import BatchIter
from test_torch_gblinear import PRED_TOL, W_TOL, _weights
from test_torch_paged import PAGE, ROWS, PortIter, _data, _set
from test_torch_train import LEAF_ATOL, compare_forests

CPU = torch.device("cpu")
ROUNDS = 3


class TypedJaxIter(BatchIter):
    """``BatchIter`` announcing ``feature_types`` from batch ``at`` on."""

    def __init__(self, X, y, types, n_batches=5, at=0):
        super().__init__(X, y, n_batches)
        self.types, self.at = types, at

    def next(self, input_data) -> int:
        if self.i >= len(self.parts):
            return 0
        idx = self.parts[self.i]
        kw = {"data": self.X[idx], "label": self.y[idx]}
        if self.i >= self.at:
            kw["feature_types"] = self.types
        input_data(**kw)
        self.i += 1
        return 1


class TypedPortIter(PortIter):
    """The port's twin of :class:`TypedJaxIter`."""

    def __init__(self, X, y, types, n_batches=5, at=0, cache_prefix=None):
        super().__init__(X, y, n_batches, cache_prefix=cache_prefix)
        self.types, self.at = types, at

    def next(self, input_data) -> int:
        if self.i >= len(self.parts):
            return 0
        idx = self.parts[self.i]
        kw = {"data": self.X[idx], "label": self.y[idx]}
        if self.i >= self.at:
            kw["feature_types"] = self.types
        input_data(**kw)
        self.i += 1
        return 1


CAT_TYPES = ["q"] * 5 + ["c", "c"]


def _cat_data(seed, n=ROWS):
    """Five numeric columns and two codes (3 categories: one-hot; 12:
    sorted partition), the label driven by both."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7).astype(np.float32)
    X[:, 5] = rng.randint(0, 3, n)
    X[:, 6] = rng.randint(0, 12, n)
    effect = rng.randn(12)
    y = (X[:, 0] + effect[X[:, 6].astype(int)] + 0.8 * (X[:, 5] == 1)
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    X[rng.rand(n, 7) < 0.03] = np.nan
    return X, y


def _multi_data(seed, n=ROWS, K=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7).astype(np.float32)
    Y = (X @ rng.randn(7, K) + 0.5 * rng.randn(n, K)).astype(np.float32)
    X[rng.rand(n, 7) < 0.05] = np.nan
    return X, Y


# name -> (data, max_bin, parameters, trees equal in full as measured on
# the CPU, lossguide)
LG = {"grow_policy": "lossguide"}
CASES = {
    "lossguide": ("num", 64, dict(LG, max_leaves=12, max_depth=0), 3, True),
    "lossguide_u4": ("num", 15, dict(LG, max_leaves=8, max_depth=3), 3,
                     True),
    "lossguide_constraints": (
        "num", 64, dict(LG, max_leaves=10, max_depth=0,
                        monotone_constraints="(1,0,-1,0,0,0,0)",
                        interaction_constraints="[[0, 1], [2, 3, 4]]"),
        3, True),
    "monotone": ("num", 64, {"monotone_constraints": "(1,0,-1,0,0,0,0)"},
                 3, False),
    "interaction": ("num", 64,
                    {"interaction_constraints": "[[0, 1], [2, 3, 4]]"}, 3,
                    False),
    "max_leaves": ("num", 64, {"max_depth": 5, "max_leaves": 9}, 3, False),
    "categorical": ("cat", 64, {}, 3, False),
    "categorical_lossguide": ("cat", 64, dict(LG, max_leaves=10,
                                              max_depth=0), 3, True),
    "vector_leaf": ("multi", 64, {"objective": "reg:squarederror",
                                  "multi_strategy": "multi_output_tree"},
                    3, False),
    "vector_leaf_lossguide": (
        "multi", 64, dict(LG, objective="reg:squarederror", max_leaves=8,
                          multi_strategy="multi_output_tree"), 3, True),
    "approx": ("num", 64, {"tree_method": "approx"}, 3, False),
}
BASE = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3}


def _iters(kind, seed, tag, tmp_path):
    """(X, y, the JAX iterator, a maker of the port's iterator)."""
    if kind == "cat":
        X, y = _cat_data(seed)
        jit = TypedJaxIter(X, y, CAT_TYPES)

        def port(prefix):
            return TypedPortIter(X, y, CAT_TYPES, cache_prefix=prefix)
    else:
        X, y = _multi_data(seed) if kind == "multi" else _data(seed)
        jit = BatchIter(X, y, n_batches=5)

        def port(prefix):
            return PortIter(X, y, 5, cache_prefix=prefix)
    jit.cache_prefix = str(tmp_path / f"j{tag}")
    return X, y, jit, port


@pytest.mark.parametrize("name", list(CASES))
def test_paged_grower_equals_jax_paged_tier(name, tmp_path, monkeypatch):
    kind, max_bin, extra, full_min, capped = CASES[name]
    seed = 80 + list(CASES).index(name)
    X, y, jit, port_iter = _iters(kind, seed, name, tmp_path)
    params = dict(BASE, max_bin=max_bin, **extra)
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=0)
    jq = xgb.QuantileDMatrix(jit, max_bin=max_bin)
    jres = {}
    jbst = xgb.train(dict(params, hist_method="prehot"), jq, ROUNDS,
                     evals=[(jq, "train")], evals_result=jres,
                     verbose_eval=False)
    raws = set()
    for budget in (0, ROWS // PAGE):
        W = (X.shape[1] + 1) // 2 if max_bin < 16 else X.shape[1]
        monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", str(budget * PAGE * W))
        tq = xt.QuantileDMatrix(port_iter(str(tmp_path / f"t{budget}")),
                                max_bin=max_bin)
        assert tq.is_paged
        res = {}
        tbst = xt.train(dict(params, device="cpu"), tq, ROUNDS,
                        evals=[(tq, "train")], evals_result=res,
                        verbose_eval=False)
        raws.add(bytes(tbst.save_raw("ubj")))
        if budget == 0:
            first, first_res = tbst, res
    assert len(raws) == 1, "page-cache budgets differ"
    full, ties, drift = compare_forests(jbst.gbm.trees, first.gbm.trees,
                                        eta=0.3, capped=capped)
    print(f"{name}: {full} of {len(jbst.gbm.trees)} trees equal in full, "
          f"near ties {ties}, largest leaf drift {drift:.3e}")
    assert full >= full_min
    for k, v in jres["train"].items():    # the eval line's six digits
        np.testing.assert_allclose(first_res["train"][k], v, rtol=0,
                                   atol=1e-5)
    if kind == "cat":
        kinds = {bool(c) for t in first.gbm.trees
                 for c, leaf in zip(t.is_cat_split, t.is_leaf) if not leaf}
        assert True in kinds
    np.testing.assert_allclose(first.predict(xt.DMatrix(X)),
                               jbst.predict(xgb.DMatrix(X)),
                               rtol=1e-5, atol=LEAF_ATOL)


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_paged_gblinear_equals_jax(objective, tmp_path, monkeypatch):
    """``shotgun`` over the pages: weights and margins as the resident
    comparison holds them; ``coord_descent`` on pages refuses, as in the
    JAX package."""
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=0)
    X, y = _data(95)
    p = {"booster": "gblinear", "objective": objective, "lambda": 1.0,
         "alpha": 0.0001, "eta": 0.5, "max_bin": 64}
    jit = BatchIter(X, y, n_batches=5)
    jit.cache_prefix = str(tmp_path / "j")
    jq = xgb.QuantileDMatrix(jit, max_bin=64)
    jb = xgb.train(p, jq, 5, verbose_eval=False)
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "t")), max_bin=64)
    tb = xt.train(dict(p, device="cpu"), tq, 5, verbose_eval=False)
    jW, jbias = _weights(jb)
    tW, tbias = _weights(tb)
    np.testing.assert_allclose(tW, jW, rtol=W_TOL, atol=W_TOL)
    np.testing.assert_allclose(tbias, jbias, rtol=W_TOL, atol=W_TOL)
    want = jb.predict(jq, output_margin=True)
    got = tb.predict(tq, output_margin=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL * max(
        1.0, float(np.abs(want).max())))
    with pytest.raises(NotImplementedError, match="shotgun only"):
        xt.train(dict(p, device="cpu", updater="coord_descent"), tq, 1,
                 verbose_eval=False)


@pytest.mark.parametrize("at", [0, 3])
def test_iterator_categorical_cuts_equal_jax(at, tmp_path, monkeypatch):
    """An iterator's categorical cuts and bins bit for bit, the types
    announced on the first batch or only on the fourth (the codes of the
    batches before count)."""
    _set(monkeypatch)
    X, y = _cat_data(96)
    X[:50, 6] = 40.0      # the largest code only in the first batch
    jit = TypedJaxIter(X, y, CAT_TYPES, at=at)
    jit.cache_prefix = str(tmp_path / "j")
    jq = xgb.QuantileDMatrix(jit, max_bin=64)
    tq = xt.QuantileDMatrix(TypedPortIter(X, y, CAT_TYPES, at=at,
                                          cache_prefix=str(tmp_path / "t")),
                            max_bin=64)
    jb, tb = jq.binned(64), tq.binned(64, CPU)
    for k in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(tb.cuts, k),
                                      getattr(jb.cuts, k))
    np.testing.assert_array_equal(tb.cuts.is_cat(), jb.cuts.is_cat())
    assert tb.cuts.n_real_bins()[6] == 41
    np.testing.assert_array_equal(np.asarray(tb.bins_host),
                                  np.asarray(jb.bins_host))
    assert tq.feature_types == CAT_TYPES


def test_resketch_equals_jax(tmp_path, monkeypatch):
    """The paged re-sketch of ``approx``: cuts and re-binned pages bit for
    bit for the same hessian."""
    _set(monkeypatch)
    X, y = _data(97)
    jit = BatchIter(X, y, n_batches=5)
    jit.cache_prefix = str(tmp_path / "j")
    jb = xgb.QuantileDMatrix(jit, max_bin=32).binned(32)
    tb = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "t")), max_bin=32).binned(32, CPU)
    hess = np.random.RandomState(1).rand(ROWS).astype(np.float32)
    jr = jb.resketch(32, hess.astype(np.float64))
    tr = tb.resketch(32, hess.astype(np.float64))
    for k in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(tr.cuts, k),
                                      getattr(jr.cuts, k))
    assert (tr.max_nbins, tr.page_rows) == (jr.max_nbins, jr.page_rows)
    np.testing.assert_array_equal(tr.bins_host, np.asarray(jr.bins_host))


@pytest.mark.parametrize("max_bin", [15, 64])
def test_append_rows_and_chain_equal_jax(max_bin, tmp_path, monkeypatch):
    """Appended rows binned against the frozen cuts bit for bit (the
    memmap grown), the append chain and fingerprint equal, and the grown
    matrix trains a round on from the model."""
    W = 4 if max_bin < 16 else 7         # u4-packed pages: ceil(7 / 2)
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=2 * PAGE * W)
    X, y = _data(98)
    Xa, ya = _data(99, n=700)
    jit = BatchIter(X, y, n_batches=5)
    jit.cache_prefix = str(tmp_path / "j")
    jq = xgb.QuantileDMatrix(jit, max_bin=max_bin)
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "t")), max_bin=max_bin)
    params = dict(BASE, max_bin=max_bin)
    tb = xt.train(dict(params, device="cpu"), tq, 2, verbose_eval=False)
    paged = tq.binned(max_bin, CPU)
    assert paged.cached_pages(CPU) == 2
    for lo, hi in ((0, 300), (300, 700)):
        assert jq.append(Xa[lo:hi], label=ya[lo:hi]) == \
            tq.append(Xa[lo:hi], label=ya[lo:hi])
    assert isinstance(paged.bins_host, np.memmap)
    assert paged.cached_pages(CPU) == 0
    np.testing.assert_array_equal(np.asarray(paged.bins_host),
                                  np.asarray(jq.binned(max_bin).bins_host))
    assert port_fp(tq) == jax_fp(jq)
    assert port_fp(tq)["n_appends"] == 2
    np.testing.assert_array_equal(tq.info.labels, jq.info.labels)
    tb = xt.train(dict(params, device="cpu"), tq, 1, verbose_eval=False,
                  xgb_model=tb)
    assert tb.num_boosted_rounds() == 3
    assert tb.predict(tq).shape == (ROWS + 700,)


def test_append_to_resident_matrices(tmp_path, monkeypatch):
    """``append`` on a raw matrix (its device bins grown against the
    frozen cuts) and on an iterator-built resident one: the bins equal
    the JAX package's, and the appends' chain too."""
    _set(monkeypatch)
    X, y = _data(100, n=2000)
    Xa, ya = _data(101, n=300)
    jd, td = xgb.DMatrix(X, label=y), xt.DMatrix(X, label=y)
    jd.binned(64), td.binned(64, CPU)
    jd.append(Xa, label=ya)
    td.append(Xa, label=ya)
    np.testing.assert_array_equal(td.binned(64, CPU).bins.numpy(),
                                  np.asarray(jd.binned(64).bins))
    assert port_fp(td) == jax_fp(jd)
    tq = xt.QuantileDMatrix(PortIter(X, y, 2), max_bin=64)
    jq = xgb.QuantileDMatrix(BatchIter(X, y, n_batches=2), max_bin=64)
    jq.append(Xa, label=ya)
    tq.append(Xa, label=ya)
    np.testing.assert_array_equal(tq.binned(64, CPU).bins.numpy(),
                                  np.asarray(jq.binned(64).bins))
    with pytest.raises(ValueError, match="label="):
        td.append(Xa)


def test_paged_lossguide_refuses_two_level(tmp_path, monkeypatch):
    """Leaf-wise growth on pages builds each pair in one pass (the JAX
    package's paged lossguide refuses the two-level names)."""
    _set(monkeypatch)
    X, y = _data(102, n=1000)
    tq = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / "l")), max_bin=64)
    with pytest.raises(NotImplementedError, match="resident matrices only"):
        xt.train(dict(BASE, max_bin=64, device="cpu", hist_method="coarse",
                      **LG, max_leaves=4), tq, 1, verbose_eval=False)
