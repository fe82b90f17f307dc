"""The paged two-level schedules against the JAX package's, on the CPU.

``hist_method`` ``coarse``, ``fused``, ``scan`` and ``mega`` on a paged
(external-memory) matrix run one page-major schedule in both packages
(``tree/paged.py``): a level's pass advances each page and builds its
coarse histogram and its fine partial; the refine window comes from the
summed coarse histogram. The port slices the window from the sum of
every page's fine partial; the JAX package from the sum of the uploaded
pages' partials, adding a direct refine build for each cached page. With
every page uploaded the two are the same sums. Held here:

- the port against the JAX paged tier at a page-cache budget of 0 (every
  page uploaded, the refine from the fine partials in both), the JAX
  package's page builds run through ``prehot`` (its CPU ``auto`` is the
  f32 ``segment`` build; ``prehot`` is the int8x2 arithmetic that K2 and
  K4 run on the card, as ``tests/test_torch_paged.py`` runs it): trees
  node by node with the near-tie certificate of
  ``tests/test_torch_train.py``, leaves and predictions at rtol 1e-5
  plus 1e-4;
- the four methods' model bytes equal, and equal under page-cache
  budgets of 0, 2 pages and all pages (every page builds its fine partial
  into one accumulator, in page order, whichever pages are cached);
- a page's direct refine build equal to the slice of its fine partial,
  bit for bit, packed and unpacked (why the two packages' refine sums
  agree);
- the uploads of a round: ``depth + 1`` passes over the uploaded pages;
- the builds of a round: a coarse and a fine one a page and level,
  whatever the budget;
- the refusals the JAX package makes (categorical features, more than
  256 bins).

Small sizes (6,000 rows, pages of 500, depth 4, 3 rounds).
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu.tree.paged as jax_paged
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.ops import histogram as H
from xgboost_tpu_torch.ops.split import (COARSE_SPAN, WINDOW, refine_bin_ids,
                                         refine_from_fine)
from xgboost_tpu_torch.tree import paged as paged_mod
from xgboost_tpu_torch.tree.paged import _PageKernels

from test_data_iterator import BatchIter
from test_torch_paged import PAGE, PAGE_ENV, ROWS, PortIter, _data, _set
from test_torch_train import LEAF_ATOL, compare_forests

CPU = torch.device("cpu")
METHODS = ["coarse", "fused", "scan", "mega"]
ROUNDS = 3
# name -> (max_bin, NaN share, trees equal in full as measured on the CPU)
CONFIGS = {"u8": (64, 0.05, 3), "u4": (15, 0.05, 3)}
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3}


_make_kernels = jax_paged._make_kernels


def _prehot_kernels(grower):
    """The JAX package's page kernels with its int8x2 ``prehot`` build in
    place of its CPU ``auto``."""
    kernels = _make_kernels(grower)
    kernels.hist_kernel = "prehot"
    return kernels


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """Each configuration trained once by the JAX paged tier under
    ``coarse``, every page uploaded."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("jax_two_level")
    out = {}
    try:
        for k, v in PAGE_ENV.items():
            mp.setenv(k, v)
        mp.setenv("XTPU_PAGE_CACHE_BYTES", "0")
        mp.setattr(jax_paged, "_make_kernels", _prehot_kernels)
        for i, (name, (max_bin, nan, _)) in enumerate(CONFIGS.items()):
            X, y = _data(60 + i, nan=nan)
            it = BatchIter(X, y, n_batches=5)
            it.cache_prefix = str(tmp / name)
            jq = xgb.QuantileDMatrix(it, max_bin=max_bin)
            res = {}
            bst = xgb.train(dict(PARAMS, hist_method="coarse",
                                 max_bin=max_bin), jq, ROUNDS,
                            evals=[(jq, "train")], evals_result=res,
                            verbose_eval=False)
            out[name] = (X, y, bst, res)
    finally:
        mp.undo()
    return out


def _port(X, y, max_bin, method, budget_pages, tmp_path, monkeypatch,
          tag, rounds=ROUNDS):
    _set(monkeypatch)
    W = (X.shape[1] + 1) // 2 if max_bin < 16 else X.shape[1]
    monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", str(budget_pages * PAGE * W))
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / tag)), max_bin=max_bin)
    res = {}
    bst = xt.train(dict(PARAMS, hist_method=method, max_bin=max_bin,
                        device="cpu"), tq, rounds, evals=[(tq, "train")],
                   evals_result=res, verbose_eval=False)
    assert tq.binned(max_bin, CPU).cached_pages(CPU) == budget_pages
    bst.set_param({"hist_method": "coarse"})   # one recorded method
    return bst, res, bytes(bst.save_raw("ubj"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_two_level_equals_jax_and_budgets(name, method, jax_models,
                                                tmp_path, monkeypatch):
    """Each method against the JAX package's paged ``coarse``, and its
    bytes under budgets of 0, 2 pages and all pages."""
    max_bin, _, full_min = CONFIGS[name]
    X, y, jbst, jres = jax_models[name]
    raws = set()
    for budget in (0, 2, ROWS // PAGE):
        bst, res, raw = _port(X, y, max_bin, method, budget, tmp_path,
                              monkeypatch, f"{budget}")
        raws.add(raw)
        if budget == 0:
            first, first_res = bst, res
    assert len(raws) == 1, "page-cache budgets differ"
    full, ties, drift = compare_forests(jbst.gbm.trees, first.gbm.trees,
                                        eta=0.3)
    print(f"{name}/{method}: {full} of {ROUNDS} trees equal in full, near "
          f"ties {ties}, largest leaf drift {drift:.3e}")
    assert full >= full_min
    assert first_res["train"] == jres["train"]
    np.testing.assert_allclose(first.predict(xt.DMatrix(X)),
                               jbst.predict(xgb.DMatrix(X)),
                               rtol=1e-5, atol=LEAF_ATOL)


def test_paged_methods_save_one_set_of_bytes(tmp_path, monkeypatch):
    """The four names are one schedule on pages: one set of bytes (each
    booster recording one ``hist_method``)."""
    X, y = _data(70)
    raws = {m: _port(X, y, 64, m, 3, tmp_path, monkeypatch, m,
                     rounds=2)[2] for m in METHODS}
    assert len(set(raws.values())) == 1


@pytest.mark.parametrize("packed", [False, True])
def test_refine_from_fine_equals_direct_refine(packed):
    """A page's refine histogram: the direct build over ``refine_bin_ids``
    equals the window's slice of its fine partial bit for bit (both are
    the page's int8x2 integers at its scale)."""
    rng = np.random.RandomState(5 + packed)
    n, F, N = 700, 5, 4
    nb = 16 if packed else 200
    bins = rng.randint(0, nb, (n, F)).astype(np.uint8)
    gpair = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    gpair[:, 1] = gpair[:, 1].abs()
    rel = torch.from_numpy(rng.randint(0, N + 1, n).astype(np.int32))
    span = torch.from_numpy(rng.randint(0, max(nb // COARSE_SPAN - 1, 1),
                                        (N, F)))
    page = torch.from_numpy(bins)
    packed_u4 = 0
    if packed:
        from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

        page = torch.from_numpy(PagedBinnedMatrix._pack_host(bins))
        packed_u4 = F
    mb = nb - 1
    fine = H.build_hist(page, gpair, rel, N, nb, packed_u4=packed_u4)
    span_row = torch.cat([span, torch.zeros_like(span[:1])])[rel.long()]
    direct = H.build_hist(refine_bin_ids(torch.from_numpy(bins), span_row,
                                         mb), gpair, rel, N,
                          WINDOW + 4)[:, :, :WINDOW]
    assert torch.equal(refine_from_fine(fine, span, mb), direct)


def test_two_level_uploads_depth_plus_one_a_round(tmp_path, monkeypatch):
    """With no page cached a round reads every page ``depth + 1`` times
    (the coarse pass of each level carries the fine partial; the final
    advance), where a refine re-read would make it ``2 * depth + 1``."""
    X, y = _data(71, nan=0.0)
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=0)
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "u")), max_bin=64)
    paged = tq.binned(64, CPU)
    xt.train(dict(PARAMS, hist_method="fused", max_bin=64, device="cpu"),
             tq, 2, verbose_eval=False)
    assert paged.ring_stats["uploads"] == 2 * (4 + 1) * paged.n_pages()


@pytest.mark.parametrize("budget", [0, 2, ROWS // PAGE])
def test_two_level_builds_do_not_depend_on_the_budget(budget, tmp_path,
                                                      monkeypatch):
    """Every page, cached or uploaded, builds its coarse and its fine
    histogram once a level into the level's two accumulators: ``2 * depth``
    builds a page and round under any page-cache budget, and no histogram
    of a page outlives its pass."""
    X, y = _data(73, nan=0.0)
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=budget * PAGE * X.shape[1])
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "b")), max_bin=64)
    paged = tq.binned(64, CPU)
    builds = []
    real = paged_mod.build_hist

    def counted(*a, **k):
        out = real(*a, **k)
        builds.append(out.shape)
        return out

    monkeypatch.setattr(paged_mod, "build_hist", counted)
    xt.train(dict(PARAMS, hist_method="scan", max_bin=64, device="cpu"),
             tq, 2, verbose_eval=False)
    depth, pages = PARAMS["max_depth"], paged.n_pages()
    assert len(builds) == 2 * 2 * depth * pages
    assert paged.cached_pages(CPU) == budget
    # per level and page: the coarse build (20 slots), then the fine one
    assert [b[2] for b in builds[:2]] == [20, builds[1][2]]
    assert builds[1][2] > 20


def test_page_kernels_take_auto_for_the_two_level_names():
    """The page passes under a two-level name are ``auto``'s plain builds
    (the JAX package's ``_make_kernels``); a ``+sub`` / ``+nosub`` suffix
    is dropped, as the JAX package's ``_strip_hist_suffix`` drops it."""
    for m in METHODS:
        assert _PageKernels(64, m, True).hist_method == "auto"
        assert _PageKernels(64, m + "+sub", True).hist_method == "auto"
    assert _PageKernels(64, "auto+sub", True).hist_method == "auto"
    assert _PageKernels(64, "prehot+nosub", True).hist_method == "prehot"


@pytest.mark.parametrize("what", ["categorical", "bins"])
def test_paged_two_level_refusals(what, tmp_path, monkeypatch):
    """The JAX package's refusal: numeric features and at most 256 bins."""
    _set(monkeypatch)
    X, y = _data(72, n=1000)
    max_bin, kw = 64, {}
    if what == "categorical":
        X[:, 0] = np.random.RandomState(0).randint(0, 5, len(X))
        kw = {"types": ["c"] + ["q"] * (X.shape[1] - 1)}
    else:
        max_bin = 300
    it = PortIter(X, y, 2, cache_prefix=str(tmp_path / "r"))
    if kw:
        nxt = it.next

        def typed(input_data):
            return nxt(lambda **b: input_data(feature_types=kw["types"], **b))

        it.next = typed
    tq = xt.QuantileDMatrix(it, max_bin=max_bin)
    with pytest.raises(NotImplementedError, match="max_bin <= 256"):
        xt.train(dict(PARAMS, hist_method="scan", max_bin=max_bin,
                      device="cpu"), tq, 1, verbose_eval=False)
