"""External memory over a data mesh: the port against the JAX package, on
the CPU.

The counterparts of the JAX package's ``tests/test_paged_mesh.py``
(``:59``, ``:75``, ``:91``, ``:108``, ``:127``, ``:141``, ``:152``,
``:185``, ``:220``), plus a two-level (``scan``) case and a u4 (packed
pages) case. Each case trains the same seeded batches through the JAX
package on its CPU mesh of 4 devices (``xgb.make_data_mesh(4)``) and
through the port on ``Mesh(["cpu"] * 4)``, both paged with the same
``XTPU_PAGE_ROWS`` and a page-cache budget below one page (every level
streams every page). The JAX package builds its pages with
``hist_method="prehot"`` (the int8x2 arithmetic of K2 and K4; its CPU
``auto`` is the f32 ``segment`` build), and its two-level schedule
through ``prehot`` too (``_make_kernels`` patched, as
``tests/test_torch_paged_two_level.py`` does); the port with ``auto``.
Each (shard, page) block quantises with its own scale in both
packages. Held:

- split fields node by node, bit for bit, with the near-tie
  certificate of ``tests/test_torch_train.py compare_tree`` (every
  case's trees in full as measured on the CPU, each case's count
  named); over those trees the largest leaf drift within
  ``JAX_DRIFT`` (1e-5; the two packages' f32 sums part by a few
  roundings) and predictions at rtol 1e-5 + 1e-5, the eval history at
  its six digits;
- the port alone: its paged mesh against its resident mesh under
  ``pallas:f32`` (K3's fixed point, whose page sums differ from one
  build's by f32 roundings only): bit for bit on a round of dyadic
  gradients, under the certificate and ``JAX_DRIFT`` over five logistic
  rounds; its model bytes equal under
  page-cache budgets of 0 pages, 2 pages and all pages, its page
  builds (shards x pages x levels a tree) and uploads (pages x passes),
  and each cached block the rows of its own shard (the mesh cache is
  keyed by a page's local start, one entry holding every shard's block:
  on the CPU mesh every shard's device is ``cpu``, so a key by device
  would hand one shard's rows to another).

Small sizes: a few thousand rows, pages of 400 or 500 rows, depth at
most 4 (8 in the gather-walk case, one round), ``max_bin`` 64.
"""

import numpy as np
import pytest
import torch

import jax

import xgboost_tpu as xgb
import xgboost_tpu.tree.paged as jax_paged
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.context import Mesh
from xgboost_tpu_torch.tree import paged as paged_mod

from test_data_iterator import BatchIter
from test_torch_paged import PortIter
from test_torch_paged_growers import TypedJaxIter, TypedPortIter
from test_torch_train import compare_forests

WORLD = 4
CPU = torch.device("cpu")
# the largest leaf drift of the trees in full, against the JAX package
# and against the port's resident mesh: the f32 sums part by a few
# roundings, which a leaf's cancelling sum of gradients magnifies (on the
# CPU the one-device paged tier's leaves against the JAX package's by up
# to 4.3e-6 on the auto case's rows, the mesh cases' by up to 8.4e-6,
# dart's), so leaves are held to this bound, below compare_tree's own
# LEAF_ATOL
JAX_DRIFT = 1e-5


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the CPU mesh of tests/conftest.py")
    return xgb.make_data_mesh(WORLD)


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * WORLD)


def _binary(n, F=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X @ rng.randn(F) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _vector(n, F, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    Y = np.stack([X @ rng.randn(F), X @ rng.randn(F)], axis=1)
    return X, (Y + 0.3 * rng.randn(n, 2)).astype(np.float32)


def _monotone_cat(n, seed):
    rng = np.random.RandomState(seed)
    Xn = rng.randn(n, 3).astype(np.float32)
    Xc = rng.randint(0, 12, (n, 1)).astype(np.float32)
    X = np.concatenate([Xn, Xc], axis=1)
    y = (Xn[:, 0] + 0.5 * (Xc[:, 0] % 3) + 0.1 * rng.randn(n) > 0.5
         ).astype(np.float32)
    return X, y


MC_TYPES = ["q", "q", "q", "c"]
BIN = {"objective": "binary:logistic", "eta": 0.3}
LG = {"grow_policy": "lossguide", "max_depth": 0}
VEC = {"objective": "reg:squarederror",
       "multi_strategy": "multi_output_tree"}

# name -> (data maker, page rows, max_bin, parameters, rounds, port
# hist_method, trees in full against the JAX package as measured on the
# CPU, leaf-wise)
CASES = {
    "auto": (lambda: _binary(6000, seed=11), 500, 64,
             dict(BIN, max_depth=4), 5, "auto", 5, False),
    "deep_gather_walk": (lambda: _binary(6000, seed=12), 500, 64,
                         {"objective": "reg:squarederror",
                          "base_score": 0.5, "max_depth": 8,
                          "min_child_weight": 4.0}, 1, "auto", 1, False),
    "dart": (lambda: _binary(6000, seed=13), 500, 64,
             dict(BIN, max_depth=4, booster="dart", rate_drop=0.3), 4,
             "auto", 4, False),
    "lossguide": (lambda: _binary(6000, seed=14), 500, 64,
                  dict(BIN, max_leaves=12, **LG), 4, "auto", 4, True),
    "multi_output_tree": (lambda: _vector(3000, 6, 7), 400, 64,
                          dict(VEC, max_depth=4, max_leaves=10), 4, "auto",
                          4, False),
    "monotone_categorical": (lambda: _monotone_cat(4000, 5), 500, 32,
                             dict(BIN, max_depth=4,
                                  monotone_constraints="(1,0,0,0)",
                                  max_cat_to_onehot=1), 4, "auto", 4,
                             False),
    "multi_lossguide": (lambda: _vector(2401, 5, 17), 400, 64,
                        dict(VEC, max_leaves=6, **LG), 3, "auto", 3, True),
    "scan": (lambda: _binary(6000, seed=15), 500, 64,
             dict(BIN, max_depth=4), 3, "scan", 3, False),
    "u4": (lambda: _binary(6000, seed=16), 500, 15,
           dict(BIN, max_depth=4), 3, "auto", 3, False),
}


def _iters(name, X, y, tmp_path, tag):
    """(the JAX iterator, a maker of the port's) over 4 batches, typed in
    the categorical case."""
    if name == "monotone_categorical":
        jit = TypedJaxIter(X, y, MC_TYPES, n_batches=4)

        def port(prefix):
            return TypedPortIter(X, y, MC_TYPES, n_batches=4,
                                 cache_prefix=prefix)
    else:
        jit = BatchIter(X, y, n_batches=4)

        def port(prefix):
            return PortIter(X, y, 4, cache_prefix=prefix)
    jit.cache_prefix = str(tmp_path / f"j{tag}")
    return jit, port


def _prehot_kernels(grower):
    """The JAX package's page kernels with its int8x2 ``prehot`` build in
    place of its CPU ``auto`` (the two-level schedule's page builds)."""
    kernels = _make_kernels(grower)
    kernels.hist_kernel = "prehot"
    return kernels


_make_kernels = jax_paged._make_kernels


def _env(monkeypatch, page_rows, budget=1):
    monkeypatch.setenv("XTPU_PAGE_ROWS", str(page_rows))
    monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", str(budget))
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")


def _jax_train(name, jmesh, jit, max_bin, params, rounds, monkeypatch,
               evals=()):
    two_level = params.get("hist_method") == "scan"
    jp = dict(params, hist_method="coarse" if two_level else "prehot",
              mesh=jmesh, max_bin=max_bin)
    jq = xgb.QuantileDMatrix(jit, max_bin=max_bin)
    with monkeypatch.context() as mp:
        if two_level:
            mp.setattr(jax_paged, "_make_kernels", _prehot_kernels)
        res = {}
        bst = xgb.train(jp, jq, rounds, evals=[(jq, "train")] if evals
                        else (), evals_result=res, verbose_eval=False)
    return jq, bst, res


def _port_train(tmesh, port_iter, prefix, max_bin, params, rounds,
                evals=False, method="auto"):
    tq = xt.QuantileDMatrix(port_iter(prefix), max_bin=max_bin)
    assert tq.is_paged
    res = {}
    bst = xt.train(dict(params, hist_method=method, device="cpu",
                        mesh=tmesh, max_bin=max_bin), tq, rounds,
                   evals=[(tq, "train")] if evals else (),
                   evals_result=res, verbose_eval=False)
    return tq, bst, res


def _check_leaves_and_predictions(jb, tb, full, X, drift):
    """The trees in full: the largest leaf drift within ``JAX_DRIFT`` and
    the predictions of those trees at rtol 1e-5 + ``JAX_DRIFT``."""
    assert drift <= JAX_DRIFT, drift
    if full:
        np.testing.assert_allclose(
            tb.predict(xt.DMatrix(X), iteration_range=(0, full)),
            jb.predict(xgb.DMatrix(X), iteration_range=(0, full)),
            rtol=1e-5, atol=JAX_DRIFT)


@pytest.mark.parametrize("name", list(CASES))
def test_paged_mesh_equals_jax_paged_mesh(name, jmesh, tmesh, tmp_path,
                                          monkeypatch):
    """Each case's trees, leaves and predictions against the JAX
    package's paged mesh, every level streaming every page."""
    make, page_rows, max_bin, params, rounds, method, full_min, capped = \
        CASES[name]
    X, y = make()
    _env(monkeypatch, page_rows)
    jit, port_iter = _iters(name, X, y, tmp_path, name)
    jparams = dict(params, hist_method=method) if method == "scan" \
        else params
    jq, jb, jres = _jax_train(name, jmesh, jit, max_bin, jparams, rounds,
                              monkeypatch, evals=True)
    assert jq.binned(max_bin).n_pages() > 1
    tq, tb, tres = _port_train(tmesh, port_iter, str(tmp_path / "t"),
                               max_bin, params, rounds, evals=True,
                               method=method)
    paged = tq.binned(max_bin, CPU)
    assert paged.bins_host.nbytes > paged.cache_budget_bytes
    assert paged.cached_mesh_pages() == 0 and paged.n_pages() > 1
    if name == "u4":
        assert paged.packed
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees,
                                        eta=params.get("eta", 0.3),
                                        capped=capped)
    print(f"{name}: {full} of {len(jb.gbm.trees)} trees in full, near "
          f"ties {ties}, largest leaf drift {drift:.3e}")
    assert full >= full_min
    _check_leaves_and_predictions(jb, tb, full, X, drift)
    for k, v in jres["train"].items():    # the eval line's six digits
        np.testing.assert_allclose(tres["train"][k], v, rtol=0, atol=1e-5)
    if name == "deep_gather_walk":
        assert any(len(t.split_feature) > 100 for t in tb.gbm.trees)
    if capped:
        cap = params["max_leaves"]
        assert all(int(np.asarray(t.is_leaf).sum()) <= cap
                   for t in tb.gbm.trees)
    if name == "monotone_categorical":
        assert any(np.asarray(t.is_cat_split).any() for t in tb.gbm.trees)


@pytest.mark.parametrize("kind", ["uneven_rows", "separate_eval_matrix"])
def test_paged_mesh_eval_sets_equal_jax(kind, jmesh, tmesh, tmp_path,
                                        monkeypatch):
    """Eval sets: the training matrix itself at 6,001 rows (a shard pad
    and a page-alignment pad: 6,001 rows are no multiple of 4 shards or
    of a 500-row page), and a separate paged eval matrix (its margin has
    the real rows, the training gradients the padded ones)."""
    _env(monkeypatch, 500)
    params = {"objective": "binary:logistic", "max_depth": 4,
              "eval_metric": "logloss", "max_bin": 64}
    if kind == "uneven_rows":
        X, y = _binary(6001, seed=21)
        Xe = ye = None
    else:
        Xa, ya = _binary(8500, seed=22)
        X, y, Xe, ye = Xa[:6000], ya[:6000], Xa[6000:], ya[6000:]
    jit = BatchIter(X, y, n_batches=4)
    jit.cache_prefix = str(tmp_path / "j")
    jq = xgb.QuantileDMatrix(jit, max_bin=64)
    tq = xt.QuantileDMatrix(PortIter(X, y, 4, cache_prefix=str(
        tmp_path / "t")), max_bin=64)
    if Xe is None:
        jev, tev = [(jq, "train")], [(tq, "train")]
    else:
        jite = BatchIter(Xe, ye, n_batches=3)
        jite.cache_prefix = str(tmp_path / "je")
        jqe = xgb.QuantileDMatrix(jite, max_bin=64, ref=jq)
        tqe = xt.QuantileDMatrix(PortIter(Xe, ye, 3, cache_prefix=str(
            tmp_path / "te")), max_bin=64, ref=tq)
        assert tqe.is_paged
        jev, tev = [(jqe, "val")], [(tqe, "val")]
    jres, tres = {}, {}
    jb = xgb.train(dict(params, hist_method="prehot", mesh=jmesh), jq, 5,
                   evals=jev, evals_result=jres, verbose_eval=False)
    tb = xt.train(dict(params, device="cpu", mesh=tmesh), tq, 5, evals=tev,
                  evals_result=tres, verbose_eval=False)
    name = jev[0][1]
    ll = tres[name]["logloss"]
    assert len(ll) == 5 and ll[-1] < ll[0]
    np.testing.assert_allclose(ll, jres[name]["logloss"], rtol=0, atol=1e-5)
    full, ties, drift = compare_forests(jb.gbm.trees, tb.gbm.trees,
                                        eta=0.3)
    assert full == 5, ties
    _check_leaves_and_predictions(jb, tb, full, X, drift)
    p = tb.predict(xt.DMatrix(X))
    assert p.shape == (len(X),) and np.isfinite(p).all()


@pytest.mark.parametrize("case", ["dyadic_round", "five_rounds"])
def test_paged_mesh_equals_resident_mesh(case, tmesh, tmp_path,
                                         monkeypatch):
    """The port's paged mesh against its resident mesh of the same rows
    and shards under ``pallas:f32`` (K3's fixed point: a build's sums are
    exact to one f32 rounding, so only the order of the pages' additions
    separates the two). One squared-error round from base 0.5 keeps every
    gradient dyadic (+-0.5, hessian 1), so every sum is exact in any
    order and the trees are equal bit for bit, at depth 6; five logistic
    rounds agree node by node under the certificate, leaves within
    ``JAX_DRIFT`` (4.0e-6 as measured on the CPU: a leaf's sum of
    gradients cancels, which magnifies the roundings)."""
    _env(monkeypatch, 500)
    X, y = _binary(6000, seed=31)
    if case == "dyadic_round":
        p, rounds = {"objective": "reg:squarederror", "base_score": 0.5,
                     "max_depth": 6, "min_child_weight": 4.0}, 1
    else:
        p, rounds = dict(BIN, max_depth=4), 5
    p = dict(p, device="cpu", mesh=tmesh, max_bin=64,
             hist_method="pallas:f32")
    tq = xt.QuantileDMatrix(PortIter(X, y, 4, cache_prefix=str(
        tmp_path / "p")), max_bin=64)
    rq = xt.QuantileDMatrix(PortIter(X, y, 4), max_bin=64)
    assert tq.is_paged and not rq.is_paged
    bp = xt.train(p, tq, rounds, verbose_eval=False)
    br = xt.train(p, rq, rounds, verbose_eval=False)
    if case == "dyadic_round":
        for a, b in zip(br.gbm.trees, bp.gbm.trees):
            for k in ("split_feature", "split_bin", "leaf_value",
                      "sum_hess"):
                np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        assert len(bp.gbm.trees[0].split_feature) > 40
        return
    full, ties, drift = compare_forests(br.gbm.trees, bp.gbm.trees, eta=0.3)
    assert full == rounds and drift <= JAX_DRIFT, (ties, drift)
    np.testing.assert_allclose(bp.predict(xt.DMatrix(X)),
                               br.predict(xt.DMatrix(X)), rtol=1e-5,
                               atol=JAX_DRIFT)


@pytest.mark.parametrize("method", ["auto", "scan", "lossguide"])
def test_paged_mesh_bytes_equal_across_budgets(method, tmesh, tmp_path,
                                               monkeypatch):
    """One model's bytes at page-cache budgets of 0, 2 and all mesh pages
    (the cached pages first, then the streamed ones, in page order:
    the sums are added in the same order whatever the budget), the
    cache holding as many mesh pages as the budget buys."""
    X, y = _binary(6000, seed=41)
    params = dict(BIN, max_depth=4)
    if method == "lossguide":
        params = dict(BIN, max_leaves=8, **LG)
    raws = set()
    for pages in (0, 2, None):
        _env(monkeypatch, 500)
        tq = xt.QuantileDMatrix(PortIter(X, y, 4, cache_prefix=str(
            tmp_path / f"b{pages}")), max_bin=64)
        paged = tq.binned(64, CPU)
        unit = paged.mesh_page_nbytes(WORLD)
        n_mesh = paged.mesh_layout(WORLD)[1] // paged.mesh_layout(WORLD)[2]
        paged.set_cache_budget(unit * (n_mesh if pages is None else pages))
        bst = xt.train(dict(params, device="cpu", mesh=tmesh, max_bin=64,
                            hist_method="auto" if method == "lossguide"
                            else method), tq, 3, verbose_eval=False)
        assert paged.cached_mesh_pages() == (n_mesh if pages is None
                                             else pages)
        raws.add(bytes(bst.save_raw("ubj")))
    assert len(raws) == 1, "page-cache budgets differ"


def test_paged_mesh_builds_and_uploads(tmesh, tmp_path, monkeypatch):
    """A round's page builds: one a shard, mesh page and level (the
    shards' partials summed once a level, not once a page); its uploads:
    every mesh page on every pass (the levels' and the last advance's)."""
    _env(monkeypatch, 500, budget=0)
    X, y = _binary(6000, seed=51)
    tq = xt.QuantileDMatrix(PortIter(X, y, 4, cache_prefix=str(
        tmp_path / "c")), max_bin=64)
    paged = tq.binned(64, CPU)
    n_pad, n_loc, p_loc = paged.mesh_layout(WORLD)
    assert (n_pad, n_loc, p_loc) == (6000, 1500, 125)
    n_mesh = n_loc // p_loc
    calls = []
    orig = paged_mod.build_hist

    def counted(bins, gp, rel, n_nodes, *a, **k):
        calls.append((bins.shape[0], n_nodes))
        return orig(bins, gp, rel, n_nodes, *a, **k)

    monkeypatch.setattr(paged_mod, "build_hist", counted)
    depth, rounds = 4, 2
    paged.reset_ring_stats()
    xt.train(dict(BIN, max_depth=depth, device="cpu", mesh=tmesh,
                  max_bin=64), tq, rounds, verbose_eval=False)
    assert len(calls) == rounds * depth * WORLD * n_mesh
    assert {r for r, _ in calls} == {p_loc}
    assert paged.ring_stats["uploads"] == rounds * (depth + 1) * n_mesh
    assert paged.ring_stats["bytes"] == (rounds * (depth + 1) * n_mesh
                                         * WORLD * p_loc * X.shape[1])


def test_mesh_cache_holds_each_shards_own_rows(tmesh, tmp_path,
                                               monkeypatch):
    """Every shard of the CPU mesh is the device ``cpu``: the mesh cache
    keys a page by its local start and holds every shard's block in one
    entry, each block the rows of its own shard (pad rows at the fill
    bin), apart from the one-device cache, which the mesh leaves
    empty; a ragged matrix pads its last shard."""
    _env(monkeypatch, 500)
    X, y = _binary(5003, seed=61)
    tq = xt.QuantileDMatrix(PortIter(X, y, 4, cache_prefix=str(
        tmp_path / "k")), max_bin=64)
    paged = tq.binned(64, CPU)
    n_pad, n_loc, p_loc = paged.mesh_layout(WORLD)
    paged.set_cache_budget(1 << 30)
    xt.train(dict(BIN, max_depth=3, device="cpu", mesh=tmesh, max_bin=64),
             tq, 1, verbose_eval=False)
    host = np.asarray(paged.bins_host)
    fill = min(paged.missing_bin, paged.max_nbins - 1)
    assert paged.cached_mesh_pages() == n_loc // p_loc
    assert paged.cached_pages(CPU) == 0
    for s in range(0, n_loc, p_loc):
        e, blocks = paged._mesh_cache[s]
        assert e == s + p_loc and len(blocks) == WORLD
        assert len({b.data_ptr() for b in blocks}) == WORLD
        for d, b in enumerate(blocks):
            want = np.full((p_loc, host.shape[1]), fill, host.dtype)
            rows = host[d * n_loc + s:min(d * n_loc + s + p_loc, len(host))]
            want[:len(rows)] = rows
            np.testing.assert_array_equal(b.numpy(), want)
