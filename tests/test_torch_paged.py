"""The port's external-memory tier against the JAX package's, on the CPU.

A matrix built from a ``DataIter`` (two passes: per-batch sketches
merged and pruned, then each batch binned into a memmap under the
iterator's ``cache_prefix``) trains from host memory in row pages
through a page cache and a prefetch ring (``data/binned.py
PagedBinnedMatrix``, ``tree/paged.py``). Held against the JAX package:

- cuts and memmap bins bit for bit, with and without ``ref=``, with
  weights and with the per-batch sketch sample; the u4 page packing
  byte for byte, and ``unpack_u4`` its inverse;
- the u4 plain builds against the Pallas kernel in interpret mode
  (``packed_u4=F``) at the int8x2 quantum, and over the unpacked ids
  against ``prehot`` bit for bit;
- paged training against the JAX paged tier under ``hist_method=
  "prehot"`` (per page the int8x2 arithmetic that K2/K4 run, pages
  added in page order): structure node by node with the near-tie
  certificate of ``tests/test_torch_train.py``, leaves and predictions
  at rtol 1e-5 plus 1e-4; the port's model bytes equal under page-cache
  budgets of 0, 2 pages and all pages and under packed and unpacked
  transport;
- evaluation, continuation and ``predict`` on a paged matrix; the
  collapse to the resident tier and its budget; the ring's page counts,
  its lead and the streamed pages it keeps alive;
  the configurations the port does not run yet (the paged two-level
  schedules, growers, approx, gblinear and appends are
  ``tests/test_torch_paged_two_level.py`` and
  ``tests/test_torch_paged_growers.py``).

Small sizes (6,000 rows, pages of 500, depth 3-4, 3 rounds); the JAX
package trains each configuration once.
"""

import threading
import weakref

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.data import quantile as jax_quantile
from xgboost_tpu.data.binned import PagedBinnedMatrix as JaxPaged
from xgboost_tpu_torch.data import quantile as port_quantile
from xgboost_tpu_torch.data.binned import BinnedMatrix, PagedBinnedMatrix
from xgboost_tpu_torch.ops import histogram as H

from test_data_iterator import BatchIter
from test_torch_train import LEAF_ATOL, compare_forests

CPU = torch.device("cpu")
ROWS, PAGE = 6000, 500
PAGE_ENV = {"XTPU_PAGE_ROWS": str(PAGE), "XTPU_PAGED_COLLAPSE": "0",
            "XTPU_BATCH_ROUNDS": "1"}


class PortIter(xt.DataIter):
    """The port's twin of ``test_data_iterator.BatchIter``."""

    def __init__(self, X, y, n_batches=5, weight=None, cache_prefix=None):
        super().__init__(cache_prefix)
        self.parts = np.array_split(np.arange(len(X)), n_batches)
        self.X, self.y, self.w = X, y, weight
        self.i = 0

    def next(self, input_data) -> int:
        if self.i >= len(self.parts):
            return 0
        idx = self.parts[self.i]
        kw = {"data": self.X[idx], "label": self.y[idx]}
        if self.w is not None:
            kw["weight"] = self.w[idx]
        input_data(**kw)
        self.i += 1
        return 1

    def reset(self) -> None:
        self.i = 0


def _data(seed, F=7, n=ROWS, nan=0.05, classes=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    if classes:
        y = np.argmax(X[:, :classes] + 0.8 * rng.randn(n, classes),
                      1).astype(np.float32)
    else:
        y = (X @ rng.randn(F) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    X[rng.rand(n, F) < nan] = np.nan
    return X, y


def _both(X, y, max_bin, tmp_path, tag, *, weight=None, jax_ref=None,
          port_ref=None, cache=True, n_batches=5):
    """The same batches into a JAX and a port ``QuantileDMatrix``."""
    it = BatchIter(X, y, n_batches=n_batches, weight=weight)
    it.cache_prefix = str(tmp_path / f"j{tag}") if cache else None
    jq = xgb.QuantileDMatrix(it, max_bin=max_bin, ref=jax_ref)
    tq = xt.QuantileDMatrix(
        PortIter(X, y, n_batches, weight,
                 str(tmp_path / f"t{tag}") if cache else None),
        max_bin=max_bin, ref=port_ref)
    return jq, tq


def _set(monkeypatch, **env):
    for k, v in dict(PAGE_ENV, **env).items():
        monkeypatch.setenv(k, str(v))


# ---- data: cuts, bins and the u4 packing ------------------------------------

@pytest.mark.parametrize("case", ["plain", "weighted", "ref", "sampled"])
def test_iterator_cuts_and_bins_equal_jax(case, tmp_path, monkeypatch):
    """Cuts and memmap bins bit for bit: unweighted, weighted (no batch
    sample), through ``ref=`` (the training matrix's cuts), and with the
    per-batch sketch sample (a quarter of ``SKETCH_SAMPLE_ROWS``)."""
    _set(monkeypatch)
    X, y = _data(1, F=6)
    w = (np.random.RandomState(2).rand(ROWS) + 0.5).astype(np.float32)
    if case == "sampled":
        monkeypatch.setattr(jax_quantile, "SKETCH_SAMPLE_ROWS", 2000)
        monkeypatch.setattr(port_quantile, "SKETCH_SAMPLE_ROWS", 2000)
    jq, tq = _both(X, y, 64, tmp_path, "a",
                   weight=w if case == "weighted" else None)
    if case == "ref":
        Xv, yv = _data(3, F=6, n=1500)
        # from an array with ref=: the training matrix's cuts, binned
        # resident
        ja = xgb.QuantileDMatrix(Xv, label=yv, max_bin=64, ref=jq)
        ta = xt.QuantileDMatrix(Xv, label=yv, max_bin=64, ref=tq)
        np.testing.assert_array_equal(
            ta.binned(64, CPU).bins.numpy(), np.asarray(ja.binned(64).bins))
        jq, tq = _both(Xv, yv, 64, tmp_path, "v", jax_ref=jq, port_ref=tq,
                       n_batches=2)
    jb, tb = jq.binned(64), tq.binned(64, CPU)
    assert isinstance(tb, PagedBinnedMatrix) and tq.is_paged
    assert isinstance(tb.bins_host, np.memmap)
    for k in ("values", "ptrs", "min_vals"):
        np.testing.assert_array_equal(getattr(tb.cuts, k),
                                      getattr(jb.cuts, k))
    assert (tb.max_nbins, tb.has_missing, tb.page_rows) == \
        (jb.max_nbins, jb.has_missing, PAGE)
    assert tb.bins_host.dtype == jb.bins_host.dtype
    np.testing.assert_array_equal(np.asarray(tb.bins_host),
                                  np.asarray(jb.bins_host))
    np.testing.assert_array_equal(tq.info.labels, jq.info.labels)
    if case == "weighted":
        np.testing.assert_array_equal(tq.info.weights, jq.info.weights)
    # representative values, as the JAX package predicts on them
    np.testing.assert_array_equal(tq.values(), jq.values())


@pytest.mark.parametrize("F", [7, 8])
def test_pack_host_equals_jax_and_unpack_inverts(F):
    """``_pack_host`` makes the JAX package's bytes (odd F pads a zero
    high nibble), ``unpack_u4`` inverts it, and the advance reads the
    same bin ids from the packed page."""
    rng = np.random.RandomState(F)
    bins = rng.randint(0, 16, (333, F)).astype(np.uint8)
    packed = PagedBinnedMatrix._pack_host(bins)
    np.testing.assert_array_equal(packed, JaxPaged._pack_host(bins))
    assert packed.shape == (333, (F + 1) // 2)
    t = torch.from_numpy(packed)
    assert torch.equal(H.unpack_u4(t, F), torch.from_numpy(bins))
    from xgboost_tpu_torch.ops.partition import gather_bins

    rows = torch.arange(333)
    feat = torch.from_numpy(rng.randint(0, F, 333))
    assert torch.equal(gather_bins(t, rows, feat, packed=True),
                       torch.from_numpy(bins)[rows, feat].long())


def test_u4_plain_builds_against_pallas_interpret_and_prehot():
    """K2's and K3's u4 plain versions: against the Pallas kernel on the
    packed block in interpret mode (``packed_u4=F``) at the int8x2
    quantum (its row blocks add in f32), and over the unpacked ids equal
    to ``prehot`` bit for bit (K2) and to K3's plain version (K3)."""
    import jax.numpy as jnp
    from xgboost_tpu.ops.histogram import build_hist as jax_build_hist
    from xgboost_tpu.ops.histogram import unpack_u4 as jax_unpack
    from xgboost_tpu.ops.pallas.histogram import build_hist_pallas

    rng = np.random.RandomState(0)
    n, F, B, N = 500, 5, 16, 4
    bins = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    gpair = rng.randn(n, 2).astype(np.float32)
    rel = rng.randint(0, N + 1, size=n).astype(np.int32)
    packed = PagedBinnedMatrix._pack_host(bins)
    np.testing.assert_array_equal(
        np.asarray(jax_unpack(jnp.asarray(packed), F)), bins)
    tp, tg, tr = (torch.from_numpy(a) for a in (packed, gpair, rel))
    q, inv = H.quantise_int8x2(tg)
    port = H.build_hist_int8x2_u4_reference(tp, F, q, tr, inv, N, B)
    pallas = np.asarray(build_hist_pallas(
        jnp.asarray(packed).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        precision="int8x2", block_rows=256, interpret=True, packed_u4=F))
    scale = max(np.abs(pallas).max(), 1.0)
    np.testing.assert_allclose(port.numpy() / scale, pallas / scale,
                               rtol=2e-4, atol=2e-4)
    prehot = np.asarray(jax_build_hist(jnp.asarray(bins), jnp.asarray(gpair),
                                       jnp.asarray(rel), N, B,
                                       method="prehot"))
    np.testing.assert_array_equal(port.numpy(), prehot)
    assert torch.equal(H.build_hist(tp, tg, tr, N, B, method="prehot",
                                    packed_u4=F), port)
    qs, inv3 = H.fixed_point_scale(tg)
    for precision in ("f32", "bf16x2", "bf16"):
        k3 = H.build_hist_f32_u4_reference(tp, F, tg, tr, qs, inv3, N, B,
                                           precision=precision)
        assert torch.equal(k3, H.build_hist_f32_reference(
            torch.from_numpy(bins), tg, tr, qs, inv3, N, B,
            precision=precision))
    f32 = np.asarray(build_hist_pallas(
        jnp.asarray(packed).T, jnp.asarray(gpair), jnp.asarray(rel), N, B,
        precision="f32", block_rows=256, interpret=True, packed_u4=F))
    np.testing.assert_allclose(
        H.build_hist_f32_u4_reference(tp, F, tg, tr, qs, inv3, N,
                                      B).numpy(), f32, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="K4"):
        H.build_hist(tp, tg, tr, N, B, method="scan", packed_u4=F)


# ---- training against the JAX paged tier ------------------------------------

# name -> (max_bin, parameters, NaN share, classes, trees equal in full
# as measured on the CPU); max_bin 15 with missing values is 16 slots:
# packed transport
CONFIGS = {
    "u4_sampled": (15, {"objective": "binary:logistic", "max_depth": 4,
                        "subsample": 0.8, "colsample_bytree": 0.8,
                        "colsample_bynode": 0.8}, 0.05, 0, 3),
    "u8": (64, {"objective": "binary:logistic", "max_depth": 4}, 0.0, 0, 3),
    "multiclass": (32, {"objective": "multi:softprob", "num_class": 3,
                        "max_depth": 3, "subsample": 0.8,
                        "colsample_bylevel": 0.8}, 0.05, 3, 9),
    # levels of 256 nodes: the port's auto would take K3 there, so both
    # packages run prehot (int8x2 at every level); base_score 0.5 makes
    # the first round's gradients exact in both (tests/test_torch_train.py);
    # round 1 has a near tie in a small deep node, so one tree in full
    "deep_prehot": (15, {"objective": "binary:logistic", "max_depth": 9,
                         "base_score": 0.5, "hist_method": "prehot"},
                    0.05, 0, 1),
}
ROUNDS = 3


@pytest.fixture(scope="module")
def jax_paged_models(tmp_path_factory):
    """Each configuration trained once by the JAX paged tier (prehot)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("jax_paged")
    out = {}
    try:
        for k, v in PAGE_ENV.items():
            mp.setenv(k, v)
        mp.setenv("XTPU_PAGE_CACHE_BYTES", "0")
        for i, (name, (max_bin, params, nan, classes, _)) in enumerate(
                CONFIGS.items()):
            X, y = _data(10 + i, nan=nan, classes=classes)
            it = BatchIter(X, y, n_batches=5)
            it.cache_prefix = str(tmp / name)
            jq = xgb.QuantileDMatrix(it, max_bin=max_bin)
            assert jq.binned(max_bin).packed == (max_bin < 16)
            res = {}
            bst = xgb.train(dict({"hist_method": "prehot"}, eta=0.3,
                                 max_bin=max_bin, **params), jq, ROUNDS,
                            evals=[(jq, "train")], evals_result=res,
                            verbose_eval=False)
            out[name] = (X, y, bst, res)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_training_equals_jax_paged_tier(name, jax_paged_models,
                                              tmp_path, monkeypatch):
    """The port's paged tier against the JAX package's, and its model
    bytes under page-cache budgets of 0, 2 pages and all pages, with
    packed and unpacked transport (the sum order is page order under
    every budget)."""
    max_bin, params, nan, classes, full_min = CONFIGS[name]
    X, y, jbst, jres = jax_paged_models[name]
    raws = {}
    for pack in ("1", "0"):
        for budget in (0, 2, ROWS // PAGE):
            _set(monkeypatch, XTPU_PAGE_PACK=pack)
            W = (X.shape[1] + 1) // 2 if pack == "1" and max_bin < 16 \
                else X.shape[1]
            monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES",
                               str(budget * PAGE * W))
            tq = xt.QuantileDMatrix(
                PortIter(X, y, 5, cache_prefix=str(
                    tmp_path / f"{pack}{budget}")), max_bin=max_bin)
            paged = tq.binned(max_bin, CPU)
            assert paged.packed == (pack == "1" and max_bin < 16)
            res = {}
            tbst = xt.train(dict(params, eta=0.3, max_bin=max_bin,
                                 device="cpu"), tq, ROUNDS,
                            evals=[(tq, "train")], evals_result=res,
                            verbose_eval=False)
            assert paged.cached_pages(CPU) == budget
            raws[(pack, budget)] = bytes(tbst.save_raw("ubj"))
            if (pack, budget) == ("1", 0):
                first, first_res = tbst, res
    assert len(set(raws.values())) == 1, "budgets or transports differ"
    full, ties, drift = compare_forests(jbst.gbm.trees, first.gbm.trees,
                                        eta=0.3)
    print(f"{name}: {full} of {len(jbst.gbm.trees)} trees equal in full, "
          f"near ties {ties}, largest leaf drift {drift:.3e}")
    assert full >= full_min
    rounds = full // max(classes, 1)
    assert {k: v[:rounds] for k, v in first_res["train"].items()} == \
        {k: v[:rounds] for k, v in jres["train"].items()}
    np.testing.assert_allclose(
        first.predict(xt.DMatrix(X), iteration_range=(0, rounds)),
        jbst.predict(xgb.DMatrix(X), iteration_range=(0, rounds)),
        rtol=1e-5, atol=LEAF_ATOL)


def test_paged_eval_continuation_and_predict(tmp_path, monkeypatch):
    """A paged validation set built with ``ref=`` evaluated beside the
    paged training set, training continued from the model
    (``xgb_model=``, the margin walked over the pages' bins), and
    ``predict`` on the paged matrix (its representative values): equal
    to the JAX package's."""
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=2 * PAGE * 4)
    X, y = _data(20, nan=0.05)
    Xv, yv = _data(21, n=1500, nan=0.05)
    jq, tq = _both(X, y, 15, tmp_path, "tr")
    jv, tv = _both(Xv, yv, 15, tmp_path, "va", jax_ref=jq, port_ref=tq,
                   n_batches=3)
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
              "max_bin": 15, "eval_metric": ["logloss", "rmse"]}
    out = []
    for pkg, dtr, dva, extra in ((xgb, jq, jv, {"hist_method": "prehot"}),
                                 (xt, tq, tv, {"device": "cpu"})):
        p = dict(params, **extra)
        res, res2 = {}, {}
        b = pkg.train(p, dtr, 2, evals=[(dtr, "train"), (dva, "valid")],
                      evals_result=res, verbose_eval=False)
        b2 = pkg.train(p, dtr, 1, evals=[(dtr, "train"), (dva, "valid")],
                       evals_result=res2, verbose_eval=False,
                       xgb_model=b.save_raw("json"))
        out.append((res, res2, b2, b2.predict(dva), b2.predict(dtr)))
    (jr, jr2, jb, jpv, jpt), (tr, tr2, tb, tpv, tpt) = out
    assert tr == jr and tr2 == jr2
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 3
    assert compare_forests(jb.gbm.trees, tb.gbm.trees, eta=0.3)[0] == 3
    np.testing.assert_allclose(tpv, jpv, rtol=1e-5, atol=LEAF_ATOL)
    np.testing.assert_allclose(tpt, jpt, rtol=1e-5, atol=LEAF_ATOL)


def test_ring_uploads_streamed_pages_once_a_pass(tmp_path, monkeypatch):
    """Under a budget of 2 of 12 pages the first pass caches pages 0 and
    1 and uploads all 12; each later pass uploads the other 10: a tree
    of depth 4 makes 5 passes (root, 3 advances with histograms, the
    last advance), 52 uploads. The cache is a prefix of the pages."""
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=2 * PAGE * 7)
    X, y = _data(30, nan=0.0)
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "r")), max_bin=64)
    paged = tq.binned(64, CPU)
    xt.train({"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
              "device": "cpu"}, tq, 1, verbose_eval=False)
    assert paged.ring_stats["uploads"] == 12 + 4 * 10
    assert paged.ring_stats["bytes"] == 52 * PAGE * 7
    cached, streamed = paged.cached_split(CPU)
    assert [s for s, _, _ in cached] == [0, PAGE]
    assert streamed == list(range(2 * PAGE, ROWS, PAGE))
    assert 0.0 <= paged.streaming_overlap() <= 1.0
    paged.reset_ring_stats()
    assert paged.ring_stats["uploads"] == 0
    assert paged.streaming_overlap() is None


def test_ring_keeps_its_lead_and_at_most_depth_plus_one_pages(
        tmp_path, monkeypatch):
    """A pass over 12 streamed pages with a ring of 3 (``tree/paged.py
    _PageKernels._drive``): the upload of page i + 3 has begun while the
    pass works on page i, and when it is asked for (where the ring takes
    its device memory) only pages i .. i + 2 are alive: the pass and the
    ring let go of page i - 1 before they take page i, so at most 4
    streamed pages live at once."""
    from concurrent.futures import ThreadPoolExecutor

    from xgboost_tpu_torch.data import binned as binned_mod
    from xgboost_tpu_torch.tree.paged import _PageKernels

    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=0, XTPU_PAGE_RING=3)
    X, y = _data(31, nan=0.0)
    tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
        tmp_path / "lead")), max_bin=64)
    paged = tq.binned(64, CPU)
    depth = paged.ring_depth
    starts = list(range(0, ROWS, PAGE))
    started = {s: threading.Event() for s in starts}
    live, alive_at_ask = [], []
    fetch = paged._fetch

    def counted(s, slot, device, raw=None):
        started[s].set()
        out = fetch(s, slot, device, raw)
        live.append(weakref.ref(out[1][1]))
        return out

    class Asked(ThreadPoolExecutor):
        """Counts the live pages as each upload is asked for (on the
        pass's thread)."""

        def submit(self, fn, *args, **kwargs):
            alive_at_ask.append(sum(r() is not None for r in live))
            return super().submit(fn, *args, **kwargs)

    monkeypatch.setattr(paged, "_fetch", counted)
    monkeypatch.setattr(binned_mod, "ThreadPoolExecutor", Asked)
    lead = []

    def body(carry, page, s, e, uploaded):
        i = s // PAGE
        if i + depth < len(starts):
            lead.append(started[starts[i + depth]].wait(timeout=10))
        return carry + int(uploaded)

    assert depth == 3
    assert _PageKernels._drive(paged, CPU, body, 0) == len(starts)
    assert lead == [True] * (len(starts) - depth)
    assert len(alive_at_ask) == len(starts)
    assert 1 <= min(alive_at_ask[depth:]) and max(alive_at_ask) <= depth


def test_collapse_fires_within_the_budget_only(tmp_path, monkeypatch):
    """Under a budget that holds the whole matrix the paged matrix
    collapses to a resident one (the pages' cache dropped) and trains the
    bytes of the same bins built resident (an iterator without
    ``cache_prefix``); under a smaller budget, or with
    ``XTPU_PAGED_COLLAPSE=0``, it stays paged."""
    X, y = _data(40)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
              "device": "cpu"}
    _set(monkeypatch, XTPU_PAGE_CACHE_BYTES=4 << 30)
    monkeypatch.delenv("XTPU_PAGED_COLLAPSE")
    resident = xt.QuantileDMatrix(PortIter(X, y, 5), max_bin=64)
    assert not resident.is_paged
    want = bytes(xt.train(params, resident, 3,
                          verbose_eval=False).save_raw("ubj"))
    for budget, collapse, expect in ((4 << 30, None, True),
                                     (ROWS * 7 - 1, None, False),
                                     (4 << 30, "0", False)):
        monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", str(budget))
        if collapse is None:
            monkeypatch.delenv("XTPU_PAGED_COLLAPSE", raising=False)
        else:
            monkeypatch.setenv("XTPU_PAGED_COLLAPSE", collapse)
        tq = xt.QuantileDMatrix(PortIter(X, y, 5, cache_prefix=str(
            tmp_path / f"c{budget}{collapse}")), max_bin=64)
        bst = xt.train(params, tq, 3, verbose_eval=False)
        paged = tq.binned(64, CPU)
        st = bst._caches[id(tq)]
        assert isinstance(st["binned"], BinnedMatrix) == expect
        assert (paged._resident is not None) == expect
        if expect:
            assert paged.cached_pages(CPU) == 0
            assert bytes(bst.save_raw("ubj")) == want
        else:
            assert st["binned"] is paged


@pytest.mark.parametrize("params,item", [
    # the JAX package's refusal of the two-level names on paged lossguide
    ({"hist_method": "mega", "grow_policy": "lossguide", "max_leaves": 4},
     "resident matrices only"),
    # the JAX package's permanent refusal (core.py:856-858)
    ({"data_split_mode": "col", "mesh": xt.make_data_mesh(
        devices=["cpu"] * 2)}, "data_split_mode=row only"),
])
def test_unported_paged_configurations_raise(params, item, tmp_path,
                                             monkeypatch):
    _set(monkeypatch)
    X, y = _data(50, n=1000)
    tq = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / "u")), max_bin=16)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        xt.train(dict({"objective": "binary:logistic", "max_bin": 16,
                       "device": "cpu"}, **params), tq, 1,
                 verbose_eval=False)


def test_paged_sub_suffix_is_dropped(tmp_path, monkeypatch):
    """``"<kernel>+sub"`` on a paged matrix builds every node of a page
    pass, as the JAX package's paged tier does (it drops the suffix):
    ``auto+sub`` saves ``auto``'s bytes."""
    _set(monkeypatch)
    X, y = _data(53, n=1000)
    raws = []
    for m in ("auto", "auto+sub"):
        tq = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
            tmp_path / m.replace("+", "_"))), max_bin=16)
        b = xt.train({"objective": "binary:logistic", "max_bin": 16,
                      "device": "cpu", "hist_method": m}, tq, 2,
                     verbose_eval=False)
        assert tq.binned(16, CPU).is_paged
        b.set_param({"hist_method": "auto"})
        raws.append(bytes(b.save_raw("ubj")))
    assert raws[0] == raws[1]


def test_unported_paged_methods_raise(tmp_path, monkeypatch):
    """The paged mesh tier's layout is the JAX package's (its training:
    ``tests/test_torch_paged_mesh.py``); a paged matrix trains only at
    its own max_bin."""
    _set(monkeypatch)
    X, y = _data(51, n=1000)
    tq = xt.QuantileDMatrix(PortIter(X, y, 2, cache_prefix=str(
        tmp_path / "m")), max_bin=16)
    paged = tq.binned(16, CPU)
    jpaged = JaxPaged(bins_host=paged.bins_host, cuts=None,
                      max_nbins=paged.max_nbins, page_rows=paged.page_rows)
    for world in (1, 2, 3, 8):
        assert paged.mesh_layout(world) == jpaged.mesh_layout(world)
    with pytest.raises(ValueError, match="max_bin=16"):
        xt.train({"objective": "binary:logistic", "max_bin": 32,
                   "device": "cpu"}, tq, 1, verbose_eval=False)


def test_multi_output_tree_raises_on_resident_data():
    """``multi_strategy='multi_output_tree'`` over a one-column label on a
    resident matrix grows scalar trees, the JAX package's (a vector leaf
    needs K > 1 outputs); and without a card, training that does not ask for the CPU raises."""
    X, y = _data(52, n=200)
    p = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
         "base_score": 0.5, "multi_strategy": "multi_output_tree"}
    jb = xgb.train(dict(p, hist_method="prehot"), xgb.DMatrix(X, label=y),
                   2, verbose_eval=False)
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 2,
                  verbose_eval=False)
    assert tb.gbm.trees[0].leaf_value.ndim == 1
    assert compare_forests(jb.gbm.trees, tb.gbm.trees, 0.3)[0] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            xt.train({"objective": "binary:logistic",
                      "multi_strategy": "multi_output_tree"},
                     xt.DMatrix(X, label=y), 1)
