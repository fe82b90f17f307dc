"""The port's span tracer, Monitor and memory monitor (``obs/``), against
their contracts and the JAX package's, on the CPU.

The counterparts of the JAX package's ``tests/test_obs.py`` trace and
memory cases (``:53-236``):

- the disabled span and memory hooks allocate nothing;
- nesting and args, the ring keeping the newest spans, the Perfetto
  and jsonl round trips;
- traced training saves the untraced model's bytes (depthwise and
  lossguide), and the Monitor's sections are the JAX package's;
- ``sync`` passes through unless armed, and an armed ``sync`` of a CPU
  tensor returns it;
- the paged tier's ``paged/*`` spans: one ``paged/hist`` a (round,
  level) in depth order with ``paged/exchange``, ``paged/eval`` and
  ``paged/fetch`` beside them, their order the JAX package's on the
  same run, on one device and on a mesh of 4 shards;
- the memory monitor's bookings on the CPU (the page cache, the margin
  cache) and its registry families under the JAX package's names.
"""

import gc
import json
import tracemalloc

import numpy as np
import pytest
import torch

import jax

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.obs import trace as jtr
from xgboost_tpu_torch.context import Mesh
from xgboost_tpu_torch.obs import memory as mem
from xgboost_tpu_torch.obs import metrics as om
from xgboost_tpu_torch.obs import trace as tr
from xgboost_tpu_torch.obs.monitor import Monitor

from test_data_iterator import BatchIter
from test_torch_paged import PortIter


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    tr.set_sync(False)
    tr.disable()
    jtr.set_sync(False)
    jtr.disable()
    mem.disable()


def _data(n=2000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _train(X, y, **params):
    p = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
         "device": "cpu"}
    p.update(params)
    return xt.train(p, xt.DMatrix(X, label=y), 3, verbose_eval=False)


def _grown(flt, calls, attempts=3):
    """The allocations of ``calls()`` attributed to the files of ``flt``,
    under tracemalloc; a few attempts forgive one-shot noise (a
    background thread of an earlier test touching a hook once)."""
    for _ in range(attempts):
        tracemalloc.start()
        try:
            gc.collect()
            base = tracemalloc.take_snapshot().filter_traces([flt])
            calls()
            after = tracemalloc.take_snapshot().filter_traces([flt])
        finally:
            tracemalloc.stop()
        grown = [d for d in after.compare_to(base, "lineno")
                 if d.size_diff > 0]
        if not grown:
            return []
    return grown


def test_disabled_span_is_shared_and_allocation_free():
    tr.disable()
    assert tr.span("round") is tr.span("paged/hist", "train")

    def calls():
        for _ in range(1000):
            with tr.span("paged/hist"):
                pass
            tr.instant("collective/retry")
            tr.sync(None)

    calls()     # warm past the interpreter's lazy per-code caches
    grown = _grown(tracemalloc.Filter(True, tr.__file__), calls)
    assert not grown, [str(d) for d in grown]


def test_disabled_memory_hooks_are_allocation_free():
    mem.disable()
    assert not mem.enabled()

    def calls():
        for _ in range(1000):
            mem.sample("round")
            mem.book("carry/margin", 4096)
            mem.unbook("carry/margin")
            mem.note_round()
            mem.watch_device(None)

    calls()
    grown = _grown(tracemalloc.Filter(True, mem.__file__), calls)
    assert not grown, [str(d) for d in grown]


def test_enabled_spans_record_nesting_and_args():
    t = tr.enable(capacity=128)
    with tr.span("outer", "cat", {"k": 1}):
        with tr.span("inner"):
            pass
    by_name = {s.name: s for s in t.spans()}
    assert by_name["outer"].depth == 0 and by_name["inner"].depth == 1
    assert by_name["outer"].args == {"k": 1}
    assert by_name["inner"].t0 >= by_name["outer"].t0
    assert by_name["inner"].t1 <= by_name["outer"].t1


def test_ring_keeps_newest_and_counts_dropped():
    t = tr.enable(capacity=8)
    for i in range(20):
        with t.span(f"s{i}"):
            pass
    assert len(t) == 8 and t.dropped == 12
    assert [s.name for s in t.spans()] == [f"s{i}" for i in range(12, 20)]


def test_perfetto_and_jsonl_roundtrip(tmp_path):
    t = tr.enable(capacity=64)
    t.set_identity(1, 4)
    with tr.span("a", "train"):
        with tr.span("b"):
            pass
    path = tmp_path / "trace.json"
    assert t.dump(str(path)) == 2
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(evs) == {"a", "b"}
    assert evs["b"]["ts"] >= evs["a"]["ts"]
    assert (evs["b"]["ts"] + evs["b"]["dur"]
            <= evs["a"]["ts"] + evs["a"]["dur"] + 1e-3)
    assert evs["a"]["cat"] == "train" and evs["a"]["args"]["rank"] == 1
    jpath = tmp_path / "trace.jsonl"
    assert tr.export(str(jpath)) == 2
    lines = [json.loads(ln) for ln in jpath.read_text().splitlines()]
    assert {ln["name"] for ln in lines} == {"a", "b"}
    assert {ln["depth"] for ln in lines} == {0, 1}
    assert {ln["world"] for ln in lines} == {4}


def test_spans_name_the_profiler_timeline():
    """A live span opens a ``torch.profiler.record_function`` of its
    name, so the stage shows on a ``torch.profiler`` trace."""
    tr.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("paged/hist"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "paged/hist" in names


def test_traced_training_is_byte_identical():
    X, y = _data()
    tr.disable()
    plain = bytes(_train(X, y).save_raw("ubj"))
    lg_plain = bytes(_train(X, y, max_depth=6, grow_policy="lossguide",
                            max_leaves=12).save_raw("ubj"))
    tr.enable()
    tr.set_sync(True)
    traced = bytes(_train(X, y).save_raw("ubj"))
    lg_traced = bytes(_train(X, y, max_depth=6, grow_policy="lossguide",
                             max_leaves=12).save_raw("ubj"))
    assert traced == plain and lg_traced == lg_plain
    names = {s.name for s in tr.tracer().spans()}
    assert {"Booster.GetGradient", "Booster.BoostOneIter",
            "Booster.UpdateCache", "lossguide/eval", "lossguide/apply",
            "lossguide/fetch"} <= names


def test_monitor_sections_are_the_jax_packages(capsys):
    """The round's Monitor sections and their counts are the JAX
    package's on its general round (a custom objective takes it off the
    fused one), and the table prints at verbosity 3."""
    X, y = _data(n=1000)

    def fobj(margin, dm):
        p = 1.0 / (1.0 + np.exp(-margin))
        return p - y, p * (1.0 - p)

    p = {"objective": "binary:logistic", "max_depth": 3}
    jb = xgb.train(p, xgb.DMatrix(X, label=y), 4, obj=fobj,
                   verbose_eval=False)
    tb = xt.train(dict(p, device="cpu"), xt.DMatrix(X, label=y), 4,
                  obj=fobj, verbose_eval=False)
    assert tb._monitor.counts == jb._monitor.counts == {
        "GetGradient": 4, "BoostOneIter": 4, "UpdateCache": 4}
    capsys.readouterr()
    with xt.config_context(verbosity=3):
        tb._monitor.maybe_print()
    out = capsys.readouterr().out
    assert "Monitor (Booster)" in out and "BoostOneIter" in out


def test_monitor_sync_waits_only_when_asked():
    m = Monitor("m", sync=True)
    with m.section("s") as sec:
        x = torch.ones(4)
        sec.sync_on(x)          # a CPU tensor: ready, no wait
    assert m.counts == {"s": 1} and m.totals["s"] >= 0.0
    m2 = Monitor("m")
    with m2.timed("s"):
        pass
    assert "s: " in m2.report()


def test_sync_mode_blocks_only_when_armed():
    x = torch.arange(8.0)
    tr.disable()
    assert tr.sync(x) is x
    tr.enable()
    assert tr.sync(x) is x
    tr.set_sync(True)
    assert tr.sync(x) is x and tr.sync((x, [x], {"k": x})) is not None


def _paged_pair(tmp_path, monkeypatch, X, y, tag):
    monkeypatch.setenv("XTPU_PAGE_ROWS", "700")
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", "0")
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    it = BatchIter(X, y, n_batches=3)
    it.cache_prefix = str(tmp_path / f"j{tag}")
    jq = xgb.QuantileDMatrix(it, max_bin=64)
    tq = xt.QuantileDMatrix(PortIter(X, y, 3, cache_prefix=str(
        tmp_path / f"t{tag}")), max_bin=64)
    return jq, tq


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device", "mesh"])
def test_paged_spans_follow_the_jax_packages(mesh, tmp_path, monkeypatch):
    """A streamed paged run whose every level splits: one ``paged/hist``
    a (round, level) in depth order, and the ordered ``paged/*`` names
    the JAX package's on the same run (on its 4-device CPU mesh, or on
    one device)."""
    if mesh and len(jax.devices()) < 4:
        pytest.skip("needs the CPU mesh of tests/conftest.py")
    X, y = _data(n=2100)
    jq, tq = _paged_pair(tmp_path, monkeypatch, X, y, str(mesh))
    depth, rounds = 3, 2
    p = {"objective": "binary:logistic", "max_depth": depth,
         "max_bin": 64}
    jp, tp = dict(p, hist_method="prehot"), dict(p, device="cpu")
    if mesh:
        jp["mesh"], tp["mesh"] = xgb.make_data_mesh(4), Mesh(["cpu"] * 4)
    jt = jtr.enable()
    jb = xgb.train(jp, jq, rounds, verbose_eval=False)
    jtr.disable()
    tt = tr.enable()
    tb = xt.train(tp, tq, rounds, verbose_eval=False)
    for t in tb.gbm.trees:          # every level split
        assert int(np.asarray(t.is_leaf).sum()) == 2 ** depth
    assert len(jb.gbm.trees) == len(tb.gbm.trees) == rounds

    def paged(spans):
        return [s.name for s in spans if s.name.startswith("paged/")]

    hist = [s for s in tt.spans() if s.name == "paged/hist"]
    assert [s.args["depth"] for s in hist] == list(range(depth)) * rounds
    assert {"paged/exchange", "paged/eval", "paged/fetch"} <= set(
        paged(tt.spans()))
    assert paged(tt.spans()) == paged(jt.spans())


def test_memory_monitor_books_on_the_cpu(tmp_path, monkeypatch):
    """Without a CUDA device the monitor counts bookings: the page cache
    as pages join it, the margin cache at each round; its families reach
    the registry under the JAX package's names, and leave with it."""
    m = mem.enable()
    X, y = _data(n=2100)
    monkeypatch.setenv("XTPU_PAGE_ROWS", "700")
    monkeypatch.setenv("XTPU_PAGED_COLLAPSE", "0")
    monkeypatch.setenv("XTPU_PAGE_CACHE_BYTES", str(2 * 700 * 10))
    tq = xt.QuantileDMatrix(PortIter(X, y, 3, cache_prefix=str(
        tmp_path / "m")), max_bin=64)
    xt.train({"objective": "binary:logistic", "max_depth": 3,
              "max_bin": 64, "device": "cpu"}, tq, 3, verbose_eval=False)
    snap = m.snapshot()
    assert snap["source"] == "booked" and snap["rounds"] == 3
    assert snap["bookings"]["page_cache"] == 2 * 700 * 10
    assert snap["bookings"]["carry/margin"] == 2100 * 4
    assert snap["hbm_peak_bytes_per_round"] == 2 * 700 * 10 + 2100 * 4
    assert m.peak_per_round() == snap["hbm_peak_bytes_per_round"]
    text = om.get_registry().render_prometheus()
    for name in ("xtpu_hbm_bytes_in_use", "xtpu_hbm_peak_bytes"):
        assert name in text
    tq.binned(64, torch.device("cpu")).set_cache_budget(0)
    assert "page_cache" not in m.snapshot()["bookings"]
    mem.disable()
    assert "xtpu_hbm_peak_bytes" not in om.get_registry().render_prometheus()
