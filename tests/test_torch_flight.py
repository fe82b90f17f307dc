"""The port's flight recorder (``xgboost_tpu_torch/obs/flight.py``) and
``python -m xgboost_tpu_torch.obs`` against the JAX package's: the
overlap arithmetic gives the same floats bit for bit, merged rings the
same JSON, a bundle written by either package passes the other's
``verify_bundle``, and the CLI's exit codes are the same."""

import io
import json
import os
import subprocess
import sys
import threading
import time
import types
import zlib

import numpy as np
import pytest

from xgboost_tpu.obs import flight as jflight
from xgboost_tpu_torch.obs import flight, memory, trace
from xgboost_tpu_torch.obs.flight import (RING_KIND, RING_VERSION, BlackBox,
                                          BundleCorrupt, FlightRecorder,
                                          covered_seconds, hidden_fraction,
                                          interval_union, load_ring,
                                          merge_rings, render_postmortem,
                                          sync_clocks, verify_bundle)
from xgboost_tpu_torch.parallel.collective import InMemoryCommunicator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    yield
    trace.disable()


def _thread_world(world, body):
    """``body(rank, comm)`` on a thread a rank over the port's
    ``InMemoryCommunicator`` -> the results by rank."""
    comms = InMemoryCommunicator.make_world(world)
    out, errs = [None] * world, []

    def run(r):
        try:
            out[r] = body(r, comms[r])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append((r, e))

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs, errs
    return out


def _span(name, t0, t1, tid=0, **kw):
    d = {"name": name, "cat": "", "t0": t0, "t1": t1, "dur": t1 - t0,
         "depth": 0, "tid": tid}
    d.update(kw)
    return d


def _ring(rank, world, spans, offset=0.0):
    return {"kind": RING_KIND, "version": RING_VERSION, "rank": rank,
            "world": world,
            "clock": {"offset_s": offset, "err_s": 0.0, "pings": 1},
            "epoch": 0.0, "dropped": 0, "spans": spans}


def _intervals(rng, n):
    a = rng.rand(n) * 10
    return [(float(x), float(x + d)) for x, d in zip(a, rng.rand(n) * 2 - 0.2)]


# ---------------------------------------------------------- overlap arithmetic

@pytest.mark.parametrize("seed", range(6))
def test_hidden_fraction_is_the_jax_packages_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    cases = [(0.0, 0.0), (-1.0, 0.5)] + [
        (float(t), float(e)) for t, e in zip(rng.rand(50) * 3,
                                             rng.rand(50) * 3.5)]
    for total, exposed in cases:
        ours = hidden_fraction(total, exposed)
        theirs = jflight.hidden_fraction(total, exposed)
        assert (ours is None and theirs is None) or \
            (ours == theirs and type(ours) is type(theirs))


@pytest.mark.parametrize("seed", range(3))
def test_interval_union_and_covered_seconds_equal_jax(seed):
    rng = np.random.RandomState(100 + seed)
    covers, targets = _intervals(rng, 40), _intervals(rng, 25)
    assert interval_union(covers) == jflight.interval_union(covers)
    assert covered_seconds(targets, covers) == \
        jflight.covered_seconds(targets, covers)
    u = interval_union(covers)
    assert all(a < b for a, b in u)
    assert all(u[i][1] < u[i + 1][0] for i in range(len(u) - 1))


def test_streaming_overlap_goes_through_hidden_fraction(monkeypatch):
    from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

    calls = []

    def spy(total, exposed):
        calls.append((total, exposed))
        return 0.25

    monkeypatch.setattr(flight, "hidden_fraction", spy)
    fake = types.SimpleNamespace(ring_stats={"upload_s": 2.0,
                                             "blocked_s": 1.5})
    assert PagedBinnedMatrix.streaming_overlap(fake) == 0.25
    assert calls == [(2.0, 1.5)]
    monkeypatch.undo()
    assert PagedBinnedMatrix.streaming_overlap(fake) == \
        jflight.hidden_fraction(2.0, 1.5)
    fake.ring_stats["upload_s"] = 0.0
    assert PagedBinnedMatrix.streaming_overlap(fake) is None


# -------------------------------------------------------------------- merging

@pytest.mark.parametrize("align", [True, False])
def test_merge_rings_gives_the_jax_packages_json(align):
    rng = np.random.RandomState(7)
    rings = []
    for r in range(WORLD):
        t = np.cumsum(rng.rand(12)) + r * 0.01
        spans = [_span(f"stage/{i % 3}", float(a), float(a + 0.05),
                       tid=i % 2, cat="train" if i % 2 else "",
                       args={"i": i})
                 for i, a in enumerate(t)]
        rings.append(_ring(r, WORLD, spans, offset=float(rng.rand() * 0.1)))
    ours = merge_rings(rings, align=align)
    theirs = jflight.merge_rings(rings, align=align)
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert merge_rings([]) == jflight.merge_rings([])


def test_sync_clocks_on_a_four_thread_world():
    clocks = _thread_world(WORLD, lambda r, c: sync_clocks(c, pings=8))
    assert clocks[0].offset_s == 0.0
    for c in clocks:
        # one host clock: every offset is within its own uncertainty
        assert c.pings == 8 and c.err_s >= 0.0
        assert abs(c.offset_s) <= c.err_s + 1e-3
    one = sync_clocks(InMemoryCommunicator.make_world(1)[0])
    assert (one.offset_s, one.err_s, one.pings) == (0.0, 0.0, 0)


def test_recorder_rings_merge_into_one_track_a_rank(tmp_path):
    def body(rank, comm):
        rec = FlightRecorder(comm=comm,
                             tracer=trace.Tracer(1024,
                                                 annotate_device=False))
        clk = rec.sync_clocks(pings=4)
        for i in range(3):
            with rec.span("hist/build", "train", {"i": i}):
                time.sleep(0.001)
        path = os.path.join(str(tmp_path), f"ring_{rank}.json")
        assert rec.export_ring(path) == 3
        return path, clk

    paths = [p for p, _ in _thread_world(WORLD, body)]
    for r, p in enumerate(paths):
        doc = jflight.load_ring(p)           # the JAX package reads it
        assert doc["rank"] == r and doc["world"] == WORLD
        assert all(s["rank"] == r for s in doc["spans"])
    merged = merge_rings(paths)
    assert json.dumps(merged, sort_keys=True) == \
        json.dumps(jflight.merge_rings(paths), sort_keys=True)
    xs = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == set(range(WORLD))
    assert all(e["ts"] >= 0.0 for e in xs)
    with pytest.raises(ValueError, match="not an xtpuflight ring"):
        load_ring({"kind": "other"})


# ---------------------------------------------------------------- black box

def _write(pkg_flight, directory, reason):
    box = pkg_flight.BlackBox(str(directory), rank=1, world=4)
    try:
        raise ValueError("synthetic crash")
    except ValueError as e:
        return box.write(reason, exc=e, extra={"epoch": 3})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_bundle_passes_the_other_packages_verify(writer, tmp_path):
    trace.enable(capacity=256)
    with trace.span("round/update"):
        pass
    src, dst = (flight, jflight) if writer == "port" else (jflight, flight)
    path = _write(src, tmp_path, f"{writer}-crash")
    assert path is not None and os.path.exists(path + ".crc")
    for verify in (dst.verify_bundle, src.verify_bundle):
        doc = verify(path)
        assert doc["reason"] == f"{writer}-crash"
        assert (doc["rank"], doc["world"]) == (1, 4)
        assert doc["exception"]["type"] == "ValueError"
        assert doc["extra"] == {"epoch": 3}
    for render in (render_postmortem, jflight.render_postmortem):
        buf = io.StringIO()
        render(path, file=buf)
        assert f"{writer}-crash" in buf.getvalue()
        assert "rank 1/4" in buf.getvalue()


@pytest.mark.parametrize("damage", ["flip", "truncate", "no_sidecar",
                                    "kind"])
def test_corruption_is_caught(damage, tmp_path):
    path = BlackBox(str(tmp_path)).write("ok")
    if damage == "flip":
        with open(path, "r+b") as fh:
            fh.seek(10)
            fh.write(b"X")
    elif damage == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
    elif damage == "no_sidecar":
        os.remove(path + ".crc")
    else:
        payload = b'{"kind": "something-else"}'
        with open(path, "wb") as fh:
            fh.write(payload)
        with open(path + ".crc", "w") as fh:
            fh.write(f"{zlib.crc32(payload):08x} {len(payload)}\n")
    with pytest.raises(BundleCorrupt):
        verify_bundle(path)
    with pytest.raises(jflight.BundleCorrupt):
        jflight.verify_bundle(path)


def test_bundle_carries_memory_and_the_built_kernels(tmp_path, monkeypatch):
    from xgboost_tpu_torch.ops.cuda import build

    def no_build(name):
        raise AssertionError(f"a postmortem started a build of {name}")

    monkeypatch.setattr(build, "_start", no_build)
    mon = memory.enable()
    try:
        mon.book("carry/margin", 4096)
        doc = verify_bundle(BlackBox(str(tmp_path)).write("mem"))
    finally:
        memory.disable()
    assert doc["memory"]["live_bytes"] == 4096
    assert doc["memory"]["source"] == "booked"
    want = {n: str(build._host_target(n[5:]) if n.startswith("host:")
                   else build._target(n)) for n in build.loaded()}
    assert doc["programs"] == want
    # the CPU with no monitor records no memory section
    assert verify_bundle(BlackBox(str(tmp_path)).write("bare"))[
        "memory"] is None


def test_arm_excepthook_writes_a_bundle_then_chains(tmp_path):
    seen = []
    prev, threading_prev = sys.excepthook, threading.excepthook
    flight.sys.excepthook = lambda *a: seen.append(a)
    threading.excepthook = lambda a: seen.append(a)
    try:
        box = flight.arm(directory=str(tmp_path), rank=1, world=4)
        assert flight.armed() is box
        assert flight.arm(directory="elsewhere") is box
        try:
            raise RuntimeError("boom")
        except RuntimeError as e:
            sys.excepthook(RuntimeError, e, e.__traceback__)
        doc = jflight.verify_bundle(box.last_bundle)
        assert doc["reason"] == "unhandled-exception"
        assert "boom" in doc["exception"]["message"]
        assert len(seen) == 1                      # chained

        class HookArgs:
            exc_type, thread = RuntimeError, threading.current_thread()
            exc_value = RuntimeError("worker boom")
            exc_traceback = None

        threading.excepthook(HookArgs())
        doc2 = verify_bundle(box.last_bundle)
        assert doc2["reason"].startswith("unhandled-thread-exception:")
        assert len(seen) == 2
        assert flight.write_postmortem("direct") is not None
    finally:
        flight.disarm()
        sys.excepthook, threading.excepthook = prev, threading_prev
    assert flight.armed() is None
    assert flight.write_postmortem("after-disarm") is None


# ----------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run([sys.executable, "-m", "xgboost_tpu_torch.obs",
                           *args], capture_output=True, text=True,
                          cwd=REPO, timeout=120)


@pytest.mark.parametrize("case", ["postmortem", "corrupt", "merge"])
def test_obs_cli_exit_codes(case, tmp_path):
    if case == "merge":
        rings = []
        for r in range(2):
            p = os.path.join(str(tmp_path), f"r{r}.json")
            with open(p, "w") as fh:
                json.dump(_ring(r, 2, [_span("a", 1.0, 2.0)]), fh)
            rings.append(p)
        out = os.path.join(str(tmp_path), "merged.json")
        res = _cli("merge", *rings, "-o", out)
        assert res.returncode == 0, res.stderr
        assert "2 rank tracks" in res.stdout
        with open(out) as fh:
            assert json.load(fh) == jflight.merge_rings(rings)
        return
    good = BlackBox(str(tmp_path)).write("cli-check")
    if case == "corrupt":
        with open(good, "r+b") as fh:
            fh.write(b"Z")
    res = _cli("postmortem", good)
    if case == "postmortem":
        assert res.returncode == 0, res.stderr
        assert "cli-check" in res.stdout
    else:
        assert res.returncode == 1 and "CORRUPT" in res.stderr
