"""The port's Server on the CPU: answers, admission, deadlines, drain,
routing — and agreement with port Booster.predict and JAX Server."""

import threading

import numpy as np
import pytest

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.serve import Server as JaxServer
from xgboost_tpu_torch.serve import (DeadlineExceeded, ModelLoadError,
                                     Server, ServerOverloaded, UnknownModel)

# Server and Booster.predict walk the same rows in batches of other sizes;
# on the CPU the plain walk's matmul need not sum in one order across
# batch sizes (on the card the kernel fixes the order and the two agree
# bit for bit, which chip_smoke.py checks).
RTOL = 1e-6


@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(31)
    X = rng.randn(400, 7).astype(np.float32)
    X[rng.rand(400, 7) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 1]) - np.nan_to_num(X[:, 4]) > 0
         ).astype(np.float32)
    bst = xgb.train({"objective": "binary:logistic", "max_depth": 4,
                     "eta": 0.3}, xgb.DMatrix(X, label=y), 12,
                    verbose_eval=False)
    return bytes(bst.save_raw("json")), X


def _server(raw, **kw):
    return Server(models={"m": raw}, device="cpu", **kw)


def test_answers_agree_with_booster_and_jax_server(model):
    raw, X = model
    oracle = xt.Booster({"device": "cpu"}, model_file=raw).predict(
        xt.DMatrix(X))
    sizes = [1, 7, 64, 150]
    results = {}

    with _server(raw, max_batch=64) as srv:
        def client(tid):
            for k, n in enumerate(sizes):
                lo = (tid * 37 + k * 53) % (X.shape[0] - n)
                results[(tid, k)] = (lo, n, srv.predict(X[lo:lo + n]))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = srv.metrics_snapshot()
    assert len(results) == 16
    for lo, n, got in results.values():
        assert got.shape == (n,) and got.model == "m" and got.version == 1
        np.testing.assert_allclose(got, oracle[lo:lo + n], rtol=RTOL)
    assert snap["counters"]["requests"] == 16
    assert snap["buckets"] == [1, 2, 4, 8, 16, 32, 64]
    assert "compute" in snap["stages"] and "e2e" in snap["stages"]

    jsrv = JaxServer(models={"m": raw}, max_batch=64)
    try:
        want = np.asarray(jsrv.predict(X[:150]))
    finally:
        jsrv.close()
    with _server(raw, max_batch=64) as srv:
        np.testing.assert_allclose(srv.predict(X[:150]), want,
                                   rtol=1e-6, atol=1e-6)
        margin = srv.predict(X[:5], output="margin")
    np.testing.assert_allclose(
        margin, xt.Booster({"device": "cpu"}, model_file=raw).predict(
            xt.DMatrix(X[:5]), output_margin=True), rtol=RTOL)


def test_overload_sheds(model):
    raw, X = model
    srv = _server(raw, max_batch=64, max_delay_ms=10_000,
                  max_queue_rows=15)
    try:
        first = srv.submit(X[:10])
        with pytest.raises(ServerOverloaded):
            srv.submit(X[:10])
        assert srv.health_snapshot()["sheds"] == 1
    finally:
        srv.close(drain=True)
    assert first.result().shape == (10,)


def test_deadline_exceeded(model):
    raw, X = model
    with _server(raw, max_batch=64, max_delay_ms=300) as srv:
        fut = srv.submit(X[:3], timeout_ms=1)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert srv.health_snapshot()["deadline_exceeded"] == 1


def test_close_drains_every_future(model):
    raw, X = model
    srv = _server(raw, max_batch=64, max_delay_ms=10_000)
    futs = [srv.submit(X[i:i + 3]) for i in range(0, 60, 3)]
    srv.close(drain=True)
    assert all(f.done() for f in futs)
    assert [f.result().shape for f in futs] == [(3,)] * 20
    assert srv.health_snapshot()["status"] == "closed"


def test_unknown_model_and_bad_requests(model):
    raw, X = model
    with _server(raw, max_batch=8) as srv:
        with pytest.raises(UnknownModel):
            srv.predict(X[:2], model="nope")
        with pytest.raises(ValueError, match="feature columns"):
            srv.predict(X[:2, :3])
        with pytest.raises(ValueError, match="output"):
            srv.submit(X[:2], output="proba")
        srv.load_model("n", raw)
        with pytest.raises(UnknownModel, match="model name required"):
            srv.predict(X[:2])
        np.testing.assert_array_equal(srv.predict(X[:2], model="n"),
                                      srv.predict(X[:2], model="m"))
        with pytest.raises(ModelLoadError):
            srv.load_model("bad", b"{not a model")


def test_swap_publishes_a_new_version(model):
    raw, X = model
    with _server(raw, max_batch=8) as srv:
        srv.warmup()
        sm = srv.swap_model("m", raw)
        got = srv.predict(X[:4])
        assert sm.version == 2 and got.version == 2
        assert srv.health_snapshot()["swaps"] == 1
        assert srv.metrics_snapshot()["models"][0]["version"] == 2
