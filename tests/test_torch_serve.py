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


def test_rollback_unload_and_drain(model):
    raw, X = model
    bst = xt.Booster({"device": "cpu"}, model_file=raw)
    short = bytes(bst[:4].save_raw("json"))
    with _server(raw, max_batch=8) as srv:
        with pytest.raises(UnknownModel, match="no prior version"):
            srv.rollback_model("m")
        srv.swap_model("m", short)
        assert srv.registry.previous("m").version == 1
        assert srv.predict(X[:3]).version == 2
        back = srv.rollback_model("m")
        got = srv.predict(X[:3])
        assert back.version == got.version == 1
        np.testing.assert_allclose(got, bst.predict(xt.DMatrix(X[:3])),
                                   rtol=RTOL)
        # the version counter keeps its high-water mark
        assert srv.swap_model("m", short).version == 3
        h = srv.health_snapshot()
        assert (h["swaps"], h["rollbacks"]) == (2, 1)
        srv.unload_model("m")
        with pytest.raises(UnknownModel):
            srv.predict(X[:3], model="m")
        with pytest.raises(UnknownModel):
            srv.unload_model("m")
        assert srv.metrics_snapshot()["counters"]["evictions"] == 1
    srv = _server(raw, max_batch=64, max_delay_ms=10_000)
    futs = [srv.submit(X[i:i + 2]) for i in range(0, 40, 2)]
    srv.drain()
    assert all(f.done() for f in futs)
    assert srv.health_snapshot()["status"] == "closed"
    from xgboost_tpu_torch.serve import ServerClosed
    with pytest.raises(ServerClosed):
        srv.submit(X[:2])


@pytest.mark.parametrize("max_batch,rows", [(64, 150), (8, 5)])
def test_contribs_against_jax_server(model, max_batch, rows):
    raw, X = model
    jsrv = JaxServer(models={"m": raw}, max_batch=max_batch)
    try:
        want = np.asarray(jsrv.contribs(X[:rows]))
    finally:
        jsrv.close()
    with _server(raw, max_batch=max_batch) as srv:
        srv.warmup_contribs()
        phi = srv.contribs(X[:rows])
        assert phi.shape == want.shape == (rows, X.shape[1] + 1)
        assert (phi.model, phi.version) == ("m", 1)
        np.testing.assert_allclose(phi, want, rtol=1e-6, atol=1e-6)
        bst = xt.Booster({"device": "cpu"}, model_file=raw)
        np.testing.assert_array_equal(
            phi, bst.predict(xt.DMatrix(X[:rows]), pred_contribs=True))
        margin = bst.predict(xt.DMatrix(X[:rows]), output_margin=True)
        np.testing.assert_allclose(phi.sum(axis=1), margin, atol=1e-5)
        snap = srv.metrics_snapshot()
        assert snap["counters"]["contrib_rows"] == rows
        assert snap["stages"]["shap"]["count"] == 1
        with pytest.raises(ValueError, match="feature columns"):
            srv.contribs(X[:2, :3])


def test_contribs_multiclass_shape_and_deadline(model):
    _, X = model
    rng = np.random.RandomState(2)
    y = rng.randint(0, 3, len(X)).astype(np.float32)
    bst = xt.train({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 3, "device": "cpu"},
                   xt.DMatrix(X, label=y), 3, verbose_eval=False)
    raw = bytes(bst.save_raw("json"))
    with _server(raw, max_batch=16, shap_buckets=[1, 4]) as srv:
        phi = srv.contribs(X[:9])
        assert phi.shape == (9, 3, X.shape[1] + 1)
        np.testing.assert_array_equal(
            phi, bst.predict(xt.DMatrix(X[:9]), pred_contribs=True))
        with pytest.raises(DeadlineExceeded):
            srv.contribs(X[:40], timeout_ms=0)


def test_client_retry_against_a_shedding_server(model):
    from xgboost_tpu_torch.parallel.resilience import RetryPolicy
    from xgboost_tpu_torch.serve import ServeClient

    raw, X = model
    with _server(raw, max_batch=64) as srv:
        calls = {"n": 0}
        orig = srv.submit

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] <= 3:
                raise ServerOverloaded("transient")
            return orig(*a, **k)

        srv.submit = flaky
        cli = ServeClient(srv, "m", retry=RetryPolicy(
            max_retries=3, base_delay_s=0.001), retry_seed=7)
        got = cli.predict_many([X[:3], X[3:9]])
        assert calls["n"] == 5
        np.testing.assert_allclose(np.concatenate(got),
                                   srv.predict(X[:9]), rtol=RTOL)
        calls["n"] = -10
        np.testing.assert_array_equal(cli.contribs(X[:2]),
                                      srv.contribs(X[:2]))
        assert cli.metrics()["counters"]["contrib_requests"] == 2
        # the jitter is seeded: two clients of one seed wait alike
        import random
        policy = RetryPolicy()
        a, b = random.Random(7), random.Random(7)
        assert [policy.delay(i, a) for i in range(4)] == \
            [policy.delay(i, b) for i in range(4)]


def test_config_keys_ladders_and_log_line(model, caplog):
    import logging
    import time

    raw, X = model
    with _server(raw, max_batch=48, buckets=[1, 16],
                 shap_max_batch=8, log_every_s=0.01) as srv:
        assert srv.ladder.sizes == (1, 16, 48)     # max_batch on top
        assert srv.shap_ladder.sizes == (1, 2, 4, 8)
        srv.warmup()
        with caplog.at_level(logging.INFO, logger="xgboost_tpu_torch"):
            got = srv.predict(X[:5])               # padded to 16
            time.sleep(0.2)                        # the batcher's ticks
        assert srv.metrics_snapshot()["bucket_hits"] == {"16": 1}
    with _server(raw) as plain:
        np.testing.assert_allclose(got, plain.predict(X[:5]), rtol=RTOL)
    assert "serve: req=1 rows=5 batches=1" in caplog.text
    assert "queue_rows=0 models=1" in caplog.text
