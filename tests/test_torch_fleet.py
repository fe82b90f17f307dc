"""Fleet serving in the port (``serve/fleet.py``), mirroring the JAX
package's ``tests/test_fleet.py``: consistent-hash placement equal to the
JAX ``_HashRing``'s, routing and failover on shed, drain-safe removal
under load with no lost future, two-phase promotion (a build that fails
on one replica publishes nothing), rollback, autoscaling inside its
bounds, replica-labeled metrics and the client's retry."""

import threading
import time

import numpy as np
import pytest

import xgboost_tpu_torch as xt
from xgboost_tpu.serve.fleet import _HashRing as JaxHashRing
from xgboost_tpu_torch.obs.metrics import render_families
from xgboost_tpu_torch.parallel.resilience import RetryPolicy
from xgboost_tpu_torch.serve import (DeadlineExceeded, FleetConfig,
                                     FleetRouter, ModelLoadError,
                                     ServeClient, ServeConfig, Server,
                                     ServerOverloaded, UnknownModel)
from xgboost_tpu_torch.serve.fleet import _HashRing

# on the CPU the plain walk's sums may round differently across batch
# sizes (tests/test_torch_serve.py); chip_smoke.py holds the card bit for
# bit
RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(31)
    X = rng.randn(300, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    return X, y


def _raw(X, y, depth, rounds, eta):
    bst = xt.train({"objective": "binary:logistic", "max_depth": depth,
                    "eta": eta, "device": "cpu"}, xt.DMatrix(X, label=y),
                   rounds, verbose_eval=False)
    return bytes(bst.save_raw("json"))


@pytest.fixture(scope="module")
def raw(data):
    return _raw(*data, depth=4, rounds=6, eta=0.3)


@pytest.fixture(scope="module")
def raw2(data):
    return _raw(*data, depth=3, rounds=4, eta=0.2)


def _oracle(raw, X):
    return xt.Booster({"device": "cpu"}, model_file=raw).predict(
        xt.DMatrix(X))


def _fleet(raw, n=2, replication=2, **cfg):
    fl = FleetRouter(
        models={"m": raw}, device="cpu",
        config=FleetConfig(replicas=n, min_replicas=1, max_replicas=4,
                           replication=replication,
                           serve=ServeConfig(max_batch=64,
                                             max_delay_ms=1.0), **cfg))
    fl.warmup()
    return fl


# ------------------------------------------------------------------- ring

def test_placement_equals_the_jax_ring():
    names = [f"model-{i}" for i in range(100)]
    ours, theirs = _HashRing(), JaxHashRing()
    steps = [("add", f"r{i}") for i in range(5)] + [
        ("remove", "r2"), ("add", "r5"), ("remove", "r0"), ("add", "r6"),
        ("remove", "r4")]
    for op, node in steps:
        getattr(ours, op)(node)
        getattr(theirs, op)(node)
        assert ours.nodes() == theirs.nodes()
        for k in (1, 2, 3):
            assert [ours.place(n, k) for n in names] == \
                [theirs.place(n, k) for n in names], (op, node, k)


def test_hash_ring_determinism_and_churn():
    keys = [f"k{i}" for i in range(200)]
    ring = _HashRing(["a", "b", "c", "d"])
    assert _HashRing(["d", "c", "b", "a"]).place("k1", 2) == \
        ring.place("k1", 2)
    before = {k: ring.place(k, 2) for k in keys}
    assert all(len(set(v)) == 2 for v in before.values())
    ring.add("e")
    moved = sum(before[k] != ring.place(k, 2) for k in keys)
    assert 0 < moved <= len(keys) // 2      # bounded churn, not a rehash
    ring.remove("e")
    assert all(ring.place(k, 2) == before[k] for k in keys)
    assert len(ring.place("x", 10)) == 4


def test_fleet_config_env_knobs(monkeypatch):
    monkeypatch.setenv("XTPU_FLEET_REPLICAS", "3")
    monkeypatch.setenv("XTPU_FLEET_MIN", "2")
    monkeypatch.setenv("XTPU_FLEET_MAX", "5")
    monkeypatch.setenv("XTPU_FLEET_REPLICATION", "1")
    monkeypatch.setenv("XTPU_FLEET_AUTOSCALE_S", "0.5")
    cfg = FleetConfig()
    assert (cfg.replicas, cfg.min_replicas, cfg.max_replicas,
            cfg.replication, cfg.autoscale_interval_s) == (3, 2, 5, 1, 0.5)
    with pytest.raises(ValueError):
        FleetConfig(replicas=0)
    with pytest.raises(ValueError):
        FleetConfig(min_replicas=4, max_replicas=2)
    with pytest.raises(ValueError):
        FleetConfig(replication=0)


# ---------------------------------------------------------------- routing

def test_fleet_predict_and_routing(data, raw):
    X, _ = data
    oracle = _oracle(raw, X)
    fl = _fleet(raw, n=3, replication=2)
    try:
        for n in (1, 7, 64, 300):
            np.testing.assert_allclose(fl.predict(X[:n], "m"), oracle[:n],
                                       rtol=RTOL)
        r = fl.predict(X[:2], "m")
        assert (r.model, r.version) == ("m", 1)
        assert len(fl.placement("m")) == 2
        # the model is served exactly where the ring places it
        placed = set(fl.placement("m"))
        assert {x.replica for x in fl.replicas()
                if fl._serves(x, "m")} == placed
        assert fl.metrics_snapshot()["fleet"]["routed"] >= 5
        with pytest.raises(UnknownModel):
            fl.predict(X[:1], "absent")
        phi = fl.contribs(X[:5], "m")
        assert phi.shape == (5, 7)
    finally:
        fl.close()


def test_fleet_failover_on_shed(data, raw):
    """A shedding replica is skipped; the request lands on its peer."""
    X, _ = data
    fl = _fleet(raw, n=2, replication=2)
    try:
        victim = fl.placement("m")[0]
        srv = dict(zip(fl.replica_names(), fl.replicas()))[victim]

        def shed(*a, **k):
            raise ServerOverloaded("induced")

        srv.submit = shed
        np.testing.assert_allclose(fl.predict(X[:5], "m"),
                                   _oracle(raw, X[:5]), rtol=RTOL)
        snap = fl.metrics_snapshot()["fleet"]
        assert snap["failovers"] >= 1 and snap.get("sheds", 0) == 0
        # every placed replica sheds: the router sheds
        other = [r for r in fl.replicas() if r is not srv][0]
        other.submit = shed
        with pytest.raises(ServerOverloaded):
            fl.predict(X[:5], "m")
        assert fl.metrics_snapshot()["fleet"]["sheds"] == 1
    finally:
        fl.close()


def test_remove_replica_under_load_loses_nothing(data, raw):
    X, _ = data
    oracle = _oracle(raw, X[:16])
    fl = _fleet(raw, n=3, replication=3)
    try:
        victim = fl.placement("m")[0]
        futures = [fl.submit(X[:16], "m") for _ in range(30)]
        t = threading.Thread(
            target=lambda: fl.remove_replica(victim, drain=True))
        t.start()
        futures += [fl.submit(X[:16], "m") for _ in range(30)]
        t.join(timeout=60)
        assert not t.is_alive()
        for f in futures:
            np.testing.assert_allclose(f.result(timeout=30), oracle,
                                       rtol=RTOL)
        assert victim not in fl.replica_names()
        assert fl.health_snapshot()["status"] == "ok"
        with pytest.raises(ValueError, match="last replica"):
            for name in fl.replica_names():
                fl.remove_replica(name)
    finally:
        fl.close()


def test_add_replica_rebalances_and_warms(data, raw):
    X, _ = data
    fl = _fleet(raw, n=2, replication=1)
    try:
        name = fl.add_replica()
        assert name in fl.replica_names() and fl.n_replicas == 3
        placed = set(fl.placement("m"))
        for r in fl.replicas():
            has = any(m["name"] == "m"
                      for m in r.health_snapshot()["models"])
            assert has == (r.replica in placed)
        np.testing.assert_allclose(fl.predict(X[:4], "m"),
                                   _oracle(raw, X[:4]), rtol=RTOL)
    finally:
        fl.close()


# -------------------------------------------------------------- promotion

def test_fleet_swap_and_rollback(data, raw, raw2):
    X, _ = data
    p1, p2 = _oracle(raw, X[:20]), _oracle(raw2, X[:20])
    fl = _fleet(raw, n=3, replication=3)
    try:
        assert fl.served_versions("m") == {1}
        fl.swap_model("m", raw2, warm=True)
        assert fl.served_versions("m") == {2}
        np.testing.assert_allclose(fl.predict(X[:20], "m"), p2, rtol=RTOL)
        assert fl.metrics_snapshot()["fleet"]["promotions"] >= 2
        rb = fl.rollback_model("m")
        assert rb.version == 1 and fl.served_versions("m") == {1}
        np.testing.assert_allclose(fl.predict(X[:20], "m"), p1, rtol=RTOL)
        h = fl.health_snapshot()
        assert h["swaps"] == 3 and h["rollbacks"] == 3
        fl.unload_model("m")
        with pytest.raises(UnknownModel):
            fl.predict(X[:2], "m")
    finally:
        fl.close()


def test_failed_build_on_one_replica_publishes_nothing(data, raw, raw2):
    """Two-phase promotion: a prepare failure on ANY placed replica aborts
    the fan-out before any replica publishes."""
    X, _ = data
    fl = _fleet(raw, n=2, replication=2)
    try:
        second = dict(zip(fl.replica_names(), fl.replicas()))[
            fl.placement("m")[1]]

        def broken(*a, **k):
            raise ModelLoadError("induced build failure")

        second.registry.prepare = broken
        with pytest.raises(ModelLoadError):
            fl.swap_model("m", raw2, warm=True)
        assert fl.served_versions("m") == {1}
        assert all(r.registry.get("m").version == 1 for r in fl.replicas())
        np.testing.assert_allclose(fl.predict(X[:4], "m"),
                                   _oracle(raw, X[:4]), rtol=RTOL)
        with pytest.raises(ModelLoadError):
            fl.swap_model("m", b"{not a model", warm=False)
        assert fl.served_versions("m") == {1}
    finally:
        fl.close()


# -------------------------------------------------------------- autoscale

def test_autoscale_up_down_inside_bounds(data, raw, monkeypatch):
    fl = FleetRouter(
        models={"m": raw}, device="cpu",
        config=FleetConfig(replicas=2, min_replicas=2, max_replicas=3,
                           replication=2, scale_up_queue_rows=4,
                           serve=ServeConfig(max_batch=64,
                                             max_delay_ms=1.0)))
    fl.warmup()
    try:
        srv = fl.replicas()[0]
        monkeypatch.setattr(srv.batcher, "queue_depth_rows", lambda: 99)
        assert fl.autoscale_tick() == "up"
        assert fl.n_replicas == 3
        assert fl.autoscale_tick() is None        # at max_replicas
        assert fl.n_replicas == 3
        monkeypatch.setattr(srv.batcher, "queue_depth_rows", lambda: 0)
        assert fl.autoscale_tick() == "down"      # idle again
        assert fl.n_replicas == 2
        assert fl.autoscale_tick() is None        # at min_replicas
        snap = fl.metrics_snapshot()["fleet"]
        assert snap["scale_up_events"] == 1
        assert snap["scale_down_events"] == 1
        with pytest.raises(ValueError, match="max_replicas"):
            fl.add_replica()
            fl.add_replica()
    finally:
        fl.close()


def test_autoscale_on_the_p99_signal(data, raw, monkeypatch):
    fl = _fleet(raw, n=1, replication=1, p99_slo_ms=5.0)
    try:
        srv = fl.replicas()[0]
        monkeypatch.setattr(srv.metrics, "percentile_ms",
                            lambda stage, p: 50.0)
        assert fl.autoscale_tick() == "up"
        assert fl.n_replicas == 2
    finally:
        fl.close()


# ---------------------------------------------------------------- metrics

def test_replica_labeled_metrics(data, raw):
    X, _ = data
    fl = _fleet(raw, n=2)
    try:
        fl.predict(X[:3], "m")
        fams = fl._collect_obs()
        names = {f.name for f in fams}
        assert {"xtpu_fleet_replicas", "xtpu_fleet_replica_up",
                "xtpu_fleet_routed_total"} <= names
        text = render_families(
            [f for r in fl.replicas() for f in r._collect_obs()]
            + [f for r in fl.replicas() for f in r.metrics._collect_obs()]
            + list(fams))
        assert 'replica="r0"' in text and 'replica="r1"' in text
        assert "xtpu_fleet_replicas 2" in text
    finally:
        fl.close()


def test_health_snapshot_aggregates(data, raw):
    X, _ = data
    fl = _fleet(raw, n=2)
    try:
        fl.predict(X[:3], "m")
        h = fl.health_snapshot()
        assert h["fleet"] is True and h["n_replicas"] == 2
        assert set(h["replicas"]) == set(fl.replica_names())
        assert h["requests"] == sum(
            r["requests"] for r in h["replicas"].values()) == 1
        assert any(m["name"] == "m" for m in h["models"])
    finally:
        fl.close()
    assert fl.health_snapshot()["status"] == "closed"


# ------------------------------------------------------------ client retry

def test_client_retries_shed_until_capacity(data, raw):
    X, _ = data
    srv = Server(models={"m": raw}, device="cpu",
                 config=ServeConfig(max_batch=16, max_delay_ms=1.0,
                                    max_queue_rows=16))
    srv.warmup()
    try:
        fails = {"n": 0}
        orig = srv.submit

        def flaky(*a, **k):
            if fails["n"] < 2:
                fails["n"] += 1
                raise ServerOverloaded("transient")
            return orig(*a, **k)

        srv.submit = flaky
        cli = ServeClient(srv, "m",
                          retry=RetryPolicy(max_retries=3,
                                            base_delay_s=0.001))
        np.testing.assert_allclose(cli.predict(X[:4]), _oracle(raw, X[:4]),
                                   rtol=RTOL)
        assert fails["n"] == 2
    finally:
        srv.close()


def test_client_retry_honors_deadline(data, raw):
    X, _ = data
    srv = Server(models={"m": raw}, device="cpu",
                 config=ServeConfig(max_batch=16))
    try:
        srv.submit = lambda *a, **k: (_ for _ in ()).throw(
            ServerOverloaded("always"))
        cli = ServeClient(srv, "m",
                          retry=RetryPolicy(max_retries=50,
                                            base_delay_s=0.05,
                                            max_delay_s=0.05))
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceeded):
            cli.predict(X[:2], timeout_ms=60)
        assert time.perf_counter() - t0 < 1.0
        with pytest.raises(ServerOverloaded):
            ServeClient(srv, "m").predict(X[:2])    # no policy: fail fast
    finally:
        srv.close()


def test_replica_closed_after_resolve_fails_over(data, raw, monkeypatch):
    """A request that resolved a replica just before a drained removal
    closed it is served by a peer (the JAX package raises ServerClosed
    there)."""
    X, _ = data
    fl = _fleet(raw, n=2, replication=2)
    try:
        victim_name = fl.placement("m")[0]
        victim = dict(zip(fl.replica_names(), fl.replicas()))[victim_name]
        resolve = fl._resolve

        def stale(model):
            name, _ = resolve(model)
            return name, victim          # resolved before the removal

        monkeypatch.setattr(fl, "_resolve", stale)
        fl.remove_replica(victim_name, drain=True)
        np.testing.assert_allclose(fl.predict(X[:6], "m"),
                                   _oracle(raw, X[:6]), rtol=RTOL)
        snap = fl.metrics_snapshot()["fleet"]
        assert snap["failovers"] == 1 and snap.get("sheds", 0) == 0
    finally:
        fl.close()
