"""Serving's ``RecompileCounter`` (ROADMAP A.9) and the per-bucket walk
graphs it counts, on the CPU, against the JAX package's serving.

On the card a ``Server`` captures each (model version, bucket)'s walk and
transform as a CUDA graph at warmup and replays it per batch
(``serve/registry.py``); on the CPU the same entries run eagerly and a
bucket's first batch counts as its preparation. ``RecompileCounter``
has the JAX package's interface (``register``, ``compiles``, ``mark``,
``absorb``, ``since_mark``, ``for_forest_predictor``); ``compiles`` is
the captures made, which a warmed server keeps flat: every answer of
every ladder size with ``recompiles_after_warmup == 0``, a swap's planned
captures absorbed, a bucket first seen after warmup counted. The series
and snapshot keys are the JAX ``Server``'s.
"""

import numpy as np
import pytest

import xgboost_tpu_torch as xt
from xgboost_tpu.serve import Server as JaxServer
from xgboost_tpu.serve.buckets import RecompileCounter as JaxCounter
from xgboost_tpu_torch.serve import (FleetConfig, FleetRouter,
                                     RecompileCounter, ServeConfig, Server)

# the CPU's walk sums a row's trees in its batch's order; on the card the
# kernel's fixed order makes the answers Booster.predict's bit for bit
# (chip_smoke.py), here they agree to f32 rounding (test_torch_serve.py)
RTOL = 1e-6


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(30)
    X = rng.randn(600, 5).astype(np.float32)
    X[rng.rand(600, 5) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 3]) > 0).astype(
        np.float32)
    p = {"objective": "binary:logistic", "max_depth": 3, "device": "cpu"}
    a = xt.train(p, xt.DMatrix(X, label=y), 4)
    b = xt.train(dict(p, eta=0.5), xt.DMatrix(X, label=y), 6)
    return bytes(a.save_raw("json")), bytes(b.save_raw("json")), a, b, X


class _Source:
    def __init__(self):
        self.n = 0

    def cache_size(self):
        return self.n


def test_counter_mark_absorb_since_mark():
    src = _Source()
    c = RecompileCounter([src])
    assert c.compiles() == 0 and c.since_mark() == 0
    src.n = 3
    c.mark()
    assert c.since_mark() == 0
    src.n = 5
    assert c.since_mark() == 2
    c.absorb(2)
    assert c.since_mark() == 0
    src.n = 4                     # never below the mark
    assert c.since_mark() == 0
    with pytest.raises(TypeError, match="cache_size"):
        c.register(object())
    # the JAX package's interface, name for name
    for name in ("register", "compiles", "mark", "absorb", "since_mark",
                 "for_forest_predictor"):
        assert callable(getattr(JaxCounter, name))
        assert callable(getattr(RecompileCounter, name))


def test_warmed_server_answers_every_bucket_with_no_recompile(models):
    raw, _, bst, _, X = models
    srv = Server(models={"m": raw}, device="cpu", max_batch=64)
    try:
        srv.warmup()
        sizes = srv.ladder.sizes
        sm = srv.registry.get("m")
        # one preparation a bucket, made by the warmup
        assert srv.recompile_counter.compiles() == len(sizes)
        assert sm.graphs.cache_size() == len(sizes)
        want = bst.predict(xt.DMatrix(X))
        for n in (1, 2, 3, 5, 8, 13, 31, 64, 100, 200):
            got = srv.predict(X[:n])
            np.testing.assert_allclose(got, want[:n], rtol=RTOL)
        assert srv.recompiles_after_warmup == 0
        snap = srv.metrics_snapshot()
        assert snap["recompiles_after_warmup"] == 0
        assert srv.recompile_counter.compiles() == len(sizes)
    finally:
        srv.close()


def test_swap_is_absorbed_and_graphs_are_freed(models):
    raw, raw2, bst, bst2, X = models
    srv = Server(models={"m": raw}, device="cpu", max_batch=16)
    try:
        srv.warmup()
        n_b = len(srv.ladder.sizes)
        v1 = srv.registry.get("m")
        srv.swap_model("m", raw2)
        v2 = srv.registry.get("m")
        # the swap's captures are planned work
        assert srv.recompile_counter.compiles() == 2 * n_b
        assert srv.recompiles_after_warmup == 0
        np.testing.assert_allclose(srv.predict(X[:9]),
                                   bst2.predict(xt.DMatrix(X[:9])),
                                   rtol=RTOL)
        # the displaced version keeps its graphs for an instant rollback;
        # the one rolled back from loses its
        assert v1.graphs.cache_size() == n_b
        srv.rollback_model("m")
        assert v2.graphs.cache_size() == 0
        np.testing.assert_allclose(srv.predict(X[:9]),
                                   bst.predict(xt.DMatrix(X[:9])),
                                   rtol=RTOL)
        assert srv.recompiles_after_warmup == 0
        srv.unload_model("m")
        assert v1.graphs.cache_size() == 0
    finally:
        srv.close()


def test_a_staged_batch_outlives_its_graphs(models):
    """A batch staged into a bucket's buffer is answered from that
    buffer even when a rollback frees the version's graphs between the
    copy and the replay (the batcher resolved the version first)."""
    raw, _, bst, _, X = models
    srv = Server(models={"m": raw}, device="cpu", max_batch=16)
    try:
        sm = srv.registry.get("m")
        Xp = srv.ladder.pad(X[:5], 8)
        ent = sm.stage_bucket(srv._pinned(Xp, srv._staging))
        sm.free_graphs()
        assert sm.graphs.cache_size() == 0
        _, value = sm.run_bucket(ent)
        np.testing.assert_allclose(value.numpy()[:5, 0],
                                   bst.predict(xt.DMatrix(X[:5])),
                                   rtol=RTOL)
    finally:
        srv.close()


def test_unplanned_preparations_count(models):
    """A model loaded without its warmup and a contribs bucket first
    seen after warmup are recompiles after warmup; ``warmup_contribs``
    prepares the contribs ladder on purpose."""
    raw, raw2, _, _, X = models
    srv = Server(models={"m": raw}, device="cpu", max_batch=16)
    try:
        srv.warmup()
        srv.load_model("late", raw2, warm=False)
        srv.predict(X[:3], model="late")
        assert srv.recompiles_after_warmup == 1
        srv.contribs(X[:2], model="m")
        assert srv.recompiles_after_warmup == 2
        n = srv.warmup_contribs("m")
        assert n == len(srv.shap_ladder.sizes)
        assert srv.recompiles_after_warmup == 2
        srv.contribs(X[:5], model="m")
        assert srv.recompiles_after_warmup == 2
    finally:
        srv.close()


def test_series_and_snapshot_keys_equal_jax(models):
    """The recompile gauge and counter series, and the snapshot's
    ``recompiles_after_warmup`` key, as the JAX ``Server`` exposes them."""
    raw, _, _, _, X = models
    ours = Server(models={"m": raw}, device="cpu", max_batch=8,
                  log_every_s=1e-9)
    theirs = JaxServer(models={"m": raw}, max_batch=8)
    try:
        for s in (ours, theirs):
            s.warmup()
            s.predict(X[:3])
        ours._maybe_log()
        assert set(ours.metrics_snapshot()) == set(theirs.metrics_snapshot())
        assert ours.metrics_snapshot()["counters"]["recompiles"] == 0
        names = {f.name for f in ours._collect_obs()}
        jnames = {f.name for f in theirs._collect_obs()}
        assert names == jnames
        assert "xtpu_serve_recompiles_after_warmup" in names
        mnames = {f.name for f in ours.metrics._collect_obs()}
        assert "xtpu_serve_recompiles_total" in mnames
        assert mnames == {f.name for f in theirs.metrics._collect_obs()}
    finally:
        ours.close()
        theirs.close()


def test_fleet_swap_and_placement_keep_zero(models):
    raw, raw2, _, bst2, X = models
    fl = FleetRouter(models={"m": raw}, device="cpu",
                     config=FleetConfig(replicas=2, replication=2,
                                        serve=ServeConfig(max_batch=8)))
    try:
        fl.warmup()
        fl.swap_model("m", raw2)
        assert fl.recompiles_after_warmup == 0
        np.testing.assert_allclose(fl.predict(X[:5]),
                                   bst2.predict(xt.DMatrix(X[:5])),
                                   rtol=RTOL)
        fl.add_replica()
        fl.predict(X[:7])
        assert fl.recompiles_after_warmup == 0
        assert fl.metrics_snapshot()["recompiles_after_warmup"] == 0
    finally:
        fl.close()
