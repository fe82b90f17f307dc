"""The federated communicator and its wire codec.

The counterparts of the JAX package's ``tests/test_federated.py`` (all 8
cases, under ``importorskip("grpc")``): a ``run_federated_server`` on
port 0 (the OS picks it, so files running side by side never race for
a port) and N ``FederatedCommunicator`` parties on threads; the
collectives must give ``InMemoryCommunicator``'s results. Then the
restricted codec (``parallel/wire.py``): round trips, the JAX package's
bytes for the same objects, and ``WireError`` on hostile bytes (too
deep, a length past the end, an unknown tag, an object array); the
resilient gathers' CRC over the wire encoding; and the label rank's
broadcast (``apply_with_labels``), which never unpickles.
"""

import pickle
import threading

import numpy as np
import pytest

from xgboost_tpu_torch.parallel import collective, wire
from xgboost_tpu_torch.parallel.collective import InMemoryCommunicator


def _run_world(world_size, fn):
    pytest.importorskip("grpc")
    from xgboost_tpu_torch.parallel.federated import (FederatedCommunicator,
                                                      run_federated_server)

    server = run_federated_server(world_size, port=0)
    results = [None] * world_size
    errors = []

    def worker(rank):
        comm = FederatedCommunicator(f"localhost:{server.port}",
                                     world_size, rank, timeout=30.0)
        try:
            results[rank] = fn(comm, rank)
        except Exception as e:  # surfaced below
            errors.append(e)
        finally:
            comm.close()

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    server.stop(0)
    if errors:
        raise errors[0]
    return results


def test_allreduce_ops():
    def fn(comm, rank):
        s = comm.allreduce(np.asarray([rank + 1.0, 2.0]), op="sum")
        m = comm.allreduce(np.asarray([rank]), op="max")
        mn = comm.allreduce(np.asarray([rank]), op="min")
        o = comm.allreduce(np.asarray([1 << rank], np.int64),
                           op="bitwise_or")
        return s, m, mn, o

    for s, m, mn, o in _run_world(3, fn):
        np.testing.assert_array_equal(s, [6.0, 6.0])
        assert m[0] == 2 and mn[0] == 0 and o[0] == 7


def test_allgather_and_broadcast():
    def fn(comm, rank):
        gathered = comm.allgather_objects({"rank": rank, "data": [rank] * 2})
        root_obj = comm.broadcast("hello" if rank == 0 else None, root=0)
        return gathered, root_obj

    for gathered, root_obj in _run_world(4, fn):
        assert [g["rank"] for g in gathered] == [0, 1, 2, 3]
        assert root_obj == "hello"


def test_distributed_sketch_over_federated():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4000, 5)).astype(np.float32)
    shards = np.array_split(X, 4)

    from xgboost_tpu_torch.data.quantile import sketch_matrix

    global_cuts = sketch_matrix(X, 32)
    for cuts in _run_world(4, lambda comm, rank: collective.distributed_sketch(
            shards[rank], 32, comm=comm)):
        assert cuts.n_features == 5
        for f in range(5):
            a = cuts.values[cuts.ptrs[f]:cuts.ptrs[f + 1]]
            b = global_cuts.values[global_cuts.ptrs[f]:
                                   global_cuts.ptrs[f + 1]]
            assert abs(len(a) - len(b)) <= 2
            np.testing.assert_allclose(
                np.quantile(a, [0.25, 0.5, 0.75]),
                np.quantile(b, [0.25, 0.5, 0.75]), atol=0.2)


def test_apply_with_labels_label_privacy():
    """Only rank 0 holds labels; every rank receives the label-derived
    result (reference ``collective::ApplyWithLabels``)."""
    def fn(comm, rank):
        return collective.apply_with_labels(
            lambda: {"grad": np.arange(4.0)} if rank == 0 else None,
            comm=comm, label_rank=0)

    for out in _run_world(3, fn):
        np.testing.assert_array_equal(out["grad"], np.arange(4.0))


def test_init_by_name():
    pytest.importorskip("grpc")
    from xgboost_tpu_torch.parallel.federated import run_federated_server

    server = run_federated_server(1, port=0)
    collective.init(communicator="federated",
                    federated_server_address=f"localhost:{server.port}",
                    federated_world_size=1, federated_rank=0)
    try:
        assert collective.get_world_size() == 1
        assert not collective.is_distributed()
        assert collective.get_communicator().allgather_objects(7) == [7]
    finally:
        collective.finalize()
        server.stop(0)


def test_rank_validation():
    pytest.importorskip("grpc")
    from xgboost_tpu_torch.parallel.federated import FederatedCommunicator

    with pytest.raises(ValueError):
        FederatedCommunicator("localhost:1", world_size=2, rank=5)


def test_rendezvous_timeout_rolls_back_state():
    """A timed-out waiter's contribution is rolled back, so a retried
    collective on the same sequence number completes."""
    from xgboost_tpu_torch.parallel.federated import _Rendezvous

    rv = _Rendezvous(2)
    with pytest.raises(TimeoutError):
        rv.exchange(0, 0, "lost", timeout=0.05)
    assert 0 not in rv.rounds and 0 not in rv.waiting and 0 not in rv.done
    results = {}

    def w(rank):
        results[rank] = rv.exchange(rank, 0, f"p{rank}", timeout=10.0)

    threads = [threading.Thread(target=w, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert results[0] == ["p0", "p1"] and results[1] == ["p0", "p1"]


def test_rendezvous_rejects_duplicate_rank():
    from xgboost_tpu_torch.parallel.federated import _Rendezvous

    rv = _Rendezvous(2)
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault(0, rv.exchange(0, 7, "x", 10.0)))
    t.start()
    for _ in range(200):            # until rank 0 waits in the round
        with rv.lock:
            if rv.waiting.get(7, 0) == 1:
                break
        threading.Event().wait(0.01)
    with pytest.raises(RuntimeError, match="duplicate"):
        rv.exchange(0, 7, "again", timeout=1.0)
    rv.exchange(1, 7, "y", timeout=10.0)
    t.join(10)
    assert out[0] == ["x", "y"]


def test_federated_module_needs_no_grpc_to_import():
    """grpc is imported where a server or a party starts, so the module
    (and the package) import without it."""
    import xgboost_tpu_torch.parallel.federated as fed

    assert "grpc" not in fed.__dict__


# ---- the wire codec -----------------------------------------------------

OBJECTS = [
    None, True, False, 0, -7, 2 ** 63 - 1, -(2 ** 63), 2 ** 70, -(2 ** 80),
    1.5, float("inf"), "", "héllo", b"", b"\x00\xff",
    np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((0, 4), np.int64),
    np.asarray(3.0), np.asarray([True, False]),
    np.arange(4, dtype=">i4"), [1, [2, [3]]], (1, "a", None), {},
    {"gain": np.ones(3, np.float32), 7: (1, 2), "nested": {"x": [b"y"]}},
]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_wire_round_trip(obj):
    back = wire.decode(wire.encode(obj))
    if isinstance(obj, np.ndarray):
        assert back.dtype == obj.dtype and back.shape == obj.shape
        np.testing.assert_array_equal(back, obj)
    elif isinstance(obj, dict) and "gain" in obj:
        assert back.keys() == obj.keys()
        np.testing.assert_array_equal(back["gain"], obj["gain"])
        assert back[7] == (1, 2) and back["nested"] == {"x": [b"y"]}
    else:
        assert back == obj and type(back) is type(obj)


def test_wire_is_the_jax_packages_format():
    """The same bytes as the JAX package's codec, so the parties of the
    two packages read each other."""
    from xgboost_tpu.parallel import wire as jwire

    for obj in OBJECTS:
        assert wire.encode(obj) == jwire.encode(obj)


@pytest.mark.parametrize("buf,words", [
    (b"l" + (1).to_bytes(4, "little") * 0 + b"", "truncated"),
    (b"s" + (1000).to_bytes(4, "little") + b"abc", "truncated"),
    (b"Z", "unknown tag"),
    (b"N" + b"junk", "trailing bytes"),
    (b"l\x01\x00\x00\x00" * 70 + b"N", "too deep"),
    (b"a" + (3).to_bytes(4, "little") + b"|O8" + (1).to_bytes(4, "little")
     + (1).to_bytes(4, "little") + (8).to_bytes(4, "little") + b"\0" * 8,
     "object-dtype"),
    (b"a" + (3).to_bytes(4, "little") + b"<f4" + (1).to_bytes(4, "little")
     + (5).to_bytes(4, "little") + (4).to_bytes(4, "little") + b"\0" * 4,
     "byte count"),
])
def test_wire_refuses_hostile_bytes(buf, words):
    with pytest.raises(wire.WireError, match=words):
        wire.decode(buf)


@pytest.mark.parametrize("obj", [object(), np.asarray([object()]),
                                 {1, 2}, [1, lambda: 0]])
def test_wire_refuses_to_encode_rich_objects(obj):
    with pytest.raises(wire.WireError):
        wire.encode(obj)


def test_wire_never_builds_a_pickled_object():
    """A pickle's bytes are no wire payload: the decoder refuses them
    rather than running their reduce."""
    class Boom:
        def __reduce__(self):
            return (exec, ("raise SystemExit('ran')",))

    with pytest.raises(wire.WireError):
        wire.decode(pickle.dumps(Boom()))


def test_resilient_gather_crc_is_over_the_wire_encoding(monkeypatch):
    """The resilient allgather's CRC is the wire encoding's: a payload the
    transport flips is caught; an object the codec refuses goes without
    one; nothing is pickled."""
    import zlib

    from xgboost_tpu_torch.parallel import resilience
    from xgboost_tpu_torch.parallel.resilience import (CollectiveCorruption,
                                                       ResilientCommunicator)

    seen = []
    real = zlib.crc32
    monkeypatch.setattr(resilience.zlib, "crc32",
                        lambda b, *a: seen.append(bytes(b)) or real(b, *a))
    monkeypatch.setattr(resilience, "pickle", None, raising=False)
    comms = InMemoryCommunicator.make_world(2)
    out = [None, None]

    def run(r, obj):
        out[r] = ResilientCommunicator(comms[r]).allgather_objects(obj)

    payload = {"a": np.arange(3.0)}
    ts = [threading.Thread(target=run, args=(r, payload)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert wire.encode(payload) in seen
    np.testing.assert_array_equal(out[1][0]["a"], np.arange(3.0))

    class Flip(InMemoryCommunicator):
        def allgather_objects(self, obj):
            got = super().allgather_objects(obj)
            h, crc, o = got[1]
            return [got[0], (h, crc, {"a": o["a"] + 1.0})]

    group = InMemoryCommunicator.make_world(2)[0]._group
    errs = []

    def flip(r):
        try:
            ResilientCommunicator(Flip(group, r)).allgather_objects(payload)
        except CollectiveCorruption as e:
            errs.append(e)

    ts = [threading.Thread(target=flip, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert len(errs) == 2

    rich = [None, None]

    def run_rich(r):
        rich[r] = ResilientCommunicator(comms[r]).allgather_objects({1, r})

    ts = [threading.Thread(target=run_rich, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert rich[0] == [{1, 0}, {1, 1}]


def test_apply_with_labels_moves_wire_bytes_only():
    """The label rank's result crosses as wire bytes in one symmetric
    reduction: a result the codec refuses raises on the label rank."""
    comms = InMemoryCommunicator.make_world(3)
    out = [None] * 3

    def run(r):
        out[r] = collective.apply_with_labels(
            lambda: (np.float32(1.5), [("auc", 0.75)]), comm=comms[r])

    ts = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert all(o == (1.5, [("auc", 0.75)]) for o in out)
    with pytest.raises(wire.WireError):
        collective.apply_with_labels(lambda: object(),
                                     comm=_TwoRankView(comms[0]))


class _TwoRankView(collective.Communicator):
    """A rank 0 of a world of 2 that never reaches a reduction."""

    def __init__(self, inner):
        self.inner = inner

    def get_rank(self):
        return 0

    def get_world_size(self):
        return 2

    def allreduce(self, values, op="sum"):   # the encode fails first
        raise AssertionError("reduced a payload the codec refused")
