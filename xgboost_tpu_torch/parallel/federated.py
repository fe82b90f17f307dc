"""Federated-learning communicator over gRPC (the port of the JAX
package's ``parallel/federated.py``; its wire is that package's).

Analogue of the reference's federated plugin (``plugin/federated/
federated_server.cc:41`` gRPC server, ``federated_client.h:20`` client
channel, ``federated_communicator.h:18`` communicator adapter, and the
Python launcher ``python-package/xgboost/federated.py:6``): isolated
parties that cannot share raw data train one model by exchanging only
aggregates through a coordinating server.

No .proto codegen: the single ``Exchange`` RPC moves opaque bytes via
grpc's generic method handlers. The wire format is the restricted codec in
``wire.py`` — ``(rank, seq, payload)`` up, payload list down — NOT pickle:
federated parties are mutually distrusting, and the decoder must never be
able to construct arbitrary objects from a malicious peer's bytes (the
reference uses protobuf for the same reason). The
collective semantics mirror ``InMemoryCommunicator``: every round is an
allgather rendezvous keyed by a client-side sequence number; allreduce
reduces the gathered parts locally, exactly how the reference's federated
server evaluates Allreduce handlers server-side but with the reduction at
the edges so the server stays payload-agnostic.

Optional mTLS mirrors the reference's ``--ssl`` deployment: pass PEM blobs
to ``run_federated_server``/``FederatedCommunicator``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from . import wire
from .collective import Communicator, _reduce_stacked

# the JAX package's service name: a party of either package can join the
# other's server
_SERVICE = "xgboost_tpu.federated.Federated"
_METHOD = "Exchange"


def _identity(b: bytes) -> bytes:
    return b


def _grpc():
    """The ``grpc`` module, imported where a server or a party starts, so
    that the rest of the package runs without it."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the federated communicator needs the grpc package (grpcio), "
            "which is not installed") from e
    return grpc


class _Rendezvous:
    """Per-sequence barrier: collect world_size payloads, release them all."""

    def __init__(self, world_size: int) -> None:
        self.world_size = world_size
        self.lock = threading.Condition()
        self.rounds: Dict[int, List[Any]] = {}
        self.arrived: Dict[int, set] = {}
        self.done: Dict[int, List[Any]] = {}
        self.waiting: Dict[int, int] = {}

    def exchange(self, rank: int, seq: int, payload: Any,
                 timeout: float) -> List[Any]:
        with self.lock:
            if seq in self.done:
                raise RuntimeError(
                    f"stale arrival rank={rank} for completed seq={seq}")
            slot = self.rounds.setdefault(seq, [None] * self.world_size)
            arrived = self.arrived.setdefault(seq, set())
            if rank in arrived:
                raise RuntimeError(f"duplicate arrival rank={rank} seq={seq}")
            arrived.add(rank)
            slot[rank] = payload
            self.waiting[seq] = self.waiting.get(seq, 0) + 1
            if self.waiting[seq] == self.world_size:
                self.done[seq] = slot
                del self.rounds[seq]
                del self.arrived[seq]
                self.lock.notify_all()
            else:
                deadline = (threading.TIMEOUT_MAX if timeout is None
                            else timeout)
                if not self.lock.wait_for(lambda: seq in self.done,
                                          timeout=deadline):
                    # roll back this waiter's contribution so a retried
                    # collective (or a late peer) doesn't see corrupt state
                    missing = self.world_size - self.waiting.get(seq, 0)
                    if seq in self.rounds:
                        self.rounds[seq][rank] = None
                        self.arrived[seq].discard(rank)
                        self.waiting[seq] -= 1
                        if self.waiting[seq] == 0:
                            del self.rounds[seq]
                            del self.arrived[seq]
                            del self.waiting[seq]
                    raise TimeoutError(
                        f"federated exchange seq={seq} timed out waiting for "
                        f"{missing} workers")
            out = self.done[seq]
            self.waiting[seq] -= 1
            if self.waiting[seq] == 0:  # last reader frees the round
                del self.done[seq]
                del self.waiting[seq]
            return out


class FederatedServer:
    """Coordinating server (reference ``federated_server.cc``): accepts
    ``world_size`` parties and serves synchronized exchange rounds."""

    def __init__(self, world_size: int, port: int = 0,
                 server_key: Optional[bytes] = None,
                 server_cert: Optional[bytes] = None,
                 client_cert: Optional[bytes] = None,
                 timeout: float = 300.0) -> None:
        grpc = _grpc()
        from concurrent import futures

        self._rendezvous = _Rendezvous(world_size)
        self._timeout = timeout

        def exchange(request: bytes, context) -> bytes:
            rank, seq, payload = wire.decode(request)
            if not (isinstance(rank, int) and isinstance(seq, int)
                    and 0 <= rank < world_size and seq >= 0):
                raise wire.WireError(f"bad header rank={rank!r} seq={seq!r}")
            out = self._rendezvous.exchange(rank, seq, payload, self._timeout)
            return wire.encode(out)

        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {_METHOD: grpc.unary_unary_rpc_method_handler(
                exchange, request_deserializer=_identity,
                response_serializer=_identity)})
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max(world_size * 2, 8)),
            options=[("grpc.max_receive_message_length", -1),
                     ("grpc.max_send_message_length", -1)])
        self._server.add_generic_rpc_handlers((handler,))
        if server_key is not None and server_cert is not None:
            creds = grpc.ssl_server_credentials(
                [(server_key, server_cert)],
                root_certificates=client_cert,
                require_client_auth=client_cert is not None)
            self.port = self._server.add_secure_port(f"[::]:{port}", creds)
        else:
            self.port = self._server.add_insecure_port(f"[::]:{port}")
        self._server.start()

    def stop(self, grace: Optional[float] = None) -> None:
        self._server.stop(grace)

    def wait(self) -> None:
        self._server.wait_for_termination()


def run_federated_server(world_size: int, port: int = 0, **kwargs: Any
                         ) -> FederatedServer:
    """Launcher (reference ``python-package/xgboost/federated.py:6``)."""
    return FederatedServer(world_size, port, **kwargs)


class FederatedCommunicator(Communicator):
    """Party-side communicator (reference ``federated_communicator.h:18``):
    every collective is one synchronized Exchange round with the server."""

    def __init__(self, server_address: str, world_size: int, rank: int,
                 client_key: Optional[bytes] = None,
                 client_cert: Optional[bytes] = None,
                 server_cert: Optional[bytes] = None,
                 timeout: float = 300.0) -> None:
        grpc = _grpc()

        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self._rank = rank
        self._world = world_size
        self._seq = 0
        self._timeout = timeout
        options = [("grpc.max_receive_message_length", -1),
                   ("grpc.max_send_message_length", -1)]
        if server_cert is not None:
            creds = grpc.ssl_channel_credentials(
                root_certificates=server_cert, private_key=client_key,
                certificate_chain=client_cert)
            self._channel = grpc.secure_channel(server_address, creds,
                                                options=options)
        else:
            self._channel = grpc.insecure_channel(server_address,
                                                  options=options)
        self._call = self._channel.unary_unary(
            f"/{_SERVICE}/{_METHOD}", request_serializer=_identity,
            response_deserializer=_identity)

    def close(self) -> None:
        self._channel.close()

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world

    def _exchange(self, payload: Any) -> List[Any]:
        seq = self._seq
        self._seq += 1
        request = wire.encode((self._rank, seq, payload))
        return wire.decode(self._call(request, timeout=self._timeout))

    def allgather_objects(self, obj: Any) -> List[Any]:
        return self._exchange(obj)

    def allreduce(self, values: np.ndarray, op: str = "sum") -> np.ndarray:
        return _reduce_stacked([np.asarray(p) for p in
                                self._exchange(np.asarray(values))], op)
