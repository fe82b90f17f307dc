"""Tracker: the rendezvous endpoint every worker is handed.

Reference counterpart: ``RabitTracker`` (``python-package/xgboost/
tracker.py:178``), the TCP process that accepts workers, assigns ranks
and hands out ``DMLC_TRACKER_URI/PORT``. The port's rendezvous is
``torch.distributed``'s: rank 0 hosts the TCP store of a
``MASTER_ADDR`` / ``MASTER_PORT`` pair, or every rank meets at a shared
``file://`` path. The tracker picks the endpoint and hands every worker
the same bootstrap arguments (the JAX package's ``Tracker`` over its
coordinator address)::

    tracker = Tracker(n_workers=2)              # on the launching host
    args = tracker.worker_args()                # ship to every worker
    # each worker:
    launch.init_distributed(args["init_method"], args["n_workers"], rank)
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Optional


def get_host_ip(host_ip: Optional[str] = None) -> str:
    """The address workers reach rank 0 at: ``host_ip`` when given, else
    the loopback address (one host; workers on other hosts need the
    launching host's address passed in)."""
    return host_ip or "127.0.0.1"


class Tracker:
    """Rendezvous endpoint factory (reference ``RabitTracker``): a TCP
    endpoint (``host_ip`` and a port the OS hands out when ``port`` is
    0), or, with ``file_path``, a ``file://`` rendezvous on a filesystem
    every worker shares."""

    def __init__(self, n_workers: int, host_ip: Optional[str] = None,
                 port: int = 0, file_path: Optional[str] = None) -> None:
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.file_path = file_path
        self.host_ip = self.port = None
        if file_path is None:
            self.host_ip = get_host_ip(host_ip)
            if port == 0:
                with socket.socket() as s:
                    s.bind((self.host_ip, 0))
                    port = s.getsockname()[1]
            self.port = port

    @property
    def init_method(self) -> str:
        if self.file_path is not None:
            return "file://" + os.path.abspath(self.file_path)
        return f"tcp://{self.host_ip}:{self.port}"

    def worker_args(self) -> Dict[str, Any]:
        """Bootstrap arguments for every worker (reference
        ``worker_envs()``); ``MASTER_ADDR`` / ``MASTER_PORT`` for a TCP
        endpoint, as ``torch.distributed``'s ``env://`` reads them."""
        out: Dict[str, Any] = {"init_method": self.init_method,
                               "n_workers": self.n_workers}
        if self.file_path is None:
            out.update(MASTER_ADDR=self.host_ip, MASTER_PORT=str(self.port))
        return out
