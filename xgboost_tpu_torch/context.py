"""Execution context: which device the port runs on.

The PyTorch counterpart of ``xgboost::Context`` (reference
``include/xgboost/context.h:84``). ``device`` accepts ``"cuda"`` (the
default; ``"auto"`` means the same), ``"cuda:<n>"`` and ``"cpu"``, as
XGBoost 2.0 spells them. Every entry point of the port runs on the card
unless the caller asks for the CPU: when no CUDA device is present,
:func:`resolve_device` raises instead of carrying on quietly on the CPU.

The context also holds the seed of the random stream (row and column
sampling): :meth:`Context.raw_seed` and :meth:`Context.make_key` are the
JAX package's (``context.py``), over the threefry of
``utils/random.py``.

Row-split (data-parallel) training runs over a :class:`Mesh`: the
port's counterpart of the JAX package's 1-D ``jax.sharding.Mesh`` on the
``data`` axis (the reference's ``DataSplitMode::kRow`` world), an
ordered tuple of ``torch.device``s, one row shard each. A device may
repeat, so one card (or the CPU) can hold several shards: the torch
counterpart of the JAX tests' forced host device count
(``--xla_force_host_platform_device_count``). A mesh may also carry a
host communicator (``parallel/collective.py``): its reductions then sum
the local shards and go on across the ranks (``parallel/launch.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from .utils import random as xrandom


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` / ``"auto"`` / ``"cuda:<n>"`` / ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` naming the device when CUDA is asked for (or
    left as the default) and no CUDA device is present."""
    spec = str(device).strip().lower()
    if spec == "auto":
        spec = "cuda"
    if spec == "cpu":
        return torch.device("cpu")
    if spec != "cuda" and not (spec.startswith("cuda:")
                               and spec[5:].isdigit()):
        raise ValueError(f"unknown device {device!r}; use 'cuda', "
                         "'cuda:<n>', 'auto' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    dev = torch.device(spec)
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} does not exist: "
            f"{torch.cuda.device_count()} CUDA device(s) present")
    return dev


DATA_AXIS = "data"


class Mesh:
    """A 1-D data mesh: ``devices`` in shard order on the ``data`` axis
    (module docstring). ``comm``: a host communicator whose ranks each
    hold such a mesh (``parallel/launch.py global_data_mesh``), or None
    for one process. Every device is checked as :func:`resolve_device`
    checks it: a CUDA device without a card raises."""

    def __init__(self, devices: Sequence[Any], comm: Any = None) -> None:
        devs = tuple(resolve_device(str(torch.device(d))) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.comm = comm

    @property
    def size(self) -> int:
        """Shards on this process."""
        return len(self.devices)

    @property
    def shape(self):
        return {DATA_AXIS: self.size}

    @property
    def world(self) -> int:
        """Shards over every rank of the communicator."""
        comm = self.comm
        ranks = comm.get_world_size() if comm is not None else 1
        return self.size * ranks

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}"
                + (f", comm={type(self.comm).__name__}" if self.comm
                   is not None else "") + ")")


def make_data_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A 1-D mesh over the ``data`` axis (the JAX package's
    ``make_data_mesh``): ``devices`` as given (a device may repeat), else
    the first ``n_devices`` of every visible CUDA device (all of them by
    default). Raises, as :func:`resolve_device`, when no CUDA device is
    present and none is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_data_mesh() takes the visible CUDA devices, but "
                "torch.cuda.is_available() is False; pass devices=[...] "
                "(e.g. ['cpu'] * 4) to make a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)


@dataclass
class Context:
    """Runtime context of a Booster (reference ``Context``; ``cuda`` here
    plays the role ``tpu`` plays in the JAX package). ``mesh``: the data
    mesh of row-split training, or None (one device)."""

    device: str = "cuda"
    seed: int = 0
    seed_per_iteration: bool = False
    mesh: Optional[Mesh] = field(default=None, repr=False, compare=False)

    def torch_device(self) -> torch.device:
        """The device of the model's state: the mesh's first shard's
        device under a mesh, else ``device``'s."""
        if self.mesh is not None:
            return self.mesh.devices[0]
        return resolve_device(self.device)

    def with_mesh(self, mesh: Optional[Mesh]) -> "Context":
        return Context(device=self.device, seed=self.seed,
                       seed_per_iteration=self.seed_per_iteration,
                       mesh=mesh)

    def world(self) -> int:
        """The data axis' shard count over every rank (1 without a
        mesh)."""
        return 1 if self.mesh is None else self.mesh.world

    def raw_seed(self, iteration: int = 0) -> int:
        """The uint32 seed of round ``iteration``: ``seed``, plus the
        round when ``seed_per_iteration``, modulo 2^32."""
        seed = (self.seed + iteration if self.seed_per_iteration
                else self.seed)
        return seed & 0xFFFFFFFF

    def make_key(self, iteration: int = 0) -> xrandom.Key:
        return xrandom.key(self.raw_seed(iteration))
