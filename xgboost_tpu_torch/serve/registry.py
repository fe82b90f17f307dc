"""Multi-model registry: load once, pin on the device, route by name.

A :class:`ServedModel` is the device-resident form of a Booster: its
forest is packed and uploaded ONCE at load, the objective's transform
and base margin are resolved up front, and the padded-batch margin
entry point works on bucketed device tensors. A forest that cannot be
packed is refused with ``PackError``: on the card the packed walk is
the only walk, so there is no slow path to fall back to.

The :class:`ModelRegistry` maps ``name -> ServedModel`` under a lock
with ATOMIC replacement: a hot swap fully constructs (and the server
warms) the incoming model before the one dict assignment that makes it
visible. In-flight batches keep serving the ServedModel they resolved.

Model sources: an in-process ``Booster``, a path to a model file (JSON
/ UBJ, native or reference schema), or raw model ``bytes``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .errors import ModelLoadError, UnknownModel
from .packed import PackError


def _load_booster(source):
    from ..core import Booster

    if isinstance(source, Booster):
        return source
    try:
        # parse on the host; the server pins the packed forest itself
        return Booster(params={"device": "cpu"}, model_file=source)
    except Exception as e:
        # typed so a swap can roll back: a corrupted or truncated source
        # must never evict the live version
        raise ModelLoadError(
            f"cannot load model from {type(source).__name__} source: "
            f"{e}") from e


class ServedModel:
    """A Booster prepared for the serving hot path on ``device``."""

    def __init__(self, name: str, booster, device: torch.device,
                 version: int = 1) -> None:
        self.name = name
        self.version = int(version)
        self.booster = booster
        self.device = device
        self.n_groups = int(booster.n_groups)
        base = np.broadcast_to(np.asarray(booster._base_np(), np.float32),
                               (self.n_groups,))
        self.base = torch.tensor(base, device=device)
        self.n_features = int(booster.num_features())
        self._obj = booster.obj
        self.packed = booster.packed_forest()
        if self.packed is None:
            raise PackError(f"model '{name}' has no trees to serve")
        self.packed.device_arrays(device)        # pin now, not per batch
        # the walk reads X[row, feature]: refuse batches narrower than this
        self.min_columns = max(self.n_features, self.packed.max_feature + 1)

    def key(self) -> str:
        return f"{self.name}@v{self.version}"

    def margin_padded(self, X_dev: torch.Tensor) -> torch.Tensor:
        """Margin [R, n_groups] of a bucket-padded device batch. Rows are
        independent through the whole walk, so pad rows never influence
        real rows."""
        if X_dev.shape[1] < self.min_columns:
            raise ValueError(
                f"model {self.key()} needs {self.min_columns} feature "
                f"columns, the batch has {X_dev.shape[1]}")
        return self.packed.margin(X_dev, self.base)

    def transform(self, margin: torch.Tensor) -> torch.Tensor:
        """Objective prediction transform — elementwise, so it commutes
        with row slicing."""
        return self._obj.pred_transform(margin)

    def warm_batch(self, n_rows: int) -> np.ndarray:
        """An all-zeros batch of this model's feature width."""
        if self.n_features <= 0:
            raise ValueError(
                f"model {self.key()} has unknown feature count; pass "
                "n_features= to warmup()")
        return np.zeros((n_rows, self.n_features), np.float32)


class ModelRegistry:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._lock = threading.RLock()
        self._models: Dict[str, ServedModel] = {}
        self._versions: Dict[str, int] = {}

    def _build(self, name: str, source, version: int) -> ServedModel:
        booster = _load_booster(source)
        try:
            return ServedModel(name, booster, self.device, version=version)
        except Exception as e:
            raise ModelLoadError(
                f"model '{name}' loaded but failed to prepare for serving: "
                f"{e}") from e

    def _next_version(self, name: str, version: Optional[int]) -> int:
        with self._lock:
            return (int(version) if version is not None
                    else self._versions.get(name, 0) + 1)

    def load(self, name: str, source, *,
             version: Optional[int] = None) -> ServedModel:
        """Construct and publish a model; refuses to shadow an existing
        name (use :meth:`prepare` + :meth:`publish`)."""
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model '{name}' is already served; use swap")
        sm = self._build(name, source, self._next_version(name, version))
        return self.publish(sm)

    def prepare(self, name: str, source,
                version: Optional[int] = None) -> ServedModel:
        """Build a ServedModel WITHOUT publishing it (the server warms it
        first, then calls :meth:`publish` — the atomic half of a swap)."""
        return self._build(name, source, self._next_version(name, version))

    def publish(self, sm: ServedModel) -> ServedModel:
        with self._lock:
            self._models[sm.name] = sm  # one assignment = the atomic swap
            self._versions[sm.name] = max(
                self._versions.get(sm.name, 0), sm.version)
        return sm

    def get(self, name: Optional[str] = None) -> ServedModel:
        with self._lock:
            if name is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                raise UnknownModel(
                    "model name required: "
                    f"{len(self._models)} models are served "
                    f"({sorted(self._models)})")
            sm = self._models.get(name)
            if sm is None:
                raise UnknownModel(f"no served model named '{name}'")
            return sm

    def models(self) -> List[ServedModel]:
        with self._lock:
            return list(self._models.values())

    def describe(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{"name": m.name, "version": m.version,
                     "n_features": m.n_features, "n_groups": m.n_groups,
                     "n_trees": m.packed.n_trees}
                    for m in self._models.values()]
