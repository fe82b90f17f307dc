"""Multi-model registry: load once, pin on the device, route by name.

A :class:`ServedModel` is the device-resident form of a Booster: its
forest is packed and uploaded ONCE at load, the objective's transform
and base margin are resolved up front, and the padded-batch margin
entry point works on bucketed device tensors. A scalar forest that
cannot be packed is refused with ``PackError``: on the card the packed
walk is its only walk, so there is no slow path to fall back to. A
vector-leaf forest (``multi_output_tree``) has no packed form in either
package; it is stacked once at load and serves through its torch walk
(``boosting/predict.py margin_raw``), as ``Booster.predict`` walks it.

The :class:`ModelRegistry` maps ``name -> ServedModel`` under a lock
with ATOMIC replacement: a hot swap fully constructs (and the server
warms) the incoming model before the one dict assignment that makes it
visible. In-flight batches keep serving the ServedModel they resolved.
The versions a swap displaced stay built (forest on the device), up to
``HISTORY_DEPTH`` a name, so a rollback is one assignment too.

A packed forest also answers SHAP contributions: its per-leaf path
tables (the Booster's, ``ops/shap.py build_shap_pack``) are built on
first use, once, under a lock, and the contribs run as float64 torch
ops on the device.

Each ServedModel captures its walk and transform once per bucket
(:meth:`ServedModel.run_bucket`, ``ops/cuda/graphs.py CapturedLoop``:
on the card a CUDA graph over a static input buffer of the bucket's
shape, K1 and the transform replayed per batch; a vector-leaf forest's
torch walk runs eagerly through the same entry). The registry counts
every capture and every contribs bucket prepared
(:meth:`ModelRegistry.cache_size`, what ``buckets.py RecompileCounter``
reads), and frees a version's graphs when it leaves for good: unloaded,
rolled back from, or pushed out of the rollback history by a swap.

Model sources: an in-process ``Booster``, a path to a model file (JSON
/ UBJ, native or reference schema), or raw model ``bytes``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..boosting.predict import margin_raw, stack_trees
from ..ops.cuda.graphs import CapturedLoop
from ..ops.shap import contribs
from ..tree.multi import is_vector_leaf
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


class _BucketWalk:
    """One bucket's serving program: the walk and the transform over a
    static input buffer [rows, width] (the graph reads it in place)."""

    def __init__(self, sm: "ServedModel", rows: int, width: int) -> None:
        self.sm = sm
        self.x = torch.zeros((rows, width), dtype=torch.float32,
                             device=sm.device)
        self.margin = self.value = None

    def body(self) -> None:
        self.margin = self.sm.margin_padded(self.x)
        self.value = self.sm.transform(self.margin)


class ServedModel:
    """A Booster prepared for the serving hot path on ``device``;
    ``on_prepare`` is called with each capture or contribs bucket it
    prepares (the registry's count)."""

    def __init__(self, name: str, booster, device: torch.device,
                 version: int = 1, on_prepare=None) -> None:
        self.name = name
        self.version = int(version)
        self.booster = booster
        self.device = device
        self.n_groups = int(booster.n_groups)
        base = np.broadcast_to(np.asarray(booster._base_np(), np.float32),
                               (self.n_groups,))
        self.base = torch.tensor(base, device=device)
        self.base_np = np.array(base)
        self.n_features = int(booster.num_features())
        self._obj = booster.obj
        self.packed = self.stacked = None
        gbm = booster.gbm
        if gbm is not None and is_vector_leaf(gbm.trees):
            self.stacked = stack_trees(gbm.trees, gbm.tree_info,
                                       self.n_groups, device)
            self.n_trees = len(gbm.trees)
            max_feature = max(int(t.split_feature.max()) for t in gbm.trees)
        else:
            self.packed = booster.packed_forest()
            if self.packed is None:
                raise PackError(f"model '{name}' has no trees to serve")
            self.packed.device_arrays(device)    # pin now, not per batch
            self.n_trees = self.packed.n_trees
            max_feature = self.packed.max_feature
        # the walk reads X[row, feature]: refuse batches narrower than this
        self.min_columns = max(self.n_features, max_feature + 1)
        self._shap_pack = None
        self._shap_lock = threading.Lock()
        self.graphs = CapturedLoop(f"serve/{self.key()}", device)
        self._shap_buckets: set = set()
        self._on_prepare = on_prepare or (lambda: None)

    def stage_bucket(self, X: torch.Tensor):
        """One bucket-padded batch ``X`` [R, width] (a pinned host buffer
        on the card) copied into its bucket's static input buffer, on the
        current stream -> the bucket's entry for :meth:`run_bucket`. The
        entry holds its buffers and graph even if the model's graphs are
        freed in between (an unload or a rollback racing the batch)."""
        rows, width = X.shape
        ent = self.graphs.entry((rows, width),
                                lambda: _BucketWalk(self, rows, width))
        ent.program.x.copy_(X, non_blocking=True)
        return ent

    def run_bucket(self, ent):
        """(margin, value) [R, n_groups] on the device of the batch staged
        in ``ent`` (:meth:`stage_bucket`): its captured walk and transform
        replayed (captured on first use; a vector-leaf forest's torch walk
        runs eagerly). The results live in the graph's memory until the
        bucket's next batch: read them first."""
        before = self.graphs.captures
        prog = self.graphs.run_entry(ent, 1, capture=self.packed is not None)
        if self.graphs.captures != before:
            self._on_prepare()
        return prog.margin, prog.value

    def free_graphs(self) -> None:
        """Drop every bucket's graph and its memory (the model is gone
        from the registry)."""
        self.graphs.clear()

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
        if self.packed is None:
            return margin_raw(self.stacked, X_dev, self.base)
        return self.packed.margin(X_dev, self.base)

    # ------------------------------------------------------------- contribs
    @property
    def supports_contribs(self) -> bool:
        return self.packed is not None

    def shap_pack(self):
        """The per-leaf path tables for device TreeSHAP, built on first
        use (host work proportional to the leaves) and pinned on the
        device, once, for the model's lifetime."""
        if self._shap_pack is None:
            if self.packed is None:
                raise ModelLoadError(
                    f"model {self.key()} has no packed forest; device "
                    "contribs need the packed walk's scalar trees")
            with self._shap_lock:
                if self._shap_pack is None:
                    pack = self.booster._shap_pack(None)
                    pack.device_arrays(self.device)
                    self._shap_pack = pack
        return self._shap_pack

    def contribs_padded(self, X_dev: torch.Tensor) -> torch.Tensor:
        """SHAP values [R, n_groups, F + 1] f64 of a bucket-padded device
        batch (rows independent, as in the walk); the bias column holds
        the cover-weighted forest mean plus the base score, so every row
        sums to its margin."""
        rows = X_dev.shape[0]
        if rows not in self._shap_buckets:
            self._shap_buckets.add(rows)
            self._on_prepare()
        return contribs(self.shap_pack(), X_dev, self.base_np)

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
    # displaced ServedModels kept a name for rollback — still fully built
    # (forest on the device), so a rollback is as atomic as the swap that
    # displaced them
    HISTORY_DEPTH = 4

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._lock = threading.RLock()
        self._models: Dict[str, ServedModel] = {}
        self._versions: Dict[str, int] = {}
        self._history: Dict[str, List[ServedModel]] = {}
        # preparations made by every model ever served here: walk graphs
        # captured and contribs buckets prepared (never decreases)
        self._prepared = 0
        self._prep_lock = threading.Lock()

    def _count_prepare(self) -> None:
        with self._prep_lock:
            self._prepared += 1

    def cache_size(self) -> int:
        """The preparations made (``buckets.py RecompileCounter``)."""
        with self._prep_lock:
            return self._prepared

    def _build(self, name: str, source, version: int) -> ServedModel:
        booster = _load_booster(source)
        try:
            return ServedModel(name, booster, self.device, version=version,
                               on_prepare=self._count_prepare)
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
            prev = self._models.get(sm.name)
            if prev is not None and prev is not sm:
                hist = self._history.setdefault(sm.name, [])
                hist.append(prev)
                for gone in hist[:-self.HISTORY_DEPTH]:
                    gone.free_graphs()
                del hist[:-self.HISTORY_DEPTH]
            self._models[sm.name] = sm  # one assignment = the atomic swap
            self._versions[sm.name] = max(
                self._versions.get(sm.name, 0), sm.version)
        return sm

    def previous(self, name: str) -> Optional[ServedModel]:
        """The version a :meth:`rollback` would restore (None if none)."""
        with self._lock:
            hist = self._history.get(name)
            return hist[-1] if hist else None

    def rollback(self, name: str) -> ServedModel:
        """Atomically restore the version the last swap displaced: the
        same ServedModel object, still on the device, so the restore is
        one dict assignment. The version counter keeps its high-water
        mark: the next swap takes a fresh number, never the rolled-back
        one."""
        with self._lock:
            hist = self._history.get(name)
            if not hist:
                raise UnknownModel(
                    f"no prior version to roll back to for model '{name}'")
            prev = hist.pop()
            gone = self._models.get(name)
            self._models[name] = prev
            if gone is not None and gone is not prev:
                gone.free_graphs()
            return prev

    def unload(self, name: str) -> None:
        with self._lock:
            gone = self._models.pop(name, None)
            if gone is None:
                raise UnknownModel(f"no served model named '{name}'")
            gone.free_graphs()

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

    def resolve_name(self, name: Optional[str]) -> str:
        return self.get(name).name

    def models(self) -> List[ServedModel]:
        with self._lock:
            return list(self._models.values())

    def describe(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{"name": m.name, "version": m.version,
                     "n_features": m.n_features, "n_groups": m.n_groups,
                     "n_trees": m.n_trees}
                    for m in self._models.values()]
