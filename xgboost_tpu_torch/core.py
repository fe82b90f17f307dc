"""Booster: the serving subset — load a gbtree model, predict, save.

``predict`` goes through the packed walk (``serve/packed.py`` +
``ops/walk.py``), on the card unless the Booster was made with
``{"device": "cpu"}``. In the JAX package the packed walk is
bit-identical to ``Booster.predict``'s unpacked walk, so the port needs
only the one walk. The model's ``"config"`` block (``tree_param``,
``learner_params``) is kept as read, so ``save_raw`` gives back the
bytes a JAX-package model was saved as; training comes with a later
slice.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .boosting.gbtree import GBTree
from .context import Context
from .data.dmatrix import DMatrix
from .interop import is_reference_model, reference_to_native_json
from .objective import get_objective
from .serve.packed import PackedForest
from .utils.ubjson import dumps_ubjson, loads_ubjson


class Booster:
    """A gradient-boosted tree model, loaded for prediction.

    ``params`` may name ``"device"`` (``"cuda"`` by default, ``"cpu"``);
    training parameters are accepted and take effect with the training
    slice."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 model_file: Union[str, bytes, bytearray, None] = None
                 ) -> None:
        self.ctx = Context(device=str((params or {}).get("device", "cuda")))
        self.device = self.ctx.torch_device()   # raises without CUDA
        self.learner_params: Dict[str, Any] = {
            "objective": "reg:squarederror", "booster": "gbtree",
            "num_parallel_tree": 1, "tree_method": "auto", "num_class": 0,
        }
        self.attributes_: Dict[str, str] = {}
        self.feature_names: Optional[List[str]] = None
        self.feature_types: Optional[List[str]] = None
        self.obj = None
        self.gbm: Optional[GBTree] = None
        self.base_margin_: Optional[np.ndarray] = None
        self._num_features = 0
        self._version: List[int] = [0, 1, 0]
        self._config: Dict[str, Any] = {}
        self._packed: Dict[Tuple[int, int], PackedForest] = {}
        self._packed_lock = threading.Lock()
        if model_file is not None:
            self.load_model(model_file)

    # ------------------------------------------------------------ metadata
    @property
    def n_groups(self) -> int:
        return self.gbm.n_groups if self.gbm is not None else 1

    def _base_np(self) -> np.ndarray:
        if self.base_margin_ is None:
            return np.zeros(self.n_groups, np.float32)
        return self.base_margin_

    def num_features(self) -> int:
        if self.feature_names:
            return len(self.feature_names)
        return self._num_features

    def _require_model(self) -> None:
        if self.gbm is None:
            raise ValueError("no model loaded; pass model_file= or call "
                             "load_model()")

    # ------------------------------------------------------------- predict
    def _validate_features(self, data: DMatrix) -> None:
        nf = self.num_features()
        if nf and data.num_col() != nf:
            raise ValueError(
                f"feature count mismatch: model has {nf}, data has "
                f"{data.num_col()}")
        names = data.info.feature_names
        if self.feature_names and names and self.feature_names != names:
            missing = set(self.feature_names) - set(names)
            extra = set(names) - set(self.feature_names)
            raise ValueError(
                "feature_names mismatch between model and data"
                + (f"; missing from data: {sorted(missing)}" if missing
                   else "")
                + (f"; unexpected in data: {sorted(extra)}" if extra else ""))

    def packed_forest(self, iteration_range=None) -> Optional[PackedForest]:
        """The packed form of the selected rounds (packed once, cached);
        ``None`` when they hold no trees."""
        self._require_model()
        key = self.gbm._tree_range(iteration_range)
        if key[1] <= key[0]:
            return None
        pf = self._packed.get(key)
        if pf is None:
            with self._packed_lock:
                pf = self._packed.get(key)
                if pf is None:
                    pf = PackedForest.from_booster(self, iteration_range)
                    self._packed[key] = pf
        return pf

    def predict(self, data: DMatrix, output_margin: bool = False,
                iteration_range: Optional[Tuple[int, int]] = None,
                strict_shape: bool = False,
                validate_features: bool = True) -> np.ndarray:
        """Predictions [n] (or [n, G]) through the packed walk on this
        Booster's device."""
        self._require_model()
        if validate_features:
            self._validate_features(data)
        dev = self.device
        X = torch.from_numpy(np.ascontiguousarray(data.values())).to(dev)
        if data.info.base_margin is not None:
            base = torch.zeros(self.n_groups, dtype=torch.float32, device=dev)
            rows = torch.from_numpy(np.asarray(
                data.info.base_margin, np.float32)).to(dev)
        else:
            base = torch.tensor(np.broadcast_to(self._base_np(),
                                                (self.n_groups,)), device=dev)
            rows = None
        pf = self.packed_forest(iteration_range)
        if pf is None:
            margin = base[None, :].expand(X.shape[0], -1).clone()
        else:
            margin = pf.margin(X, base)
        if rows is not None:
            margin = margin + rows.reshape(margin.shape[0], -1)
        out = margin if output_margin else self.obj.pred_transform(margin)
        out = out.cpu().numpy()
        if not strict_shape and out.ndim == 2 and out.shape[1] == 1:
            out = out[:, 0]
        return out

    # ------------------------------------------------------------------ IO
    def save_raw(self, raw_format: str = "ubj") -> bytearray:
        obj = self._model_to_json()
        if raw_format == "json":
            return bytearray(json.dumps(obj).encode())
        return bytearray(dumps_ubjson(obj))

    @staticmethod
    def _reject_legacy_binary(head: bytes) -> None:
        if head.lstrip(b"\x00").startswith(b"binf") or head.startswith(
                b"bs64"):
            raise ValueError(
                "this is a legacy binary ('binf') XGBoost model; the "
                "deprecated pre-JSON format is not supported — re-save it "
                "as JSON/UBJSON with reference XGBoost >= 1.6 "
                "(booster.save_model('model.json')) and load that instead")

    def load_model(self, fname: Union[str, bytes, bytearray]) -> None:
        if isinstance(fname, (bytes, bytearray)):
            raw = bytes(fname)
            self._reject_legacy_binary(raw[:16])
            # a UBJSON object also begins with the byte '{' — sniff JSON
            # first, fall back to the binary codec
            try:
                obj = json.loads(raw.decode())
            except (UnicodeDecodeError, ValueError):
                obj = loads_ubjson(raw)
        else:
            with open(fname, "rb") as fh:
                raw = fh.read()
            self._reject_legacy_binary(raw[:16])
            obj = (loads_ubjson(raw) if str(fname).endswith(".ubj")
                   else json.loads(raw.decode()))
        self._model_from_json(obj)

    def _model_to_json(self) -> dict:
        self._require_model()
        return {
            "version": list(self._version),
            "learner": {
                "attributes": dict(self.attributes_),
                "feature_names": self.feature_names or [],
                "feature_types": self.feature_types or [],
                "learner_model_param": {
                    "base_score": self._base_np().tolist(),
                    "num_class": int(self.learner_params.get("num_class", 0)),
                    "num_target": self.n_groups,
                    "num_feature": self.num_features(),
                },
                "objective": self.obj.to_json(),
                "gradient_booster": self.gbm.to_json(),
            },
            "config": self._config,
        }

    def _model_from_json(self, obj: dict) -> None:
        if is_reference_model(obj):
            obj = reference_to_native_json(obj)
        learner = obj["learner"]
        self._version = list(obj.get("version", self._version))
        self._config = obj.get("config", {})
        self.learner_params.update(self._config.get("learner_params", {}))
        self.attributes_ = dict(learner.get("attributes", {}))
        self.feature_names = learner.get("feature_names") or None
        self.feature_types = learner.get("feature_types") or None
        lmp = learner.get("learner_model_param", {})
        self._num_features = int(lmp.get("num_feature", 0) or 0)
        self.base_margin_ = np.asarray(lmp.get("base_score", [0.0]),
                                       dtype=np.float32).reshape(-1)
        obj_cfg = learner.get("objective", {})
        name = obj_cfg.get("name", self.learner_params.get(
            "objective", "reg:squarederror"))
        self.learner_params["objective"] = name
        self.obj = get_objective(name, {k: v for k, v in obj_cfg.items()
                                        if k != "name"})
        n_groups = max(1, int(lmp.get("num_target", 1)))
        gb = learner.get("gradient_booster", {})
        booster = gb.get("name", "gbtree") if gb else "gbtree"
        if booster != "gbtree":
            raise NotImplementedError(
                f"booster {booster!r} is not in the PyTorch port yet "
                "(gbtree only)")
        self.learner_params["booster"] = booster
        gbm = GBTree(n_groups)
        if gb:
            gbm.from_json(gb)
        self.gbm = gbm
        self._packed = {}
