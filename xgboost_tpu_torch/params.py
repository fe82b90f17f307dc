"""Parameter system: typed, alias-aware, JSON round-trippable.

The port's copy of the JAX package's ``params.py`` (reference
``dmlc::Parameter``): dataclass fields carry aliases and bounds in
``field(metadata=...)``; ``update_allow_unknown`` consumes the keys it
knows from a key->value dict and returns the rest, the contract the
reference's ``UpdateAllowUnknown`` gives its ``Learner``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Tuple, Type, TypeVar

P = TypeVar("P", bound="Parameter")


def param_field(default: Any, *, aliases: Tuple[str, ...] = (), lower: Any = None,
                upper: Any = None, doc: str = "") -> Any:
    return field(default=default, metadata={
        "aliases": aliases, "lower": lower, "upper": upper, "doc": doc})


def _coerce(value: Any, target_type: Any) -> Any:
    """Coerce string/any values to the declared field type (params arrive
    as strings from config files and saved models)."""
    if target_type is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "1", "yes"):
                return True
            if v in ("false", "0", "no"):
                return False
            raise ValueError(f"cannot parse bool from {value!r}")
        return bool(value)
    if target_type is int:
        return int(float(value)) if isinstance(value, str) else int(value)
    if target_type is float:
        return float(value)
    if target_type is str:
        return str(value)
    return value


_TYPES = {"int": int, "float": float, "bool": bool, "str": str}


@dataclass
class Parameter:
    """Base for all parameter structs."""

    @classmethod
    def _alias_map(cls) -> Dict[str, str]:
        amap: Dict[str, str] = {}
        for f in fields(cls):
            amap[f.name] = f.name
            for a in f.metadata.get("aliases", ()):
                amap[a] = f.name
        return amap

    def update_allow_unknown(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Set known fields from kwargs; return the unknown remainder."""
        amap = type(self)._alias_map()
        fdefs = {f.name: f for f in fields(type(self))}
        unknown: Dict[str, Any] = {}
        for key, value in kwargs.items():
            name = amap.get(key)
            if name is None:
                unknown[key] = value
                continue
            t = fdefs[name].type
            if isinstance(t, str):  # from __future__ annotations
                t = _TYPES.get(t)
            coerced = _coerce(value, t) if t is not None else value
            meta = fdefs[name].metadata
            lo, hi = meta.get("lower"), meta.get("upper")
            if lo is not None and coerced is not None and coerced < lo:
                raise ValueError(f"{name}={coerced} violates lower bound {lo}")
            if hi is not None and coerced is not None and coerced > hi:
                raise ValueError(f"{name}={coerced} violates upper bound {hi}")
            setattr(self, name, coerced)
        return unknown

    @classmethod
    def from_dict(cls: Type[P], kwargs: Dict[str, Any]) -> P:
        p = cls()
        p.update_allow_unknown(dict(kwargs))
        return p

    def to_json(self) -> Dict[str, str]:
        """All values as strings, the reference's SaveConfig convention."""
        out = {}
        for f in fields(type(self)):
            v = getattr(self, f.name)
            if isinstance(v, bool):
                v = "1" if v else "0"
            out[f.name] = str(v)
        return out

    def clone(self: P) -> P:
        return dataclasses.replace(self)
