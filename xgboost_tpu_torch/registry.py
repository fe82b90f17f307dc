"""Component registries by name (the JAX package's ``registry.py``).

The counterpart of the dmlc registry that the reference uses for every
pluggable component (``XGBOOST_REGISTER_OBJECTIVE`` and its kin, e.g.
``src/objective/regression_obj.cu:184``): a registry maps a name (and
its aliases) to a factory, filled by decorators, so that objectives,
metrics, boosters, updaters and predictors are chosen by their string
name as in the reference. ``import xgboost_tpu_torch`` fills all six:

- ``OBJECTIVES`` / ``METRICS``: the ``objective/`` and ``metric/``
  modules (``get_objective`` / ``get_metric`` create through them, so a
  name registered by a plugin trains: ``OBJECTIVES.register("name")``
  on an ``objective.Objective`` subclass).
- ``BOOSTERS``: ``gbtree``, ``dart``, ``gblinear``.
- ``TREE_UPDATERS``: ``grow_quantile_histmaker`` (aliases
  ``grow_gpu_hist``, ``grow_histmaker``) -> ``tree/grow.py
  TreeGrower``, ``grow_colmaker`` (alias ``exact``) -> ``tree/exact.py
  ExactGrower``, and ``prune`` / ``refresh`` / ``sync`` ->
  ``tree/updaters.py``. The leaf-wise, paged and vector-leaf growers are
  chosen by ``grow_policy``, the matrix and ``multi_strategy`` behind
  these names, as one reference updater serves several drivers.
- ``PREDICTORS``: ``gpu_predictor`` (aliases ``cpu_predictor``,
  ``tpu_predictor``, ``auto``) -> ``serve/packed.py PackedForest``, the
  forest walk of kernel K1.
- ``LINEAR_UPDATERS``: ``shotgun`` / ``coord_descent``
  (``boosting/gblinear.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """Names (and aliases) -> factories."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._entries: Dict[str, Callable[..., T]] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, name: str, *aliases: str
                 ) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(factory: Callable[..., T]) -> Callable[..., T]:
            if name in self._entries:
                raise ValueError(f"{self.kind} '{name}' already registered")
            self._entries[name] = factory
            for a in aliases:
                self._aliases[a] = name
            factory._registry_name = name  # type: ignore[attr-defined]
            return factory

        return deco

    def resolve(self, name: str) -> str:
        return self._aliases.get(name, name)

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) in self._entries

    def create(self, name: str, *args: Any, **kwargs: Any) -> T:
        key = self.resolve(name)
        if key not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise ValueError(f"Unknown {self.kind}: '{name}'. Known: {known}")
        return self._entries[key](*args, **kwargs)

    def get(self, name: str) -> Optional[Callable[..., T]]:
        return self._entries.get(self.resolve(name))

    def names(self) -> List[str]:
        return sorted(self._entries)

    def keys(self) -> List[str]:
        """Every name and alias."""
        return sorted(list(self._entries) + list(self._aliases))


OBJECTIVES: Registry = Registry("objective")
METRICS: Registry = Registry("metric")
TREE_UPDATERS: Registry = Registry("tree updater")
BOOSTERS: Registry = Registry("gradient booster")
PREDICTORS: Registry = Registry("predictor")
LINEAR_UPDATERS: Registry = Registry("linear updater")
