"""Fleet mode: N in-process Server replicas behind one router (the JAX
package's ``serve/fleet.py``).

One :class:`~.server.Server` owns one micro-batcher worker, so its
throughput ceiling is one dispatch queue. :class:`FleetRouter` runs N
**shared-nothing** replicas on one device — each with its own registry,
batcher thread, ladders, pinned staging buffers and metrics (labeled
``replica=rK`` in the process-wide exposition) — and routes requests
over them:

- **Placement** is consistent hashing (:class:`_HashRing`, the JAX
  package's sha1 positions, so a name lands on the same replicas in both
  packages): each model name maps to ``replication`` replicas, and
  adding or removing a replica moves only the ~1/N of models whose arc
  the change touches.
- **Routing** picks the least-loaded placed replica (live queue depth
  from the batcher), failing over to the other placed replicas when one
  sheds — a request only fails admission when EVERY placed replica is
  saturated.
- **Promotion** fans the server's two-phase warm-then-publish across the
  placement: every placed replica fully builds AND warms the incoming
  version first, then the publishes run back-to-back — the fleet never
  serves a half-warm version, and a failed build on any replica aborts
  the whole promotion with the old version still serving everywhere.
- **Autoscaling** (:meth:`FleetRouter.autoscale_tick`) watches the
  fleet's own signals — aggregate queued rows and the merged e2e p99 —
  and grows or shrinks the replica set inside ``[min_replicas,
  max_replicas]``. Removal always drains: ``close(drain=True)`` resolves
  every queued future, so killing one replica loses no request.

Env knobs (``XTPU_FLEET_*``, read at FleetConfig construction):
``XTPU_FLEET_REPLICAS``, ``XTPU_FLEET_MIN``, ``XTPU_FLEET_MAX``,
``XTPU_FLEET_REPLICATION``, ``XTPU_FLEET_AUTOSCALE_S``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..logging_utils import logger
from ..obs.metrics import Family, Sample, get_registry
from .errors import (ServeError, ServerClosed, ServerOverloaded,
                     UnknownModel)
from .server import ServeConfig, Server, _UNSET


@dataclasses.dataclass
class FleetConfig:
    """Fleet sizing + autoscale policy. ``None`` fields resolve from the
    ``XTPU_FLEET_*`` environment at construction."""

    replicas: Optional[int] = None          # initial replica count
    min_replicas: Optional[int] = None      # autoscale floor
    max_replicas: Optional[int] = None      # autoscale ceiling
    replication: Optional[int] = None       # replicas per model
    autoscale_interval_s: Optional[float] = None  # 0 = manual ticks only
    # scale-up triggers: EITHER signal past its bound scales up; both
    # clear (with hysteresis headroom) scales down
    scale_up_queue_rows: int = 1024         # aggregate queued rows
    p99_slo_ms: float = 0.0                 # 0 = ignore latency signal
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def __post_init__(self) -> None:
        if self.replicas is None:
            self.replicas = int(os.environ.get("XTPU_FLEET_REPLICAS", "2"))
        if self.min_replicas is None:
            self.min_replicas = int(os.environ.get("XTPU_FLEET_MIN", "1"))
        if self.max_replicas is None:
            self.max_replicas = int(os.environ.get("XTPU_FLEET_MAX", "8"))
        if self.replication is None:
            self.replication = int(
                os.environ.get("XTPU_FLEET_REPLICATION", "2"))
        if self.autoscale_interval_s is None:
            self.autoscale_interval_s = float(
                os.environ.get("XTPU_FLEET_AUTOSCALE_S", "0"))
        if self.replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {self.replicas}")
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min ({self.min_replicas}) <= max "
                f"({self.max_replicas})")
        if self.replication < 1:
            raise ValueError("replication must be >= 1")


class _HashRing:
    """Consistent-hash ring with virtual nodes (sha1 positions).

    ``place(key, k)`` walks clockwise from the key's position and
    returns the first ``k`` DISTINCT nodes — the standard construction,
    so membership changes only remap keys whose arc gained or lost a
    virtual node (~1/N of them), never reshuffle the whole space.
    """

    VNODES = 64

    def __init__(self, nodes: Sequence[str] = ()) -> None:
        self._ring: List[Tuple[int, str]] = []
        self._nodes: Set[str] = set()
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(key.encode()).digest()[:8], "big")

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.VNODES):
            self._ring.append((self._hash(f"{node}#{v}"), node))
        self._ring.sort()

    def remove(self, node: str) -> None:
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def nodes(self) -> Set[str]:
        return set(self._nodes)

    def place(self, key: str, k: int = 1) -> List[str]:
        if not self._ring:
            return []
        k = min(k, len(self._nodes))
        h = self._hash(key)
        # first ring position clockwise of h (bisect over the hash column)
        import bisect

        i = bisect.bisect_right([p for p, _ in self._ring], h)
        out: List[str] = []
        for j in range(len(self._ring)):
            node = self._ring[(i + j) % len(self._ring)][1]
            if node not in out:
                out.append(node)
                if len(out) == k:
                    break
        return out


class _FleetRegistry:
    """Read-only registry facade so the HTTP front end talks to a fleet
    exactly like a single Server (``server.registry.get/describe/
    resolve_name``)."""

    def __init__(self, fleet: "FleetRouter") -> None:
        self._fleet = fleet

    def get(self, name: Optional[str] = None):
        return self._fleet._resolve(name)[1].registry.get(name)

    def resolve_name(self, name: Optional[str]) -> str:
        return self._fleet._resolve(name)[0]

    def describe(self) -> List[Dict[str, object]]:
        seen: Dict[Tuple[str, int], Dict[str, object]] = {}
        for r in self._fleet.replicas():
            for d in r.registry.describe():
                seen.setdefault((d["name"], d["version"]), d)
        return list(seen.values())

    def models(self):
        seen: Dict[Tuple[str, int], object] = {}
        for r in self._fleet.replicas():
            for m in r.registry.models():
                seen.setdefault((m.name, m.version), m)
        return list(seen.values())


class FleetRouter:
    """N shared-nothing Server replicas on ``device`` (the card unless
    the caller asks for ``"cpu"``) behind consistent-hash routing.

    Duck-types the Server surface the front ends and the client use
    (submit/predict/contribs, model lifecycle, health/metrics
    snapshots, close), so ``--fleet N`` is a drop-in.
    """

    def __init__(self, models: Optional[Dict[str, object]] = None,
                 config: Optional[FleetConfig] = None,
                 device: str = "cuda", **cfg_kw) -> None:
        if config is None:
            config = FleetConfig(**cfg_kw)
        elif cfg_kw:
            config = dataclasses.replace(config, **cfg_kw)
        self.config = config
        self.device = device
        self._lock = threading.RLock()
        self._replicas: Dict[str, Server] = {}
        self._ring = _HashRing()
        self._next_id = 0
        self._counters: Dict[str, int] = {}
        self._closed = False
        self._autoscaler: Optional[threading.Thread] = None
        self._autoscale_stop = threading.Event()
        self.registry = _FleetRegistry(self)
        for _ in range(config.replicas):
            self._add_replica_locked()
        get_registry().register(FleetRouter._collect_obs, owner=self)
        for name, src in (models or {}).items():
            self.load_model(name, src)

    # ---------------------------------------------------------- replica set
    def _add_replica_locked(self) -> Server:
        name = f"r{self._next_id}"
        self._next_id += 1
        srv = Server(config=self.config.serve, device=self.device,
                     replica=name)
        self._replicas[name] = srv
        self._ring.add(name)
        return srv

    def replicas(self) -> List[Server]:
        with self._lock:
            return list(self._replicas.values())

    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def placement(self, model: str) -> List[str]:
        """The replicas a model name hashes to (placement order)."""
        with self._lock:
            return self._ring.place(model, self.config.replication)

    def add_replica(self, warm: bool = True) -> str:
        """Grow the fleet by one replica and rebalance: models whose
        placement now includes the newcomer are loaded (and warmed)
        there BEFORE the ring change routes traffic at it."""
        with self._lock:
            if len(self._replicas) >= self.config.max_replicas:
                raise ValueError(
                    f"fleet at max_replicas={self.config.max_replicas}")
            old_place = {m: self.placement(m) for m in self._model_names()}
            srv = self._add_replica_locked()
            c0 = self._recompiles_locked()
            moved = 0
            for mname, was in old_place.items():
                now = self._ring.place(mname, self.config.replication)
                if srv.replica in now:
                    src = self._replicas[was[0]].registry.get(mname)
                    srv.load_model(mname, src.booster, version=src.version,
                                   warm=warm)
                    moved += 1
                for gone in set(was) - set(now):
                    # placement shrank off this replica; retire its copy
                    try:
                        self._replicas[gone].unload_model(mname)
                    except (UnknownModel, KeyError):
                        pass
            if warm:
                srv.mark_warm()  # fresh baseline; no absorb needed on it
            self._absorb_fleet_locked(c0, exclude={srv.replica})
            self._inc("scale_up_events")
            logger.info("fleet: added replica %s (%d models placed)",
                        srv.replica, moved)
            return srv.replica

    def remove_replica(self, name: str, drain: bool = True) -> None:
        """Shrink the fleet: re-home the victim's models onto their new
        placement first, stop routing to it, then drain it — every
        future it already accepted resolves."""
        with self._lock:
            if name not in self._replicas:
                raise KeyError(f"no replica named {name!r}")
            if len(self._replicas) <= 1:
                raise ValueError("cannot remove the last replica")
            victim = self._replicas[name]
            served = [m.name for m in victim.registry.models()]
            self._ring.remove(name)       # stop routing to it NOW
            del self._replicas[name]
            c0 = self._recompiles_locked()
            for mname in served:
                now = self._ring.place(mname, self.config.replication)
                for tgt in now:
                    dst = self._replicas[tgt]
                    try:
                        dst.registry.get(mname)
                    except UnknownModel:
                        src = victim.registry.get(mname)
                        dst.load_model(mname, src.booster,
                                       version=src.version, warm=True)
            self._absorb_fleet_locked(c0)
            self._inc("scale_down_events")
        # drain OUTSIDE the lock: queued dispatches may take a while and
        # the router must keep serving the survivors meanwhile
        victim.close(drain=drain)
        logger.info("fleet: removed replica %s (drained=%s)", name, drain)

    def _model_names(self) -> List[str]:
        names: Set[str] = set()
        for r in self._replicas.values():
            names.update(m.name for m in r.registry.models())
        return sorted(names)

    def _recompiles_locked(self) -> Dict[str, int]:
        """Each replica's recompiles after its warmup, before a fleet
        operation."""
        return {n: r.recompiles_after_warmup
                for n, r in self._replicas.items()}

    def _absorb_fleet_locked(self, before: Dict[str, int],
                             exclude: Set[str] = frozenset()) -> None:
        """Absorb the planned captures a fleet operation (a placement, a
        swap) left on each warmed replica's count since ``before`` into
        its baseline. Each replica counts its own graphs (the JAX
        package's caches are process-global, so it spreads one replica's
        delta over the fleet); a warmed Server's ``_warm_model`` absorbs
        its own warmups, so this is what any other planned capture of the
        operation left."""
        for rname, r in self._replicas.items():
            if rname in exclude or not r._warmed or rname not in before:
                continue
            extra = r.recompiles_after_warmup - before[rname]
            if extra > 0:
                r.recompile_counter.absorb(extra)

    # ------------------------------------------------------------- lifecycle
    def load_model(self, name: str, source, *,
                   version: Optional[int] = None, warm: bool = True):
        return self._fan_publish(name, source, version=version, warm=warm,
                                 swap=False)

    def swap_model(self, name: str, source, *,
                   version: Optional[int] = None, warm: bool = True):
        return self._fan_publish(name, source, version=version, warm=warm,
                                 swap=True)

    def _fan_publish(self, name: str, source, *, version: Optional[int],
                     warm: bool, swap: bool):
        """Two-phase promotion across the placement: build + warm the
        incoming version on EVERY placed replica (old version keeps
        serving), then publish on all of them back-to-back. Any build or
        warm failure aborts before a single publish — the fleet never
        half-promotes."""
        with self._lock:
            placed = self._ring.place(name, self.config.replication)
            if not placed:
                raise ServeError("fleet has no replicas")
            c0 = self._recompiles_locked()
            prepared: List[Tuple[Server, object]] = []
            v = version
            for rname in placed:
                r = self._replicas[rname]
                if not swap and name in [m.name
                                         for m in r.registry.models()]:
                    raise ValueError(
                        f"model '{name}' is already served; use swap")
                sm = r.registry.prepare(name, source, version=v)
                v = sm.version  # pin one version for the whole fan-out
                if warm and sm.n_features > 0:
                    r._warm_model(sm)
                prepared.append((r, sm))
            # phase 2: publishes are each atomic; running them under the
            # router lock means no submit can race a half-fanned set
            out = None
            for r, sm in prepared:
                r.registry.publish(sm)
                if swap:
                    r.metrics.inc("swaps")
                out = sm
            self._absorb_fleet_locked(c0)
            self._inc("promotions")
            return out

    def rollback_model(self, name: str):
        with self._lock:
            placed = self._ring.place(name, self.config.replication)
            out = None
            for rname in placed:
                out = self._replicas[rname].rollback_model(name)
            return out

    def unload_model(self, name: str) -> None:
        with self._lock:
            for r in self._replicas.values():
                try:
                    r.unload_model(name)
                except (UnknownModel, KeyError):
                    pass

    def served_versions(self, name: str) -> Set[int]:
        """Every version of ``name`` currently published on some replica
        — len > 1 means a promotion is mid-flight or was interrupted."""
        out: Set[int] = set()
        for r in self.replicas():
            try:
                out.add(r.registry.get(name).version)
            except UnknownModel:
                pass
        return out

    def warmup(self, model: Optional[str] = None,
               n_features: Optional[int] = None) -> int:
        n = 0
        for r in self.replicas():
            if model is not None and not self._serves(r, model):
                continue
            n += r.warmup(model, n_features)
        return n

    def warmup_contribs(self, model: Optional[str] = None) -> int:
        n = 0
        for r in self.replicas():
            if model is not None and not self._serves(r, model):
                continue
            n += r.warmup_contribs(model)
        return n

    @staticmethod
    def _serves(r: Server, name: str) -> bool:
        try:
            r.registry.get(name)
            return True
        except UnknownModel:
            return False

    # --------------------------------------------------------------- routing
    def _resolve(self, model: Optional[str]) -> Tuple[str, Server]:
        """(model name, least-loaded placed replica). Raises UnknownModel
        exactly like a single Server would."""
        with self._lock:
            if model is None:
                names = self._model_names()
                if len(names) != 1:
                    raise UnknownModel(
                        "model name required: "
                        f"{len(names)} models are served ({names})")
                model = names[0]
            placed = [self._replicas[n]
                      for n in self._ring.place(model,
                                                self.config.replication)
                      if n in self._replicas]
        placed = [r for r in placed if self._serves(r, model)]
        if not placed:
            raise UnknownModel(f"no served model named '{model}'")
        best = min(placed, key=lambda r: r.batcher.queue_depth_rows())
        return model, best

    def _route(self, model: Optional[str], call, again: bool = True):
        """Run ``call(name, replica)`` on the least-loaded placed
        replica, failing over across the rest of the placement when one
        sheds. Only raises ServerOverloaded once EVERY placed replica
        shed the request. A replica closed after this request resolved
        it (a drained removal) fails over too, and when every replica the
        request resolved was closed meanwhile it is routed anew, once —
        so a removal under load fails no request (the JAX package lets
        that ServerClosed through)."""
        name, first = self._resolve(model)
        with self._lock:
            order = [self._replicas[n]
                     for n in self._ring.place(name,
                                               self.config.replication)
                     if n in self._replicas]
        order.sort(key=lambda r: r is not first)  # least-loaded first
        if first not in order:      # removed since it was resolved
            order.insert(0, first)
        last_exc: Optional[BaseException] = None
        for r in order:
            if not self._serves(r, name):
                continue
            try:
                out = call(name, r)
                self._inc("routed")
                return out
            except (ServerOverloaded, ServerClosed) as exc:
                self._inc("failovers")
                last_exc = exc
        if isinstance(last_exc, ServerClosed):
            if again and not self._closed:
                return self._route(model, call, again=False)
            raise last_exc
        self._inc("sheds")
        raise last_exc if last_exc is not None else ServerOverloaded(
            f"every placed replica shed the request for '{name}'")

    def submit(self, data, model: Optional[str] = None, *,
               output: str = "value",
               timeout_ms: object = _UNSET) -> Future:
        return self._route(model, lambda name, r: r.submit(
            data, name, output=output, timeout_ms=timeout_ms))

    def predict(self, data, model: Optional[str] = None, *,
                output: str = "value",
                timeout_ms: object = _UNSET) -> np.ndarray:
        return self.submit(data, model, output=output,
                           timeout_ms=timeout_ms).result()

    def contribs(self, data, model: Optional[str] = None, *,
                 timeout_ms: object = _UNSET) -> np.ndarray:
        return self._route(model, lambda name, r: r.contribs(
            data, name, timeout_ms=timeout_ms))

    # ------------------------------------------------------------- autoscale
    def autoscale_tick(self) -> Optional[str]:
        """One autoscale decision from the fleet's own signals: scale up
        when aggregate queue depth or merged e2e p99 breaches its bound,
        scale down when both sit far below (half the up-trigger, the
        hysteresis band that keeps the fleet from flapping). Returns
        "up" / "down" / None."""
        cfg = self.config
        with self._lock:
            n = len(self._replicas)
            queue = sum(r.batcher.queue_depth_rows()
                        for r in self._replicas.values())
        p99 = self._merged_p99_ms()
        over = (queue > cfg.scale_up_queue_rows
                or (cfg.p99_slo_ms > 0 and p99 > cfg.p99_slo_ms))
        under = (queue < cfg.scale_up_queue_rows // 2
                 and (cfg.p99_slo_ms <= 0 or p99 < cfg.p99_slo_ms / 2))
        if over and n < cfg.max_replicas:
            self.add_replica()
            return "up"
        if under and n > cfg.min_replicas:
            # drop the least-loaded replica; drain keeps its futures
            with self._lock:
                victim = min(self._replicas,
                             key=lambda k: self._replicas[k]
                             .batcher.queue_depth_rows())
            self.remove_replica(victim, drain=True)
            return "down"
        return None

    def _merged_p99_ms(self) -> float:
        return max((r.metrics.percentile_ms("e2e", 99)
                    for r in self.replicas()), default=0.0)

    def start_autoscaler(self) -> bool:
        """Background autoscale loop (interval from
        ``XTPU_FLEET_AUTOSCALE_S``; <= 0 leaves scaling to manual
        :meth:`autoscale_tick` calls)."""
        if self.config.autoscale_interval_s <= 0 \
                or self._autoscaler is not None:
            return False

        def loop() -> None:
            while not self._autoscale_stop.wait(
                    self.config.autoscale_interval_s):
                try:
                    self.autoscale_tick()
                except Exception:  # noqa: BLE001 — scaling must not die
                    logger.exception("fleet: autoscale tick failed")

        self._autoscaler = threading.Thread(
            target=loop, daemon=True, name="xtt-fleet-autoscaler")
        self._autoscaler.start()
        return True

    # ------------------------------------------------------------ snapshots
    def _inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def health_snapshot(self) -> Dict[str, object]:
        """Fleet-level health in the same schema a single Server emits
        (summed counters, union of served models) plus a ``replicas``
        map with each member's own snapshot."""
        reps = {r.replica: r.health_snapshot() for r in self.replicas()}
        agg = {k: sum(int(h.get(k, 0)) for h in reps.values())
               for k in ("requests", "sheds", "deadline_exceeded",
                         "errors", "swaps", "rollbacks", "queue_rows")}
        models = {(m["name"], m["version"])
                  for h in reps.values() for m in h["models"]}
        ok = any(h["status"] == "ok" for h in reps.values())
        return {
            "status": "ok" if (ok and not self._closed) else "closed",
            "fleet": True,
            "n_replicas": len(reps),
            "warmed": all(h["warmed"] for h in reps.values()),
            "models": [{"name": n, "version": v}
                       for n, v in sorted(models)],
            **agg,
            "replicas": reps,
        }

    def metrics_snapshot(self) -> Dict[str, object]:
        reps = {r.replica: r.metrics_snapshot() for r in self.replicas()}
        with self._lock:
            fleet = dict(self._counters)
        agg: Dict[str, int] = {}
        for snap in reps.values():
            for k, v in snap.get("counters", {}).items():
                agg[k] = agg.get(k, 0) + int(v)
        return {"fleet": fleet, "counters": agg,
                "n_replicas": len(reps),
                "recompiles_after_warmup": max(
                    (snap.get("recompiles_after_warmup") or 0)
                    for snap in reps.values()) if reps else 0,
                "models": self.registry.describe(),
                "replicas": reps}

    @property
    def recompiles_after_warmup(self) -> int:
        return max((r.recompiles_after_warmup for r in self.replicas()),
                   default=0)

    def _collect_obs(self) -> List[Family]:
        with self._lock:
            counters = dict(self._counters)
            reps = list(self._replicas.values())
        fams = [
            Family("xtpu_fleet_replicas", "gauge",
                   "live replicas behind the fleet router",
                   [Sample(len(reps))]),
            Family("xtpu_fleet_replica_up", "gauge",
                   "1 per live replica (label: replica)",
                   [Sample(1, (("replica", r.replica),)) for r in reps]),
        ]
        for name in ("routed", "sheds", "failovers", "promotions",
                     "scale_up_events", "scale_down_events"):
            fams.append(Family(
                f"xtpu_fleet_{name}_total", "counter",
                f"fleet router counter {name!r}",
                [Sample(counters.get(name, 0))]))
        return fams

    # -------------------------------------------------------------- shutdown
    def drain(self) -> None:
        self.close(drain=True)

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._autoscale_stop.set()
        if self._autoscaler is not None:
            self._autoscaler.join(timeout=10.0)
        for r in self.replicas():
            r.close(drain=drain)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
