"""Execution topology: named pools of homogeneous units.

The paper's mechanism and our serving adaptation share one structural
idea — *partition the execution units and confine frequency-reducing
(heavy) work to one partition*. Before this module the partition was
encoded twice, incompatibly: ``SchedConfig.n_avx_cores`` (an int, OS
simulator) and string-matched pool names inside ``sched/engine.py``
(serving). ``Topology`` makes it one explicit object:

  * a ``Pool`` is a named group of units (cores in the OS simulator,
    devices in the serving engine) plus a capability set describing the
    work kinds it *may* execute;
  * a ``Topology`` is an ordered collection of pools covering unit ids
    ``0..n_units-1`` exactly once.

Capabilities are descriptive ("this pool can run heavy work"); *when*
and *whether* it does — placement, steal eligibility, preemption — is
the :class:`repro_torch.sched.policy.Policy`'s decision. This is the
mechanism/policy split Gottschlag & Bellosa's follow-up argues for.

One level up, :class:`repro_torch.sched.cluster.ClusterTopology` composes
these per-shard: shards partition a fleet's devices the way pools
partition a node's, with the same frozen/serializable discipline
(``to_dict``/``from_dict`` round-trip at both levels) and its own
factories (``ClusterTopology.homogeneous`` / ``shared_pool``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple


class WorkKind(enum.Enum):
    """Scheduler-visible classification of work.

    HEAVY — triggers the frequency license (AVX-512 crypto in the paper;
    MXU-saturating prefill in the serving adaptation).
    LIGHT — latency-critical work hurt by co-located heavy work (scalar
    request handling; memory-bound decode).
    ANY — untyped work that must not be starved (system tasks, §3.2).
    """
    HEAVY = "heavy"
    LIGHT = "light"
    ANY = "any"


ALL_KINDS: Tuple[WorkKind, ...] = (WorkKind.HEAVY, WorkKind.LIGHT,
                                   WorkKind.ANY)


@dataclass(frozen=True)
class Pool:
    """A named group of execution units with a capability set."""
    name: str
    units: Tuple[int, ...]
    capabilities: frozenset = frozenset(ALL_KINDS)

    @property
    def n_units(self) -> int:
        return len(self.units)

    def can(self, kind: WorkKind) -> bool:
        return kind in self.capabilities


@dataclass(frozen=True)
class Topology:
    """Ordered pools partitioning unit ids ``0..n_units-1``."""
    pools: Tuple[Pool, ...]

    def __post_init__(self):
        seen = set()
        for p in self.pools:
            for u in p.units:
                if u in seen:
                    raise ValueError(f"unit {u} in more than one pool")
                seen.add(u)
        if seen and seen != set(range(len(seen))):
            raise ValueError("pool units must cover 0..n_units-1")

    # ------------------------------------------------------------ lookup

    @property
    def n_units(self) -> int:
        return sum(p.n_units for p in self.pools)

    @property
    def heavy_units(self) -> int:
        """Units in heavy-capable pools — the denominator of a node's
        license exposure (the cluster router reports it per shard)."""
        return sum(p.n_units for p in self.pools
                   if p.can(WorkKind.HEAVY))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.pools)

    def __iter__(self) -> Iterator[Pool]:
        return iter(self.pools)

    def pool(self, name: str) -> Pool:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(name)

    def pool_of_unit(self, unit: int) -> Pool:
        for p in self.pools:
            if unit in p.units:
                return p
        raise KeyError(unit)

    def pools_with(self, kind: WorkKind) -> Tuple[Pool, ...]:
        return tuple(p for p in self.pools if p.can(kind))

    def unit_pool_map(self) -> Dict[int, str]:
        return {u: p.name for p in self.pools for u in p.units}

    # -------------------------------------------------------- reshaping

    def resized(self, heavy_pool: str, n_heavy: int) -> "Topology":
        """Return a topology with ``heavy_pool`` grown/shrunk to
        ``n_heavy`` units, moving units to/from the other pool.

        Only defined for two-pool topologies (the specialization shape);
        unit ids are reassigned contiguously, light pool first — matching
        the paper's "last N physical cores" convention.
        """
        if len(self.pools) != 2:
            raise ValueError("resized() needs exactly two pools")
        heavy = self.pool(heavy_pool)
        other = next(p for p in self.pools if p.name != heavy_pool)
        n_heavy = max(0, min(n_heavy, self.n_units - 1))
        n_other = self.n_units - n_heavy
        new_other = Pool(other.name, tuple(range(n_other)),
                         other.capabilities)
        new_heavy = Pool(heavy.name, tuple(range(n_other, self.n_units)),
                         heavy.capabilities)
        ordered = tuple(new_heavy if p.name == heavy_pool else new_other
                        for p in self.pools)
        return Topology(ordered)

    # ----------------------------------------------------- serialization

    def to_dict(self) -> Dict:
        """JSON-able description (the replay harness records the exact
        layout each run used in its metrics matrix)."""
        return {"pools": [{"name": p.name, "units": list(p.units),
                           "capabilities": sorted(k.value
                                                  for k in p.capabilities)}
                          for p in self.pools]}

    @staticmethod
    def from_dict(d: Dict) -> "Topology":
        return Topology(tuple(
            Pool(p["name"], tuple(p["units"]),
                 frozenset(WorkKind(k) for k in p["capabilities"]))
            for p in d["pools"]))

    # -------------------------------------------------------- factories

    @staticmethod
    def shared(n_units: int, name: str = "shared") -> "Topology":
        """One pool, every unit runs everything (the no-spec baseline)."""
        return Topology((Pool(name, tuple(range(n_units))),))

    @staticmethod
    def split(n_units: int, n_heavy: int, *, heavy_name: str = "heavy",
              light_name: str = "light") -> "Topology":
        """Two pools: a light pool (units 0..) that never runs heavy
        work, and a heavy pool (the last ``n_heavy`` units — the paper
        pins AVX to the last physical cores) that may run anything."""
        if not 0 < n_heavy < n_units:
            raise ValueError(f"need 0 < n_heavy < n_units, got "
                             f"{n_heavy}/{n_units}")
        light = Pool(light_name, tuple(range(n_units - n_heavy)),
                     frozenset({WorkKind.LIGHT, WorkKind.ANY}))
        heavy = Pool(heavy_name, tuple(range(n_units - n_heavy, n_units)),
                     frozenset(ALL_KINDS))
        return Topology((heavy, light))

    @staticmethod
    def serving(n_devices: int, prefill_devices: int) -> "Topology":
        """The serving shape: a ``prefill`` pool (heavy-capable) and a
        ``decode`` pool that never prefills (DESIGN.md §2.2)."""
        return Topology.split(n_devices, prefill_devices,
                              heavy_name="prefill", light_name="decode")

    @staticmethod
    def cores(n_cores: int, n_avx_cores: int) -> "Topology":
        """The paper's shape: ``scalar`` cores + the last ``n_avx_cores``
        physical cores as the ``avx`` pool. ``n_avx_cores == 0`` gives
        the shared baseline; ``n_avx_cores >= n_cores`` collapses to one
        all-capability ``avx`` pool (every core may run heavy work)."""
        if n_avx_cores <= 0:
            return Topology.shared(n_cores)
        if n_avx_cores >= n_cores:
            return Topology.shared(n_cores, name="avx")
        return Topology.split(n_cores, n_avx_cores,
                              heavy_name="avx", light_name="scalar")
