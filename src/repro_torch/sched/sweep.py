"""Sweep fabric: declarative scenario x policy x topology x frequency
grids compiled into legs and executed with near-linear parallel scaling.

The paper's headline — >70% reduction in AVX-induced performance
variability — holds only across a *space* of workloads, and the
variability signal only becomes legible at fleet scale (PAPERS.md,
Schuchart et al.). A fixed 15-scenario x 4-policy matrix cannot cover
that space; this module grows the replay harness into a real
parameter-sweep fabric:

  * a :class:`SweepSpec` is a declarative description of a sweep —
    one or more :class:`AxisGrid` blocks, each a ``base`` parameter
    dict plus product ``axes`` (every combination) and lockstep
    ``zips`` (axes advanced together), with ordered per-leg
    ``overrides`` (``{"match": {...}, "set": {...}}``). Specs
    round-trip through ``to_dict``/``from_dict`` and serialize to
    *canonical* JSON, so a sweep is a pure function of its spec +
    seed;
  * ``spec.legs()`` compiles the spec into normalized, validated leg
    dicts — scenario / policy / mechanism (engine | simulator |
    cluster) / topology shape (``n_devices``/``prefill_devices``,
    ``n_cores``/``n_avx``/``isa``, ``n_shards``/``devices_per_shard``)
    / :class:`repro_torch.sched.freq.FreqDomainConfig` overrides — each with
    a content-hash ``key`` (sha256 of the canonical leg JSON);
  * :func:`run_legs` executes legs through the persistent replay
    worker pool with **cost-estimate-ordered chunksize-1 dispatch**
    (longest legs submit first, so the straggler tail that flat
    chunking leaves is one leg deep) and **streamed collection**
    (results are consumed and cached as they complete, no giant list
    barrier), while an optional on-disk :class:`SweepCache` keyed by
    leg content hash lets interrupted or incremental sweeps resume by
    skipping completed legs — a resumed sweep's aggregate is
    byte-identical to a cold run's;
  * :func:`tidy_rows` / :func:`baseline_deltas` / :func:`reduce_rows`
    aggregate leg results into tidy tables (one flat dict per leg;
    per-group reductions of itl_p99 / variability / energy / residency
    vs the shared baseline leg of the same coordinates) consumable by
    ``benchmarks/`` and the figure registry.

``python -m repro_torch.sched.sweep --preset ci-smoke --parallel 2`` runs a
registered preset; ``--spec FILE`` runs a spec from JSON. The
``scenario_matrix`` in :mod:`repro_torch.sched.replay` is now a thin sweep
over its default grid (see :func:`matrix_spec`), byte-identical to the
pre-fabric matrix.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import time
from dataclasses import dataclass, field, fields, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.engine import ServeConfig
from repro_torch.sched.freq import ENGINE_FREQ_MS, FreqDomainConfig
from repro_torch.sched.policy import (registered_cluster_policies,
                                registered_policies)
from repro_torch.sched.workload import CLUSTER_SCENARIOS, SCENARIOS

MECHANISMS = ("engine", "simulator", "cluster")

# Leg schema per mechanism: every compiled leg carries exactly these
# fields (defaults filled at normalization), so the content-hash key is
# stable under spec refactors that only make defaults explicit.
_COMMON_FIELDS = ("mechanism", "scenario", "duration_ms", "seed")
_LEG_FIELDS: Dict[str, Tuple[str, ...]] = {
    "engine": _COMMON_FIELDS + ("policy", "n_devices", "prefill_devices",
                                "freq"),
    "simulator": _COMMON_FIELDS + ("policy", "n_cores", "n_avx", "isa"),
    "cluster": _COMMON_FIELDS + ("policy", "n_shards",
                                 "devices_per_shard", "prefill_devices",
                                 "fault_plan"),
}
_LEG_DEFAULTS: Dict[str, Dict] = {
    "engine": {"policy": "specialized", "n_devices": 16,
               "prefill_devices": 4, "freq": None},
    "simulator": {"policy": "specialized", "n_cores": 12, "n_avx": 4,
                  "isa": "avx512"},
    "cluster": {"policy": "cluster-adaptive", "n_shards": 4,
                "devices_per_shard": 16, "prefill_devices": 4,
                "fault_plan": None},
}
_SIM_POLICIES = ("shared", "specialized")
_FREQ_FIELDS = tuple(f.name for f in fields(FreqDomainConfig))


class SweepSpecError(ValueError):
    """A spec that cannot compile: unknown scenario/policy/mechanism,
    an unknown leg field, or malformed axes."""


# ------------------------------------------------------------- the spec


@dataclass(frozen=True)
class AxisGrid:
    """One grid block: ``base`` parameters applied to every leg, product
    ``axes`` (every value combination, iterated in sorted-axis-name
    order so compilation order survives canonical serialization), and
    ``zips`` — groups of equal-length axes advanced in lockstep (each
    group is one composite axis, placed after the product axes)."""
    base: Dict = field(default_factory=dict)
    axes: Dict[str, Tuple] = field(default_factory=dict)
    zips: Tuple[Dict[str, Tuple], ...] = ()

    def combos(self):
        """Yield one {field: value} dict per leg of this grid."""
        names = sorted(self.axes)
        pools: List[List[Dict]] = [
            [{n: v} for v in self.axes[n]] for n in names]
        for z in self.zips:
            zn = sorted(z)
            lengths = {len(z[n]) for n in zn}
            if len(lengths) > 1:
                raise SweepSpecError(
                    f"zip axes {zn} have unequal lengths {lengths}")
            pools.append([{n: z[n][i] for n in zn}
                          for i in range(lengths.pop())] if zn else [{}])
        for combo in itertools.product(*pools):
            out = dict(self.base)
            for part in combo:
                out.update(part)
            yield out

    def to_dict(self) -> Dict:
        return {"base": dict(self.base),
                "axes": {k: list(v) for k, v in self.axes.items()},
                "zips": [{k: list(v) for k, v in z.items()}
                         for z in self.zips]}

    @staticmethod
    def from_dict(d: Dict) -> "AxisGrid":
        return AxisGrid(
            base=dict(d.get("base", {})),
            axes={k: tuple(v) for k, v in d.get("axes", {}).items()},
            zips=tuple({k: tuple(v) for k, v in z.items()}
                       for z in d.get("zips", [])))


@dataclass(frozen=True)
class SweepSpec:
    """A declarative sweep: grid blocks + ordered overrides + the
    default trace seed. ``legs()`` compiles it; same spec (by canonical
    JSON) ⇒ same legs in the same order, always."""
    name: str
    grids: Tuple[AxisGrid, ...]
    overrides: Tuple[Dict, ...] = ()
    seed: int = 0

    # ------------------------------------------------- serialization

    def to_dict(self) -> Dict:
        return {"name": self.name, "seed": self.seed,
                "grids": [g.to_dict() for g in self.grids],
                "overrides": [
                    {"match": dict(o.get("match", {})),
                     "set": dict(o.get("set", {}))}
                    for o in self.overrides]}

    @staticmethod
    def from_dict(d: Dict) -> "SweepSpec":
        return SweepSpec(
            name=d["name"], seed=int(d.get("seed", 0)),
            grids=tuple(AxisGrid.from_dict(g) for g in d["grids"]),
            overrides=tuple({"match": dict(o.get("match", {})),
                             "set": dict(o.get("set", {}))}
                            for o in d.get("overrides", [])))

    def canonical_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @property
    def spec_hash(self) -> str:
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()[:12]

    # --------------------------------------------------- compilation

    def legs(self) -> List[Dict]:
        """Compile to normalized, validated, key-stamped leg dicts.
        Deterministic order (grids in order, product axes in sorted
        name order, zip groups after); duplicate legs (same content
        hash) keep the first occurrence."""
        out: List[Dict] = []
        seen = set()
        for g in self.grids:
            for raw in g.combos():
                for o in self.overrides:
                    m = o.get("match", {})
                    if all(raw.get(k) == v for k, v in m.items()):
                        raw = {**raw, **o.get("set", {})}
                leg = _normalize_leg(raw, self.seed)
                if leg["key"] not in seen:
                    seen.add(leg["key"])
                    out.append(leg)
        return out


def leg_key(leg: Dict) -> str:
    """Content-hash key: sha256 of the canonical leg JSON (the ``key``
    field itself excluded)."""
    body = {k: v for k, v in leg.items() if k != "key"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _normalize_leg(raw: Dict, default_seed: int) -> Dict:
    mech = raw.get("mechanism")
    if mech not in MECHANISMS:
        raise SweepSpecError(
            f"unknown mechanism {mech!r} (want one of {MECHANISMS})")
    allowed = _LEG_FIELDS[mech]
    unknown = set(raw) - set(allowed)
    if unknown:
        raise SweepSpecError(
            f"unknown leg field(s) {sorted(unknown)} for mechanism "
            f"{mech!r} (allowed: {sorted(allowed)})")
    leg = {**_LEG_DEFAULTS[mech],
           "duration_ms": 30_000.0, "seed": default_seed, **raw}
    leg["duration_ms"] = float(leg["duration_ms"])
    leg["seed"] = int(leg["seed"])
    name = leg.get("scenario")
    if name not in SCENARIOS and name not in CLUSTER_SCENARIOS:
        raise SweepSpecError(
            f"unregistered scenario {name!r}; registered: "
            f"{sorted(SCENARIOS) + sorted(CLUSTER_SCENARIOS)}")
    pol = leg["policy"]
    if mech == "engine" and pol not in registered_policies():
        raise SweepSpecError(
            f"unregistered engine policy {pol!r}; registered: "
            f"{list(registered_policies())}")
    if mech == "simulator" and pol not in _SIM_POLICIES:
        raise SweepSpecError(
            f"simulator policy must be one of {_SIM_POLICIES}, "
            f"got {pol!r}")
    if mech == "cluster" and pol not in registered_cluster_policies():
        raise SweepSpecError(
            f"unregistered cluster policy {pol!r}; registered: "
            f"{list(registered_cluster_policies())}")
    if mech == "cluster" and leg["fault_plan"] is not None:
        from repro_torch.sched.faults import resolve_fault_plan
        try:
            resolve_fault_plan(leg["fault_plan"])
        except (KeyError, TypeError, ValueError) as e:
            raise SweepSpecError(
                f"bad fault_plan {leg['fault_plan']!r}: {e}") from None
        if isinstance(leg["fault_plan"], dict):
            leg["fault_plan"] = dict(sorted(leg["fault_plan"].items()))
    if mech == "engine" and leg["freq"] is not None:
        bad = set(leg["freq"]) - set(_FREQ_FIELDS)
        if bad:
            raise SweepSpecError(
                f"unknown FreqDomainConfig field(s) {sorted(bad)} "
                f"(allowed: {sorted(_FREQ_FIELDS)})")
        leg["freq"] = {k: (list(v) if isinstance(v, (list, tuple))
                           else v)
                       for k, v in sorted(leg["freq"].items())}
    ordered = {k: leg[k] for k in allowed}
    ordered["key"] = leg_key(ordered)
    return ordered


# -------------------------------------------------------- leg execution


def estimate_cost(leg: Dict) -> float:
    """Deterministic relative wall-cost estimate, used only for
    dispatch ordering (longest first). Calibrated against measured
    per-leg walls on the reference cell: cluster legs cost roughly one
    engine leg per shard, simulator legs ~1.5 engine legs, and
    everything scales with trace duration."""
    d = leg["duration_ms"]
    if leg["mechanism"] == "cluster":
        return d * 0.9 * leg["n_shards"] \
            * (leg["devices_per_shard"] / 16.0)
    if leg["mechanism"] == "simulator":
        return d * 1.5
    return d


def _leg_serve_config(leg: Dict) -> Optional[ServeConfig]:
    if leg.get("freq"):
        over = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in leg["freq"].items()}
        return ServeConfig(freq=replace(ENGINE_FREQ_MS, **over))
    return None


def run_leg(leg: Dict) -> Dict:
    """Execute one compiled leg — a pure function of the leg dict.
    Engine and cluster legs return the full ``replay_engine`` /
    ``replay_cluster`` result; simulator legs the ``run_trace_sim``
    dict. Byte-identical to the scenario-matrix legs of the same
    coordinates (same callees, same arguments)."""
    from repro_torch.sched.replay import (_leg_trace, replay_cluster,
                                    replay_engine)
    trace = _leg_trace(leg["scenario"], leg["duration_ms"], leg["seed"])
    mech = leg["mechanism"]
    if mech == "engine":
        return replay_engine(trace, leg["policy"],
                             n_devices=leg["n_devices"],
                             prefill_devices=leg["prefill_devices"],
                             cfg=_leg_serve_config(leg))
    if mech == "cluster":
        # an explicit leg fault_plan wins; None falls back to the
        # trace's own meta plan (the faults/* scenarios carry one)
        return replay_cluster(trace, leg["policy"],
                              n_shards=leg["n_shards"],
                              devices_per_shard=leg["devices_per_shard"],
                              prefill_devices=leg["prefill_devices"],
                              fault_plan=leg["fault_plan"])
    from repro_torch.core.experiments import run_trace_sim
    return run_trace_sim(trace, leg["policy"] == "specialized",
                         n_cores=leg["n_cores"], n_avx=leg["n_avx"],
                         isa=leg["isa"])


def _run_leg_timed(leg: Dict) -> Tuple[Dict, float]:
    t0 = time.perf_counter()
    return run_leg(leg), time.perf_counter() - t0


# Worker-side indirection: the pool submits `_leg_entry`, which calls
# whatever `_leg_runner` is bound to *in the worker process*. Fork-
# started workers inherit the parent's module state, so a test can
# monkeypatch `sweep._leg_runner` (after shutting the old pool down)
# to plant hangs or failures without the patch needing to pickle.
_leg_runner = _run_leg_timed


def _leg_entry(leg: Dict) -> Tuple[Dict, float]:
    return _leg_runner(leg)


# ------------------------------------------------------------ the cache


class SweepCache:
    """On-disk result cache keyed by leg content hash. One JSON file
    per leg (``<key>.json`` holding ``{"leg":..., "result":...}``);
    writes are atomic (tmp + rename) so an interrupted sweep never
    leaves a truncated entry. A hit is only served when the stored leg
    matches the requested one exactly (hash-collision/edit paranoia);
    anything unreadable is a miss."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def get(self, leg: Dict) -> Optional[Dict]:
        p = self._path(leg["key"])
        try:
            d = json.loads(p.read_text())
        except (OSError, ValueError):
            return None
        if d.get("leg") != json.loads(json.dumps(leg)):
            return None
        return d["result"]

    def put(self, leg: Dict, result: Dict) -> None:
        p = self._path(leg["key"])
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps({"leg": leg, "result": result},
                                  sort_keys=True))
        tmp.replace(p)


# -------------------------------------------------------------- runtime


def default_workers() -> int:
    """Kept as the canonical import site for older callers; the
    implementation (env override + CPU affinity) lives in
    ``repro_torch.sched.replay.default_workers``."""
    from repro_torch.sched.replay import default_workers as dw
    return dw()


def run_legs(legs: Sequence[Dict], *, workers: int = 1,
             cache: Optional[SweepCache] = None,
             leg_timeout_s: Optional[float] = None,
             on_result: Optional[Callable[[int, Dict, Dict], None]]
             = None) -> Tuple[List[Dict], Dict]:
    """Execute ``legs``, returning ``(results_in_input_order, stats)``.

    Cached legs are served from ``cache`` without dispatch. Pending
    legs are submitted **individually** (chunksize-1) in descending
    :func:`estimate_cost` order — the longest legs start first, so the
    straggler tail is at most one leg deep — and collected as they
    complete (streamed: each result is cached and handed to
    ``on_result(index, leg, result)`` immediately, no end-of-sweep
    barrier). ``workers <= 1`` runs inline, same ordering.

    ``leg_timeout_s`` (parallel path only — an inline leg cannot be
    preempted) bounds each leg's wall clock from the moment it occupies
    a worker slot: at most ``workers`` legs are outstanding at once, so
    the submit time IS the start time. A leg that blows its budget
    poisons the whole pool — the pool is killed (hung worker included),
    innocent in-flight legs resubmit at no charge, and the timed-out
    leg gets ONE retry on the fresh pool before being recorded in
    ``stats["failed_legs"]`` with a ``None`` result. Failed legs are
    never written to the cache.

    ``stats`` records workers / cpu_count / the ``REPRO_SWEEP_WORKERS``
    override / cache hit counts / wall seconds / per-leg walls /
    failed legs, and is the only part of a sweep result that is not a
    pure function of spec + seed."""
    from repro_torch.sched.replay import (_kill_pool, _leg_trace,
                                    _worker_pool, pool_failsafe)
    t0 = time.perf_counter()
    results: List[Optional[Dict]] = [None] * len(legs)
    walls: Dict[str, float] = {}
    failed: List[str] = []
    cached = 0
    pending: List[Tuple[int, Dict]] = []
    for i, leg in enumerate(legs):
        hit = cache.get(leg) if cache is not None else None
        if hit is not None:
            results[i] = hit
            cached += 1
            if on_result is not None:
                on_result(i, leg, hit)
        else:
            pending.append((i, leg))
    # longest-first; key tie-break keeps the order deterministic
    pending.sort(key=lambda p: (-estimate_cost(p[1]), p[1]["key"]))

    def _finish(i: int, leg: Dict, result: Dict, wall: float):
        results[i] = result
        walls[leg["key"]] = round(wall, 4)
        if cache is not None:
            cache.put(leg, result)
        if on_result is not None:
            on_result(i, leg, result)

    if workers > 1 and len(pending) > 1:
        # traces generate in the parent first: fork-started workers
        # inherit every frozen trace, zero pickling per leg
        for _, leg in pending:
            _leg_trace(leg["scenario"], leg["duration_ms"], leg["seed"])
        from concurrent.futures import FIRST_COMPLETED, wait
        waiting = list(pending)          # ordered longest-first
        timeouts: Dict[str, int] = {}    # leg key -> timed-out count
        running: Dict = {}               # future -> (i, leg, t_start)
        with pool_failsafe():
            pool = _worker_pool(workers)
            while waiting or running:
                # keep at most `workers` legs outstanding so every
                # submitted leg holds a slot and its clock is honest
                while waiting and len(running) < workers:
                    i, leg = waiting.pop(0)
                    fut = pool.submit(_leg_entry, leg)
                    running[fut] = (i, leg, time.monotonic())
                timeout = None
                if leg_timeout_s is not None:
                    deadline = min(ts + leg_timeout_s
                                   for _, _, ts in running.values())
                    timeout = max(0.0, deadline - time.monotonic())
                done, _ = wait(running, timeout=timeout,
                               return_when=FIRST_COMPLETED)
                for fut in done:
                    i, leg, ts = running.pop(fut)
                    result, wall = fut.result()
                    _finish(i, leg, result, wall)
                if leg_timeout_s is None:
                    continue
                now = time.monotonic()
                over = [fut for fut, (_, _, ts) in running.items()
                        if now - ts >= leg_timeout_s]
                if not over:
                    continue
                # a hung worker poisons the pool: kill it outright
                # (shutdown would join the hung process), resubmit the
                # innocent in-flight legs at no charge, and give each
                # timed-out leg one retry on the fresh pool
                for fut in over:
                    i, leg, ts = running.pop(fut)
                    n = timeouts[leg["key"]] = \
                        timeouts.get(leg["key"], 0) + 1
                    if n <= 1:
                        waiting.insert(0, (i, leg))
                    else:
                        failed.append(leg["key"])
                victims = sorted(running.values(), key=lambda v: v[0])
                running.clear()
                waiting[:0] = [(i, leg) for i, leg, _ in victims]
                _kill_pool()
                pool = _worker_pool(workers)
    else:
        for i, leg in pending:
            result, wall = _run_leg_timed(leg)
            _finish(i, leg, result, wall)
    stats = {
        "workers": max(1, workers),
        "cpu_count": os.cpu_count() or 1,
        "workers_env": os.environ.get("REPRO_SWEEP_WORKERS"),
        "n_legs": len(legs),
        "cached": cached,
        "ran": len(pending),
        "failed_legs": sorted(failed),
        "wall_s": round(time.perf_counter() - t0, 4),
        "leg_walls": walls,
    }
    return results, stats


# ---------------------------------------------------------- aggregation

# Metric columns lifted from each mechanism's result into a tidy row.
_ENGINE_METRICS = ("completed", "throughput_tok_s", "itl_p50_ms",
                   "itl_p99_ms", "itl_spread_ms", "ttft_p50_ms",
                   "ttft_p99_ms", "avg_freq_ghz", "license_residency",
                   "throttled_ms", "freq_transitions", "energy_proxy",
                   "handoffs")
_SIM_METRICS = ("completed", "latency_p50_us", "latency_p99_us",
                "avg_freq_ghz", "license_residency", "freq_transitions",
                "energy_proxy", "migrations")
# Fault/recovery accounting lifted from cluster summaries — the
# resilience table columns (repro_torch.sched.faults.resilience_rows).
_CLUSTER_FAULT_METRICS = ("injected", "shed_total", "expired_total",
                          "faults_injected", "shard_recoveries",
                          "drained", "retries", "dropped",
                          "brownout_hedges", "leftover")


def tidy_rows(legs: Sequence[Dict], results: Sequence[Dict]
              ) -> List[Dict]:
    """One flat dict per leg: the leg's axis coordinates (freq
    overrides flattened to ``freq.<field>`` columns) + the mechanism's
    headline metrics + ``n_violations``. The tidy table every
    downstream consumer (benchmarks, figures, reductions) reads.
    A ``None`` result (a leg that failed its wall-clock budget) keeps
    its coordinate row with ``failed: True`` — never silently
    dropped."""
    rows = []
    for leg, res in zip(legs, results):
        row = {k: v for k, v in leg.items() if k != "freq"}
        for k, v in (leg.get("freq") or {}).items():
            row[f"freq.{k}"] = v
        if res is None:
            row["failed"] = True
            row["n_violations"] = 0
        elif leg["mechanism"] == "simulator":
            for k in _SIM_METRICS:
                row[k] = res[k]
            row["itl_spread_us"] = res["latency_p99_us"] \
                - res["latency_p50_us"]
            row["n_violations"] = 0
        else:
            m = res["metrics"]
            for k in _ENGINE_METRICS:
                if k in m:
                    row[k] = m[k]
            if leg["mechanism"] == "cluster":
                row["router_holds"] = m.get("router_holds", 0)
                for k in _CLUSTER_FAULT_METRICS:
                    if k in m:
                        row[k] = m[k]
                # The *effective* plan: an explicit leg axis wins, else
                # the trace meta's plan — replay reports what it ran.
                if res.get("fault_plan") is not None:
                    row["fault_plan"] = res["fault_plan"]
            row["n_violations"] = res["n_violations"]
        rows.append(row)
    return rows


def baseline_deltas(rows: Sequence[Dict],
                    baseline_policy: str = "shared") -> List[Dict]:
    """Per-leg reductions vs the shared baseline sharing every other
    coordinate: the paper headline (variability/p99 reduction) plus
    energy and license-residency deltas, one row per non-baseline leg
    that has a baseline to compare against. Cluster legs compare
    against the *engine* shared baseline of the same scenario x
    duration x seed — the scale-out-vs-one-node question."""
    base: Dict[Tuple, Dict] = {}
    for r in rows:
        if r["policy"] == baseline_policy \
                and r["mechanism"] in ("engine", "simulator") \
                and not r.get("failed"):
            base[_base_coords(r, r["mechanism"])] = r
    out = []
    for r in rows:
        if r["policy"] == baseline_policy or r.get("failed"):
            continue
        mech = "engine" if r["mechanism"] == "cluster" \
            else r["mechanism"]
        b = base.get(_base_coords(r, mech))
        if b is None:
            continue
        p99, spread = ("latency_p99_us", "itl_spread_us") \
            if mech == "simulator" else ("itl_p99_ms", "itl_spread_ms")
        out.append({
            "mechanism": r["mechanism"], "scenario": r["scenario"],
            "policy": r["policy"], "duration_ms": r["duration_ms"],
            "seed": r["seed"], "key": r["key"],
            "baseline_key": b["key"],
            "itl_p99_reduction": 1.0 - r[p99] / max(b[p99], 1e-9),
            "variability_reduction":
                1.0 - r[spread] / max(b[spread], 1e-9),
            "energy_delta":
                r["energy_proxy"] / max(b["energy_proxy"], 1e-9) - 1.0,
            "residency_delta":
                r["license_residency"] - b["license_residency"],
        })
    return out


def _base_coords(row: Dict, mech: str) -> Tuple:
    # every axis except policy/mechanism; engine shape axes only when
    # the row itself is an engine row (a cluster leg's baseline is the
    # default-shape engine cell of the same trace)
    coords = [mech, row["scenario"], row["duration_ms"], row["seed"]]
    if mech == "engine" and row["mechanism"] == "engine":
        freq_sig = json.dumps(
            {k: v for k, v in row.items() if k.startswith("freq.")},
            sort_keys=True)
        coords += [row["n_devices"], row["prefill_devices"], freq_sig]
    if mech == "simulator":
        coords += [row["n_cores"], row["n_avx"], row["isa"]]
    return tuple(coords)


def reduce_rows(rows: Sequence[Dict], by: Sequence[str]) -> List[Dict]:
    """Group ``rows`` by the ``by`` columns and average every numeric
    column (plus ``n`` group size) — the per-axis reduction table.
    Groups come back in sorted key order; non-numeric columns are
    dropped."""
    groups: Dict[Tuple, List[Dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r.get(c) for c in by), []).append(r)
    out = []
    for gkey in sorted(groups, key=lambda k: tuple(str(x) for x in k)):
        rs = groups[gkey]
        row = dict(zip(by, gkey))
        row["n"] = len(rs)
        numeric = [k for k in rs[0]
                   if k not in by and k != "key"
                   and isinstance(rs[0][k], (int, float))
                   and not isinstance(rs[0][k], bool)]
        for k in numeric:
            vals = [r[k] for r in rs if isinstance(r.get(k),
                                                   (int, float))]
            if vals:
                row[k] = sum(vals) / len(vals)
        out.append(row)
    return out


# ------------------------------------------------------------ run_sweep


def run_sweep(spec: SweepSpec, *, workers: int = 1,
              cache_dir=None, seed: Optional[int] = None,
              leg_timeout_s: Optional[float] = None) -> Dict:
    """Compile and execute a sweep. Everything in the returned dict
    except ``_meta`` is a pure function of ``spec`` + ``seed``: legs
    compile deterministically, each leg is a pure function of its
    coordinates, and rows/deltas keep leg order — so a resumed sweep
    (warm cache) serializes byte-identically to a cold one. (A leg
    failed by ``leg_timeout_s`` is the one exception: its row carries
    ``failed: True`` and its key lands in ``_meta["failed_legs"]``.)"""
    if seed is not None and seed != spec.seed:
        spec = replace(spec, seed=seed)
    legs = spec.legs()
    cache = SweepCache(cache_dir) if cache_dir else None
    results, stats = run_legs(legs, workers=workers, cache=cache,
                              leg_timeout_s=leg_timeout_s)
    rows = tidy_rows(legs, results)
    return {
        "spec": spec.to_dict(),
        "spec_hash": spec.spec_hash,
        "n_legs": len(legs),
        "rows": rows,
        "deltas": baseline_deltas(rows),
        "n_violations": sum(r["n_violations"] for r in rows),
        "_meta": stats,
    }


def sweep_json(result: Dict, *, meta: bool = True) -> str:
    """Canonical serialization of a sweep result; ``meta=False`` drops
    the machine-dependent ``_meta`` block — the byte-identity contract
    surface (cold run == resumed run)."""
    body = result if meta else {k: v for k, v in result.items()
                                if k != "_meta"}
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


# -------------------------------------------------- matrix spec bridge


def matrix_spec(scenarios: Sequence[str], policies: Sequence[str], *,
                duration_ms: float = 30_000.0, seed: int = 0,
                n_devices: int = 16, prefill_devices: int = 4,
                simulator: bool = True, cluster: int = 0,
                cluster_policies: Sequence[str] = ()) -> SweepSpec:
    """The scenario matrix's default grid as a sweep spec — the proof
    that the spec grammar covers the existing harness. Compiling this
    spec yields exactly the matrix's legs (engine scenario x policy,
    optional N-shard cluster legs, optional simulator legs)."""
    grids = [AxisGrid(
        base={"mechanism": "engine", "duration_ms": duration_ms,
              "n_devices": n_devices,
              "prefill_devices": prefill_devices},
        axes={"scenario": tuple(scenarios), "policy": tuple(policies)})]
    if cluster:
        grids.append(AxisGrid(
            base={"mechanism": "cluster", "duration_ms": duration_ms,
                  "n_shards": cluster, "devices_per_shard": n_devices,
                  "prefill_devices": prefill_devices},
            axes={"scenario": tuple(scenarios),
                  "policy": tuple(cluster_policies)}))
    if simulator:
        grids.append(AxisGrid(
            base={"mechanism": "simulator", "duration_ms": duration_ms},
            axes={"scenario": tuple(scenarios),
                  "policy": _SIM_POLICIES}))
    return SweepSpec(name="matrix", grids=tuple(grids), seed=seed)


# -------------------------------------------------------------- presets

PRESETS: Dict[str, Callable[[], SweepSpec]] = {}


def register_preset(name: str, factory: Callable[[], SweepSpec]):
    PRESETS[name] = factory
    return factory


def preset_spec(name: str, *, seed: Optional[int] = None) -> SweepSpec:
    try:
        spec = PRESETS[name]()
    except KeyError:
        raise SweepSpecError(f"unknown preset {name!r}; registered: "
                             f"{sorted(PRESETS)}") from None
    if seed is not None and seed != spec.seed:
        spec = replace(spec, seed=seed)
    return spec


_MATRIX_SCENARIOS = ("bursty", "diurnal", "heavy_tail", "multi_tenant",
                     "steady")


def _bench_spec(smoke: bool) -> SweepSpec:
    """The committed BENCH trajectory sweep: >=500 legs (5 hand-tuned
    scenarios x 4 engine policies x 25 seeds) on the reference cell —
    the seed axis is what makes fleet-scale variability legible (25
    independent traces per cell, not one)."""
    return SweepSpec(
        name="bench-smoke" if smoke else "bench",
        grids=(AxisGrid(
            base={"mechanism": "engine",
                  "duration_ms": 6_000.0 if smoke else 12_000.0,
                  "n_devices": 8 if smoke else 16,
                  "prefill_devices": 2 if smoke else 4},
            axes={"scenario": _MATRIX_SCENARIOS,
                  "policy": tuple(registered_policies()),
                  "seed": tuple(range(25))}),))


register_preset("bench", lambda: _bench_spec(False))
register_preset("bench-smoke", lambda: _bench_spec(True))

register_preset("matrix", lambda: matrix_spec(
    sorted(SCENARIOS), registered_policies(), cluster=0))

# The CI smoke grid: every mechanism and every axis kind in one small
# sweep — engine topology shapes x a FrequencyDomain hysteresis axis
# (zipped with grant_delay to show lockstep axes), 2-shard cluster
# legs, simulator legs, and one override trimming the bursty legs.
register_preset("ci-smoke", lambda: SweepSpec(
    name="ci-smoke",
    grids=(
        AxisGrid(base={"mechanism": "engine", "duration_ms": 4_000.0,
                       "prefill_devices": 2},
                 axes={"scenario": ("steady", "bursty"),
                       "policy": ("shared", "specialized"),
                       "n_devices": (8, 12)},
                 zips=({"freq": (None, {"hysteresis": 4.0},
                                 {"hysteresis": 8.0}),
                        "seed": (0, 1, 2)},)),
        AxisGrid(base={"mechanism": "cluster", "duration_ms": 4_000.0,
                       "n_shards": 2, "devices_per_shard": 8,
                       "prefill_devices": 2},
                 axes={"scenario": ("fleet_steady",),
                       "policy": ("cluster-rr", "cluster-adaptive")}),
        AxisGrid(base={"mechanism": "simulator",
                       "duration_ms": 4_000.0},
                 axes={"scenario": ("steady",),
                       "policy": _SIM_POLICIES}),
    ),
    overrides=({"match": {"scenario": "bursty"},
                "set": {"duration_ms": 3_000.0}},)))

# Frequency-physics sweep: how the headline responds to the license
# machine's revert hysteresis and grant window — the FrequencyDomain
# config axis at depth.
register_preset("freq-hysteresis", lambda: SweepSpec(
    name="freq-hysteresis",
    grids=(AxisGrid(
        base={"mechanism": "engine", "duration_ms": 15_000.0},
        axes={"scenario": ("steady", "bursty", "heavy_tail"),
              "policy": ("shared", "specialized"),
              "freq": (None, {"hysteresis": 1.0}, {"hysteresis": 4.0},
                       {"hysteresis": 8.0},
                       {"grant_delay": 0.1}, {"grant_delay": 2.0}),
              "seed": (0, 1, 2)}),)))

# Cluster-shape sweep: shard-count scaling of the fleet scenarios
# (the no-fault family — the faults/* scenarios have their own preset).
register_preset("cluster-scaling", lambda: SweepSpec(
    name="cluster-scaling",
    grids=(AxisGrid(
        base={"mechanism": "cluster", "duration_ms": 20_000.0},
        axes={"scenario": tuple(s for s in sorted(CLUSTER_SCENARIOS)
                                if not s.startswith("faults/")),
              "policy": ("cluster-rr", "cluster-freq",
                         "cluster-adaptive"),
              "n_shards": (1, 2, 4, 8)}),)))


# Chaos sweeps: the faults/* scenario family (each trace carries its
# registered FaultPlan) under both cluster policies, plus the
# failure-rate x detection-latency crash grid on the crash trace with
# an all-zero "none" plan as the no-fault control leg (same machinery,
# zero injected faults — the honest degradation baseline).
def _faults_spec(smoke: bool) -> SweepSpec:
    # Both tiers keep the reference 4x16 cell: the faults/* arrival
    # rates saturate a smaller cell, which would turn the exact
    # conservation identity (injected == completed + shed + expired,
    # leftover 0) into a backlog statement. Smoke trims duration only —
    # 20s still covers the seed-0 crash stream's first failure
    # (s2 @ 19013ms), so the recovery path stays exercised.
    dur = 20_000.0 if smoke else 30_000.0
    base = {"mechanism": "cluster", "duration_ms": dur,
            "n_shards": 4, "devices_per_shard": 16,
            "prefill_devices": 4}
    return SweepSpec(
        name="faults-smoke" if smoke else "faults",
        grids=(
            AxisGrid(
                base=dict(base),
                axes={"scenario": tuple(
                          s for s in sorted(CLUSTER_SCENARIOS)
                          if s.startswith("faults/")),
                      "policy": ("cluster-rr", "cluster-adaptive")}),
            AxisGrid(
                base={**base, "scenario": "faults/crash",
                      "policy": "cluster-adaptive"},
                axes={"fault_plan": ("none",
                                     "crash-r1-d250", "crash-r1-d1000",
                                     "crash-r3-d250",
                                     "crash-r3-d1000")}),
        ))


register_preset("faults", lambda: _faults_spec(False))
register_preset("faults-smoke", lambda: _faults_spec(True))


# ------------------------------------------------------------------ CLI


def _print_table(result: Dict) -> None:
    rows = result["rows"]
    red = reduce_rows(rows, by=["mechanism", "scenario", "policy"])
    print(f"{'mechanism':<10} {'scenario':<14} {'policy':<18} "
          f"{'n':>4} {'p99':>9} {'spread':>9} {'freq':>6} "
          f"{'energy':>10} {'viol':>5}")
    for r in red:
        p99 = r.get("itl_p99_ms", r.get("latency_p99_us", 0.0))
        spread = r.get("itl_spread_ms", r.get("itl_spread_us", 0.0))
        print(f"{r['mechanism']:<10} {r['scenario']:<14} "
              f"{r['policy']:<18} {r['n']:>4} {p99:>9.1f} "
              f"{spread:>9.1f} {r.get('avg_freq_ghz', 0.0):>6.2f} "
              f"{r.get('energy_proxy', 0.0):>10.0f} "
              f"{r.get('n_violations', 0):>5.0f}")
    dred = reduce_rows(result["deltas"],
                       by=["mechanism", "scenario", "policy"])
    for r in dred:
        print(f"{r['mechanism']:<10} {r['scenario']:<14} "
              f"-> {r['policy']}/shared: "
              f"variability_reduction="
              f"{100 * r['variability_reduction']:.0f}% "
              f"p99_reduction={100 * r['itl_p99_reduction']:.0f}% "
              f"energy_delta={100 * r['energy_delta']:+.0f}% "
              f"residency_delta={r['residency_delta']:+.3f}")


def main(argv=None) -> int:
    from repro_torch.sched.replay import default_workers as dw
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--preset", default=None,
                     help=f"registered sweep preset "
                          f"({', '.join(sorted(PRESETS))})")
    src.add_argument("--spec", type=Path, default=None,
                     help="sweep spec JSON file (SweepSpec.to_dict "
                          "shape)")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--legs-only", action="store_true",
                    help="compile and print the leg count + keys, "
                         "do not run")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's default trace seed")
    ap.add_argument("--parallel", type=int, nargs="?", const=-1,
                    default=0, metavar="N",
                    help="worker processes (bare --parallel = "
                         "CPU-aware default, honoring "
                         "REPRO_SWEEP_WORKERS; 0/1 = serial)")
    ap.add_argument("--leg-timeout", type=float, default=None,
                    metavar="SEC",
                    help="per-leg wall-clock timeout (parallel runs "
                         "only); a timed-out leg gets one retry on a "
                         "fresh worker before it is recorded in "
                         "failed_legs")
    ap.add_argument("--cache-dir", type=Path, default=None,
                    help="on-disk leg result cache; an interrupted or "
                         "incremental sweep resumes here by skipping "
                         "completed legs")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless every leg was served from the "
                         "cache (CI resume gate)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full sweep result JSON")
    ap.add_argument("--table", action="store_true",
                    help="print the reduced per-axis table")
    args = ap.parse_args(argv)
    if args.list_presets:
        for name in sorted(PRESETS):
            print(f"{name:<18} {preset_spec(name).spec_hash} "
                  f"{len(preset_spec(name).legs())} legs")
        return 0
    if args.spec is not None:
        spec = SweepSpec.from_dict(json.loads(args.spec.read_text()))
    else:
        spec = preset_spec(args.preset or "ci-smoke")
    if args.seed is not None:
        spec = replace(spec, seed=args.seed)
    legs = spec.legs()
    if args.legs_only:
        print(f"{spec.name}: {len(legs)} legs "
              f"(spec {spec.spec_hash})")
        for leg in legs[:20]:
            print(f"  {leg['key']}  {leg['mechanism']}/"
                  f"{leg['scenario']}/{leg['policy']} seed={leg['seed']}")
        if len(legs) > 20:
            print(f"  ... {len(legs) - 20} more")
        return 0
    workers = dw() if args.parallel < 0 else max(1, args.parallel)
    result = run_sweep(spec, workers=workers, cache_dir=args.cache_dir,
                       leg_timeout_s=args.leg_timeout)
    meta = result["_meta"]
    if meta.get("failed_legs"):
        print(f"FAILED LEGS ({len(meta['failed_legs'])}): "
              f"{', '.join(meta['failed_legs'])}")
    if args.table:
        _print_table(result)
    print(f"sweep {spec.name} ({spec.spec_hash}): {result['n_legs']} "
          f"legs, {meta['cached']} cached + {meta['ran']} ran in "
          f"{meta['wall_s']:.2f}s across {meta['workers']} worker(s) "
          f"[cpu_count={meta['cpu_count']}, "
          f"REPRO_SWEEP_WORKERS={meta['workers_env'] or '-'}]")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1,
                                       sort_keys=True))
        print(f"sweep -> {args.out}")
    if args.expect_cached and meta["ran"] > 0:
        print(f"EXPECTED FULL CACHE RESUME but {meta['ran']} legs ran")
        return 1
    if result["n_violations"]:
        print(f"ORACLE VIOLATIONS: {result['n_violations']}")
        return 1
    if meta.get("failed_legs"):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
