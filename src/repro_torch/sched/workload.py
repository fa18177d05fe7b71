"""Scenario workload subsystem: composable, seeded, trace-serializable
request generators for the serving engine and the OS simulator.

The paper's claim — >70% reduction in AVX-induced performance
variability — is only credible across *workloads*: Schuchart et al.
argue that performance variation at scale must be characterized under
diverse, bursty load, not one well-behaved arrival process. This module
factors a workload into three orthogonal, individually seeded pieces:

  * an **arrival process** (`PoissonArrivals`, bursty on/off
    `MMPPArrivals`, sinusoidal `DiurnalArrivals`) producing arrival
    times over a duration;
  * **length distributions** (`FixedLen`, `UniformLen`, heavy-tailed
    `LognormalLen`, `ZipfLen`) for prompt and output token counts;
  * **tenants** (`Tenant`) — SLO classes sampled per request, each with
    its own deadline window (EDF input) and traffic weight.

A :class:`WorkloadSpec` combines them and generates a :class:`Trace` —
a plain list of request records that serializes to/from *canonical*
JSON (same seed ⇒ byte-identical bytes), so every experiment is a
replayable artifact. `SCENARIOS` registers the named scenario matrix
the differential replay harness (`repro_torch.sched.replay`) and the tier-1
suite (`tests/test_scenarios.py`) run every policy against.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sched.engine import Request

# ------------------------------------------------------------- arrivals


@dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless arrivals at a constant rate (the original baseline)."""
    rate_per_s: float

    def times(self, duration_ms: float, rng: np.random.Generator
              ) -> List[float]:
        out, t = [], 0.0
        while True:
            t += rng.exponential(1000.0 / self.rate_per_s)
            if t >= duration_ms:
                return out
            out.append(t)


@dataclass(frozen=True)
class MMPPArrivals:
    """2-state Markov-modulated Poisson process: exponential ON bursts
    at ``rate_on_per_s`` alternating with quiet OFF stretches — the
    classic bursty-traffic model (flash crowds, batch ingest)."""
    rate_on_per_s: float
    rate_off_per_s: float
    mean_on_ms: float
    mean_off_ms: float

    def times(self, duration_ms: float, rng: np.random.Generator
              ) -> List[float]:
        out, t, on = [], 0.0, True
        while t < duration_ms:
            phase = rng.exponential(self.mean_on_ms if on
                                    else self.mean_off_ms)
            rate = self.rate_on_per_s if on else self.rate_off_per_s
            end = min(t + phase, duration_ms)
            if rate > 0:
                tt = t
                while True:
                    tt += rng.exponential(1000.0 / rate)
                    if tt >= end:
                        break
                    out.append(tt)
            t += phase
            on = not on
        return out


@dataclass(frozen=True)
class DiurnalArrivals:
    """Sinusoidally modulated Poisson rate (diurnal load curve),
    sampled by thinning against the peak rate."""
    base_rate_per_s: float
    amplitude: float = 0.6          # 0..1 fraction of base
    period_ms: float = 20_000.0
    phase: float = 0.0

    def rate_at(self, t_ms: float) -> float:
        return self.base_rate_per_s * (
            1.0 + self.amplitude
            * math.sin(2.0 * math.pi * t_ms / self.period_ms + self.phase))

    def times(self, duration_ms: float, rng: np.random.Generator
              ) -> List[float]:
        peak = self.base_rate_per_s * (1.0 + abs(self.amplitude))
        out, t = [], 0.0
        while True:
            t += rng.exponential(1000.0 / peak)
            if t >= duration_ms:
                return out
            if rng.random() * peak < self.rate_at(t):
                out.append(t)


# -------------------------------------------------------------- lengths


@dataclass(frozen=True)
class FixedLen:
    n: int

    def sample(self, rng: np.random.Generator) -> int:
        return self.n


@dataclass(frozen=True)
class UniformLen:
    lo: int
    hi: int

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.uniform(self.lo, self.hi))


@dataclass(frozen=True)
class LognormalLen:
    """Heavy-tailed lengths around ``median`` (exp-normal), clipped."""
    median: float
    sigma: float = 0.7
    lo: int = 16
    hi: int = 16_384

    def sample(self, rng: np.random.Generator) -> int:
        v = math.exp(rng.normal(math.log(self.median), self.sigma))
        return int(min(max(v, self.lo), self.hi))


@dataclass(frozen=True)
class ZipfLen:
    """Zipf-tailed lengths: ``lo`` plus a Zipf(alpha) draw, clipped at
    ``hi`` — most requests short, a fat tail of very long ones."""
    alpha: float = 1.6
    lo: int = 16
    hi: int = 1_024

    def sample(self, rng: np.random.Generator) -> int:
        return int(min(self.lo + int(rng.zipf(self.alpha)) - 1, self.hi))


# -------------------------------------------------------------- tenants


@dataclass(frozen=True)
class Tenant:
    """An SLO class: sampled per request with probability proportional
    to ``weight``; its deadline window feeds the engine's EDF order."""
    name: str = "default"
    weight: float = 1.0
    deadline_window_ms: Optional[float] = None   # None = engine default


# ------------------------------------------------------- spec and trace

_ARRIVALS = {"poisson": PoissonArrivals, "mmpp": MMPPArrivals,
             "diurnal": DiurnalArrivals}
_LENGTHS = {"fixed": FixedLen, "uniform": UniformLen,
            "lognormal": LognormalLen, "zipf": ZipfLen}


def _tag(obj, registry: Dict[str, type]) -> Dict:
    for kind, cls in registry.items():
        if type(obj) is cls:
            return {"kind": kind, **asdict(obj)}
    raise TypeError(f"unregistered component: {obj!r}")


def _untag(d: Dict, registry: Dict[str, type]):
    d = dict(d)
    return registry[d.pop("kind")](**d)


@dataclass
class TraceRequest:
    """One serialized request: everything either mechanism needs."""
    rid: int
    arrive_ms: float
    prompt_len: int
    max_new: int
    tenant: str = "default"
    deadline_window_ms: Optional[float] = None


@dataclass(frozen=True)
class WorkloadSpec:
    """A fully described workload: arrivals x lengths x tenants.

    ``generate()`` is deterministic in ``seed``; the spec itself
    round-trips through ``to_dict``/``from_dict`` so traces carry their
    provenance.
    """
    name: str
    arrival: object
    prompt_lens: object = UniformLen(1024, 3072)
    output_lens: object = FixedLen(64)
    tenants: Tuple[Tenant, ...] = (Tenant(),)
    duration_ms: float = 30_000.0
    seed: int = 0
    # per-token simulator replay costs derived by the static-analysis
    # calibration (repro_torch.analysis.calibrate); None = the hand-tuned
    # defaults in core.workloads. Carried into Trace.meta so the OS
    # simulator legs replay a model-shaped duty cycle.
    sim_work: Optional[Dict] = None
    # registered fault-plan name (repro_torch.sched.faults.FAULT_PLANS);
    # carried into Trace.meta so cluster replays of this workload run
    # under injection by default. None (the default) is OMITTED from
    # to_dict/meta — existing spec hashes and trace bytes are untouched.
    fault_plan: Optional[str] = None

    def generate(self, *, duration_ms: Optional[float] = None,
                 seed: Optional[int] = None) -> "Trace":
        dur = self.duration_ms if duration_ms is None else duration_ms
        sd = self.seed if seed is None else seed
        rng = np.random.default_rng(sd)
        weights = np.array([t.weight for t in self.tenants], dtype=float)
        weights = weights / weights.sum()
        reqs = []
        for rid, t in enumerate(self.arrival.times(dur, rng)):
            tenant = self.tenants[int(rng.choice(len(self.tenants),
                                                 p=weights))]
            reqs.append(TraceRequest(
                rid=rid, arrive_ms=round(t, 6),
                prompt_len=max(1, self.prompt_lens.sample(rng)),
                max_new=max(1, self.output_lens.sample(rng)),
                tenant=tenant.name,
                deadline_window_ms=tenant.deadline_window_ms))
        meta = {"scenario": self.name, "seed": sd,
                "duration_ms": dur, "spec": self.to_dict()}
        if self.sim_work:
            meta["sim_work"] = dict(self.sim_work)
        if self.fault_plan:
            meta["fault_plan"] = self.fault_plan
        return Trace(meta=meta, requests=reqs)

    def to_dict(self) -> Dict:
        out = {
            "name": self.name,
            "arrival": _tag(self.arrival, _ARRIVALS),
            "prompt_lens": _tag(self.prompt_lens, _LENGTHS),
            "output_lens": _tag(self.output_lens, _LENGTHS),
            "tenants": [asdict(t) for t in self.tenants],
            "duration_ms": self.duration_ms,
            "seed": self.seed,
            "sim_work": dict(self.sim_work) if self.sim_work else None,
        }
        if self.fault_plan:
            out["fault_plan"] = self.fault_plan
        return out

    @staticmethod
    def from_dict(d: Dict) -> "WorkloadSpec":
        return WorkloadSpec(
            name=d["name"],
            arrival=_untag(d["arrival"], _ARRIVALS),
            prompt_lens=_untag(d["prompt_lens"], _LENGTHS),
            output_lens=_untag(d["output_lens"], _LENGTHS),
            tenants=tuple(Tenant(**t) for t in d["tenants"]),
            duration_ms=d["duration_ms"],
            seed=d["seed"],
            sim_work=d.get("sim_work") or None,
            fault_plan=d.get("fault_plan") or None,
        )


@dataclass
class Trace:
    """A generated (or hand-written) request trace + its provenance."""
    meta: Dict = field(default_factory=dict)
    requests: List[TraceRequest] = field(default_factory=list)

    # -------------------------------------------------- serialization

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, no whitespace — the same trace
        always produces byte-identical output (determinism tests pin
        this)."""
        return json.dumps(
            {"meta": self.meta,
             "requests": [asdict(r) for r in self.requests]},
            sort_keys=True, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "Trace":
        d = json.loads(s)
        return Trace(meta=d.get("meta", {}),
                     requests=[TraceRequest(**r)
                               for r in d.get("requests", [])])

    def save(self, path) -> None:
        from pathlib import Path
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path) -> "Trace":
        from pathlib import Path
        return Trace.from_json(Path(path).read_text())

    # ---------------------------------------------------- conversions

    def to_engine_requests(self) -> List[Request]:
        """Fresh engine Requests (progress fields zeroed) every call —
        a trace can be replayed any number of times."""
        return [Request(rid=r.rid, arrive_ms=r.arrive_ms,
                        prompt_len=r.prompt_len, max_new=r.max_new,
                        tenant=r.tenant,
                        deadline_window_ms=r.deadline_window_ms)
                for r in self.requests]

    @property
    def duration_ms(self) -> float:
        """Declared duration, falling back to the latest arrival for
        hand-written traces without meta. Consumers using this as a
        horizon must add drain slack (see ``replay_engine``'s
        ``drain_ms``) or the last arrival lands exactly on the horizon
        and is dropped."""
        if "duration_ms" in self.meta:
            return float(self.meta["duration_ms"])
        return max((r.arrive_ms for r in self.requests), default=0.0)


# ---------------------------------------------------- scenario registry

# Rates are calibrated for the reference replay cell (16 devices, 4 of
# them prefill, the test PoolModel): moderate decode utilization, so the
# shared baseline's interleaved prefills visibly stall decodes while the
# specialized split keeps the tail flat — every scenario must separate
# the two policies, or it gates nothing.
SCENARIOS: Dict[str, Callable[[], WorkloadSpec]] = {}


def register_scenario(name: str, factory: Callable[[], WorkloadSpec]):
    SCENARIOS[name] = factory
    return factory


register_scenario("steady", lambda: WorkloadSpec(
    name="steady",
    arrival=PoissonArrivals(rate_per_s=3.2)))

register_scenario("bursty", lambda: WorkloadSpec(
    name="bursty",
    arrival=MMPPArrivals(rate_on_per_s=8.0, rate_off_per_s=0.4,
                         mean_on_ms=1_500.0, mean_off_ms=2_500.0)))

register_scenario("diurnal", lambda: WorkloadSpec(
    name="diurnal",
    arrival=DiurnalArrivals(base_rate_per_s=3.0, amplitude=0.7,
                            period_ms=12_000.0),
    output_lens=FixedLen(48)))

register_scenario("heavy_tail", lambda: WorkloadSpec(
    name="heavy_tail",
    arrival=PoissonArrivals(rate_per_s=2.5),
    prompt_lens=LognormalLen(median=1_800.0, sigma=0.7, lo=256, hi=8_192),
    output_lens=ZipfLen(alpha=1.6, lo=32, hi=256)))

register_scenario("multi_tenant", lambda: WorkloadSpec(
    name="multi_tenant",
    arrival=PoissonArrivals(rate_per_s=3.2),
    tenants=(Tenant("interactive", weight=0.5, deadline_window_ms=20.0),
             Tenant("standard", weight=0.3, deadline_window_ms=50.0),
             Tenant("batch", weight=0.2, deadline_window_ms=500.0))))


# Model-derived scenarios: one `zoo/<arch>` entry per architecture in
# configs/, stamped by the static-analysis calibration pass
# (`python -m repro.analysis.calibrate --update` -> analysis/derived.json, copied).
# Prompt/output shapes follow the model family, the Poisson rate holds
# the reference cell at the `steady` prefill-token operating point, and
# `sim_work` carries analyzer-derived per-token replay costs so the OS
# simulator legs see each model's duty cycle. The loader is pure JSON —
# no jax in this import path (replay workers import this module).


def _register_zoo_scenarios() -> None:
    from repro_torch.analysis import derived
    for arch in derived.workload_ids():
        params = derived.scenario_params(arch)

        def factory(arch=arch, params=params) -> WorkloadSpec:
            return WorkloadSpec(
                name=f"zoo/{arch}",
                arrival=PoissonArrivals(rate_per_s=params["rate_per_s"]),
                prompt_lens=_untag(params["prompt"], _LENGTHS),
                output_lens=_untag(params["output"], _LENGTHS),
                sim_work=dict(params["sim_work"]))
        register_scenario(f"zoo/{arch}", factory)


_register_zoo_scenarios()


# Multi-node scenarios: aggregate rates sized for a sharded fleet (a
# 4-node cluster of reference cells), not one node — the single-node
# engine saturates on these, which is the point: they exercise the
# router's admission control and the cluster policies' load spreading.
# A separate registry keeps the tier-1 single-node matrix (which
# pins set(cells) == set(SCENARIOS)) unchanged; `scenario_spec` /
# `scenario_trace` resolve names from either registry.
CLUSTER_SCENARIOS: Dict[str, Callable[[], WorkloadSpec]] = {}


def register_cluster_scenario(name: str,
                              factory: Callable[[], WorkloadSpec]):
    CLUSTER_SCENARIOS[name] = factory
    return factory


register_cluster_scenario("fleet_steady", lambda: WorkloadSpec(
    name="fleet_steady",
    arrival=PoissonArrivals(rate_per_s=10.0)))

register_cluster_scenario("fleet_surge", lambda: WorkloadSpec(
    name="fleet_surge",
    arrival=MMPPArrivals(rate_on_per_s=24.0, rate_off_per_s=2.0,
                         mean_on_ms=1_500.0, mean_off_ms=2_500.0)))

register_cluster_scenario("fleet_mixed", lambda: WorkloadSpec(
    name="fleet_mixed",
    arrival=DiurnalArrivals(base_rate_per_s=9.0, amplitude=0.6,
                            period_ms=15_000.0),
    prompt_lens=LognormalLen(median=1_600.0, sigma=0.6, lo=256,
                             hi=8_192),
    tenants=(Tenant("interactive", weight=0.5, deadline_window_ms=20.0),
             Tenant("standard", weight=0.3, deadline_window_ms=50.0),
             Tenant("batch", weight=0.2, deadline_window_ms=500.0))))


# Fault-injection scenarios (repro_torch.sched.faults): each pairs a fleet
# workload with a registered FaultPlan, carried in Trace.meta so
# `replay_cluster` (and sweep cluster legs) run it under injection by
# default. The tenants give the router's graceful-degradation shedding
# a real SLO-class ladder to walk (batch sheds first). Windows are
# sized against the reference cell's ~6s end-to-end latency: a drained
# interactive request still has budget to retry and complete on a
# survivor, while a crash-length pile-up does push past the windows —
# expiry and shedding stay observable, not inevitable.

_FAULT_TENANTS = (
    Tenant("interactive", weight=0.5, deadline_window_ms=15_000.0),
    Tenant("standard", weight=0.3, deadline_window_ms=30_000.0),
    Tenant("batch", weight=0.2, deadline_window_ms=120_000.0))

register_cluster_scenario("faults/crash", lambda: WorkloadSpec(
    name="faults/crash",
    arrival=PoissonArrivals(rate_per_s=10.0),
    tenants=_FAULT_TENANTS,
    fault_plan="crash"))

register_cluster_scenario("faults/brownout", lambda: WorkloadSpec(
    name="faults/brownout",
    arrival=MMPPArrivals(rate_on_per_s=24.0, rate_off_per_s=2.0,
                         mean_on_ms=1_500.0, mean_off_ms=2_500.0),
    tenants=_FAULT_TENANTS,
    fault_plan="brownout"))

register_cluster_scenario("faults/straggler", lambda: WorkloadSpec(
    name="faults/straggler",
    arrival=PoissonArrivals(rate_per_s=10.0),
    tenants=_FAULT_TENANTS,
    fault_plan="straggler"))

register_cluster_scenario("faults/flaky", lambda: WorkloadSpec(
    name="faults/flaky",
    arrival=PoissonArrivals(rate_per_s=10.0),
    tenants=_FAULT_TENANTS,
    fault_plan="flaky"))

register_cluster_scenario("faults/storm", lambda: WorkloadSpec(
    name="faults/storm",
    arrival=DiurnalArrivals(base_rate_per_s=9.0, amplitude=0.6,
                            period_ms=15_000.0),
    prompt_lens=LognormalLen(median=1_600.0, sigma=0.6, lo=256,
                             hi=8_192),
    tenants=_FAULT_TENANTS,
    fault_plan="storm"))


def scenario_spec(name: str) -> WorkloadSpec:
    factory = SCENARIOS.get(name) or CLUSTER_SCENARIOS.get(name)
    if factory is None:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{sorted(SCENARIOS) + sorted(CLUSTER_SCENARIOS)}")
    return factory()


def scenario_trace(name: str, *, duration_ms: Optional[float] = None,
                   seed: int = 0) -> Trace:
    return scenario_spec(name).generate(duration_ms=duration_ms, seed=seed)


def load_trace(source: str, *, duration_ms: Optional[float] = None,
               seed: int = 0) -> Trace:
    """Resolve a ``--workload`` argument: a registered scenario name or
    a path to a JSON trace file."""
    if source in SCENARIOS or source in CLUSTER_SCENARIOS:
        return scenario_trace(source, duration_ms=duration_ms, seed=seed)
    return Trace.load(source)


# ------------------------------------------------------- compat helper


def poisson_workload(rate_per_s: float, duration_ms: float, *,
                     prompt_len=4096, max_new=128, seed=0) -> List[Request]:
    """The original ad-hoc generator, preserved draw-for-draw (exponential
    gap then uniform 0.5-1.5x prompt scale per request, single stream)
    so seeds produce the exact workloads the existing suites were tuned
    against. New code should use a :class:`WorkloadSpec` / scenario."""
    rng = np.random.default_rng(seed)
    out, t, rid = [], 0.0, 0
    while t < duration_ms:
        t += rng.exponential(1000.0 / rate_per_s)
        pl_ = int(prompt_len * rng.uniform(0.5, 1.5))
        out.append(Request(rid=rid, arrive_ms=t, prompt_len=pl_,
                           max_new=max_new))
        rid += 1
    return out
