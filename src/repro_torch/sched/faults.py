"""Deterministic fault injection for the cluster tier.

The paper's premise is that hardware degrades intermittently under the
OS: AVX-heavy work drops a core's license level and the whole frequency
domain slows down for a hysteresis window.  At fleet scale those
per-node excursions look like partial failures — slow or silent nodes,
not cleanly dead ones (PAPERS.md: "The Shift from Processor Power
Consumption to Performance Variations at Scale").  The cluster tier
therefore treats failures as first-class, injectable, oracle-checked
events:

  * ``shard_fail`` / ``shard_recover`` — crash-stop: the shard freezes
    mid-simulation, the router keeps feeding it until the failure is
    *detected* (``detection_latency_ms`` later), then the ClusterEngine
    drains every queued and in-flight-but-unacked request back into the
    router with its remaining deadline budget;
  * ``shard_brownout`` — the paper's throttle reframed as a fault: the
    shard's FrequencyDomains are clamped to a low license level for a
    window, so the frequency-aware router sees it as degraded;
  * ``straggler`` — executor durations on one shard are multiplied for
    a window (slow node, not dead node);
  * ``drop`` — an in-flight request is lost at completion time, decided
    per ``(seed, rid, attempt)`` so retries re-roll the dice.

A :class:`FaultPlan` is seeded and canonically serializable
(``to_dict``/``from_dict`` + ``plan_hash``, the WorkloadSpec
discipline): the same plan always yields a byte-identical fault event
stream, so cluster replays under faults stay deterministic, cacheable,
and sweepable (``fault_plan`` is a cluster sweep axis in
``sched/sweep.py``).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, fields
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# Typed fault-event kinds emitted into the cluster's global event heap.
FAULT_KINDS = ("shard_fail", "shard_recover", "shard_brownout",
               "straggler")

# Substream ids: each (fault type, shard) pair draws from an
# independent seeded stream so adding one fault type or shard never
# perturbs the others' arrival times.
_STREAMS = {"fail": 1, "brownout": 2, "straggler": 3}


@dataclass(frozen=True)
class FaultEvent:
    """One typed fault event, scheduled at absolute sim time ``t``."""

    t: float
    kind: str
    shard: str
    duration_ms: float = 0.0
    level: int = 0          # brownout clamp level (license index)
    factor: float = 1.0     # straggler duration multiplier

    def to_dict(self) -> Dict[str, object]:
        return {
            "t": self.t,
            "kind": self.kind,
            "shard": self.shard,
            "duration_ms": self.duration_ms,
            "level": self.level,
            "factor": self.factor,
        }


@dataclass(frozen=True)
class FaultPlan:
    """Seeded generative description of a fault schedule.

    Rates are per-shard Poisson arrival rates (events per minute of sim
    time); windows and latencies are in sim milliseconds.  ``events``
    expands the plan against a concrete shard list and horizon into a
    deterministic, sorted :class:`FaultEvent` stream.
    """

    name: str
    seed: int = 0
    # crash-stop
    fail_rate_per_min: float = 0.0
    fail_duration_ms: float = 4000.0
    detection_latency_ms: float = 250.0
    # brownout (license clamp)
    brownout_rate_per_min: float = 0.0
    brownout_duration_ms: float = 2500.0
    brownout_level: int = 2
    # straggler (slow node)
    straggler_rate_per_min: float = 0.0
    straggler_duration_ms: float = 2500.0
    straggler_factor: float = 3.0
    # response loss at completion time
    drop_prob: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("FaultPlan needs a name")
        if not (0.0 <= self.drop_prob < 1.0):
            raise ValueError(f"drop_prob out of range: {self.drop_prob}")
        for f in ("fail_rate_per_min", "brownout_rate_per_min",
                  "straggler_rate_per_min", "fail_duration_ms",
                  "detection_latency_ms", "brownout_duration_ms",
                  "straggler_duration_ms"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1")
        if self.brownout_level < 0:
            raise ValueError("brownout_level must be >= 0")

    # ------------------------------------------------- serialization

    def to_dict(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "FaultPlan":
        known = {f.name for f in fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FaultPlan keys: {sorted(extra)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @property
    def plan_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    # ------------------------------------------------- event stream

    def _arrivals(self, rng: np.random.Generator, rate_per_min: float,
                  horizon_ms: float) -> List[float]:
        if rate_per_min <= 0.0 or horizon_ms <= 0.0:
            return []
        mean_gap = 60_000.0 / rate_per_min
        out: List[float] = []
        t = float(rng.exponential(mean_gap))
        while t < horizon_ms:
            out.append(t)
            t += float(rng.exponential(mean_gap))
        return out

    def events(self, shard_names: Sequence[str],
               horizon_ms: float) -> List[FaultEvent]:
        """Expand the plan into a sorted, deterministic event stream.

        Crash windows on one shard never overlap (a follow-up arrival
        inside ``fail + detection + duration`` of the previous crash is
        skipped), and every ``shard_fail`` carries a paired
        ``shard_recover`` at ``t + fail_duration_ms`` so the stream is
        self-contained.
        """
        out: List[FaultEvent] = []
        for idx, name in enumerate(shard_names):
            rng = np.random.default_rng(
                (self.seed, _STREAMS["fail"], idx))
            clear_at = 0.0
            for t in self._arrivals(rng, self.fail_rate_per_min,
                                    horizon_ms):
                if t < clear_at:
                    continue
                out.append(FaultEvent(t, "shard_fail", name,
                                      duration_ms=self.fail_duration_ms))
                out.append(FaultEvent(t + self.fail_duration_ms,
                                      "shard_recover", name))
                clear_at = (t + self.fail_duration_ms
                            + self.detection_latency_ms + 500.0)
            rng = np.random.default_rng(
                (self.seed, _STREAMS["brownout"], idx))
            for t in self._arrivals(rng, self.brownout_rate_per_min,
                                    horizon_ms):
                out.append(FaultEvent(
                    t, "shard_brownout", name,
                    duration_ms=self.brownout_duration_ms,
                    level=self.brownout_level))
            rng = np.random.default_rng(
                (self.seed, _STREAMS["straggler"], idx))
            for t in self._arrivals(rng, self.straggler_rate_per_min,
                                    horizon_ms):
                out.append(FaultEvent(
                    t, "straggler", name,
                    duration_ms=self.straggler_duration_ms,
                    factor=self.straggler_factor))
        out.sort(key=lambda e: (e.t, e.shard, e.kind))
        return out

    def events_json(self, shard_names: Sequence[str],
                    horizon_ms: float) -> str:
        """Canonical JSON of the event stream (the determinism pin)."""
        return json.dumps(
            [e.to_dict() for e in self.events(shard_names, horizon_ms)],
            sort_keys=True, separators=(",", ":"))

    # ------------------------------------------------- drop decisions

    def should_drop(self, rid: int, attempt: int) -> bool:
        """Lose this request's response at completion time?

        Hash-derived from ``(seed, rid, attempt)`` — deterministic and
        independent of event interleaving, and a retry (attempt + 1)
        re-rolls rather than being doomed forever.
        """
        if self.drop_prob <= 0.0:
            return False
        h = hashlib.sha256(
            f"drop:{self.seed}:{rid}:{attempt}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)
        return u < self.drop_prob


# ----------------------------------------------------------- registry

FAULT_PLANS: Dict[str, FaultPlan] = {}


def register_fault_plan(plan: FaultPlan) -> FaultPlan:
    if plan.name in FAULT_PLANS:
        raise ValueError(f"duplicate fault plan: {plan.name}")
    FAULT_PLANS[plan.name] = plan
    return plan


def registered_fault_plans() -> Tuple[str, ...]:
    return tuple(sorted(FAULT_PLANS))


def resolve_fault_plan(
        plan: Union[None, str, dict, FaultPlan]) -> Optional[FaultPlan]:
    """None | registered name | plan dict | FaultPlan -> FaultPlan."""
    if plan is None:
        return None
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, str):
        if plan not in FAULT_PLANS:
            raise KeyError(
                f"unknown fault plan {plan!r}; registered: "
                f"{registered_fault_plans()}")
        return FAULT_PLANS[plan]
    if isinstance(plan, dict):
        return FaultPlan.from_dict(plan)
    raise TypeError(f"cannot resolve fault plan from {type(plan)!r}")


def _register_default_plans() -> None:
    # All-zero control plan: same recovery machinery (oracle active,
    # shedding armed) but zero injected faults.  A sweep leg must name
    # it explicitly — a bare ``fault_plan=None`` falls back to the
    # trace meta's plan, so "none" is how a faults/* scenario gets an
    # honest no-fault baseline grid point.
    register_fault_plan(FaultPlan(name="none"))
    # The failure-rate x detection-latency grid for resilience curves.
    # Plan seed 2: the rate-1 stream concretely fires inside both the
    # 20s smoke and 30s full horizons on a 4-shard cell (seed 0's
    # rate-1 stream draws nothing before 30s — a flat curve).
    for rate in (1, 3):
        for det in (250, 1000):
            register_fault_plan(FaultPlan(
                name=f"crash-r{rate}-d{det}", seed=2,
                fail_rate_per_min=float(rate),
                fail_duration_ms=4000.0, detection_latency_ms=float(det)))
    # Friendly single-mechanism plans. The crash rate is sized so a
    # 30s x 4-shard replay reliably sees failures (expected ~6, and
    # the seed-0 stream concretely lands >= 2) — a chaos scenario that
    # draws zero faults gates nothing.
    register_fault_plan(FaultPlan(
        name="crash", fail_rate_per_min=3.0, fail_duration_ms=4000.0,
        detection_latency_ms=250.0))
    register_fault_plan(FaultPlan(
        name="brownout", brownout_rate_per_min=2.0,
        brownout_duration_ms=2500.0, brownout_level=2))
    register_fault_plan(FaultPlan(
        name="straggler", straggler_rate_per_min=2.0,
        straggler_duration_ms=2500.0, straggler_factor=3.0))
    register_fault_plan(FaultPlan(name="flaky", drop_prob=0.03))
    # Everything at once.
    register_fault_plan(FaultPlan(
        name="storm", fail_rate_per_min=2.0, fail_duration_ms=3000.0,
        detection_latency_ms=250.0, brownout_rate_per_min=1.0,
        brownout_duration_ms=2000.0, brownout_level=2,
        straggler_rate_per_min=1.0, straggler_duration_ms=2000.0,
        straggler_factor=2.5, drop_prob=0.02))


_register_default_plans()


# ------------------------------------------------------ resilience CLI


def resilience_rows(rows: Iterable[Dict[str, object]]
                    ) -> List[Dict[str, object]]:
    """Pick the resilience columns out of tidy cluster sweep rows."""
    keep = ("scenario", "policy", "fault_plan", "injected", "completed",
            "shed_total", "expired_total", "faults_injected", "drained",
            "retries", "dropped", "shard_recoveries", "itl_p99_ms",
            "n_violations")
    out = []
    for r in rows:
        out.append({k: r.get(k) for k in keep if k in r})
    return out


def check_resilience(result: Dict[str, object]) -> List[str]:
    """Assert the chaos-smoke contract on a faults sweep result.

    Returns a list of human-readable failures (empty == pass): zero
    oracle violations, nonzero injected fault + recovery counts, and
    exact conservation (injected = completed + shed + expired) on every
    fault leg.
    """
    failures: List[str] = []
    rows = [r for r in result.get("rows", []) if r is not None]
    if not rows:
        failures.append("no sweep rows produced")
    timed_out = [str(r.get("key")) for r in rows if r.get("failed")]
    if timed_out:
        failures.append(f"legs failed their wall-clock budget: "
                        f"{', '.join(timed_out)}")
    rows = [r for r in rows if not r.get("failed")]
    total_viol = sum(int(r.get("n_violations", 0) or 0) for r in rows)
    if total_viol:
        failures.append(f"{total_viol} oracle violations")
    fault_rows = [r for r in rows if r.get("fault_plan")]
    if not fault_rows:
        failures.append("no fault legs in sweep")
    if sum(int(r.get("faults_injected", 0) or 0)
           for r in fault_rows) == 0:
        failures.append("zero faults injected across fault legs")
    crash_rows = [r for r in fault_rows
                  if str(r.get("fault_plan", "")).startswith(
                      ("crash", "storm"))]
    if crash_rows and sum(int(r.get("shard_recoveries", 0) or 0)
                          for r in crash_rows) == 0:
        failures.append("zero shard recoveries across crash legs")
    for r in rows:
        inj = int(r.get("injected", 0) or 0)
        acct = (int(r.get("completed", 0) or 0)
                + int(r.get("shed_total", 0) or 0)
                + int(r.get("expired_total", 0) or 0))
        if inj != acct:
            failures.append(
                f"conservation broken on {r.get('key')}: "
                f"injected={inj} != completed+shed+expired={acct} "
                f"({r.get('scenario')}/{r.get('policy')}/"
                f"{r.get('fault_plan')})")
    return failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    from repro_torch.sched.replay import default_workers
    from repro_torch.sched.sweep import preset_spec, run_sweep, sweep_json

    ap = argparse.ArgumentParser(
        description="Run a fault sweep preset and check the resilience "
                    "contract (zero oracle violations, exact "
                    "conservation, nonzero injected/recovered counts).")
    ap.add_argument("--preset", default="faults-smoke")
    ap.add_argument("--parallel", type=int, nargs="?", const=-1,
                    default=0, metavar="N",
                    help="worker processes (bare --parallel = CPU-aware "
                         "default; 0/1 = serial)")
    ap.add_argument("--leg-timeout", type=float, default=None,
                    metavar="SEC",
                    help="per-leg wall-clock timeout (parallel only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--list-plans", action="store_true")
    args = ap.parse_args(argv)

    if args.list_plans:
        for name in registered_fault_plans():
            p = FAULT_PLANS[name]
            print(f"{name:18s} hash={p.plan_hash} {p.to_json()}")
        return 0

    workers = default_workers() if args.parallel < 0 \
        else max(1, args.parallel)
    spec = preset_spec(args.preset, seed=args.seed)
    result = run_sweep(spec, workers=workers,
                       leg_timeout_s=args.leg_timeout)
    rows = resilience_rows(r for r in result["rows"] if r is not None)
    if args.table:
        cols = ("scenario", "policy", "fault_plan", "injected",
                "completed", "shed_total", "expired_total",
                "faults_injected", "shard_recoveries", "itl_p99_ms",
                "n_violations")
        print(" | ".join(f"{c:>16s}" for c in cols))
        for r in rows:
            print(" | ".join(f"{str(r.get(c, '')):>16s}" for c in cols))
    if args.out:
        import pathlib
        payload = json.loads(sweep_json(result, meta=True))
        payload["resilience"] = rows
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        print(f"wrote {args.out}")

    failures = check_resilience(result)
    for f in failures:
        print(f"FAIL: {f}")
    if not failures:
        n = len(rows)
        print(f"resilience check OK: {n} legs, zero violations, "
              f"conservation exact")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
