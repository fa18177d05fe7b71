"""Differential trace-replay harness + engine-invariant oracle.

One trace, every policy, both mechanisms. A scenario trace from
`repro_torch.sched.workload` is replayed

  * through the event-driven serving engine (`sched/engine.py`) under
    every policy in the `repro_torch.sched.policy` registry (shared,
    specialized, cohort, adaptive), with an :class:`EngineOracle`
    observing every scheduling event and checking the engine's
    invariants; and
  * through the OS simulator (`core/simulator.py`, via
    `core.experiments.run_trace_sim`) under the shared and specialized
    policies — the same workload exercising the paper's original
    mechanism.

The result is a per-scenario metrics matrix (JSON-able) with derived
headline numbers (itl tail spread per policy, specialized-vs-shared
variability reduction) and every oracle violation. The tier-1 suite
(`tests/test_scenarios.py`) asserts the matrix is deterministic, clean
of violations, and that specialization beats the shared baseline in
every scenario; CI runs ``python -m repro_torch.sched.replay --smoke`` and
fails if any oracle fires.

Invariants checked by the oracle (the engine's contract):

  EDF order            a prefill always serves the earliest deadline
                       among waiting requests;
  eligibility          work of kind K executes only on pools the policy
                       declares eligible for K (capability respect —
                       e.g. a specialized decode pool never prefills);
  one handoff/transfer every pool change goes through exactly one
                       counted handoff (no teleports, no self- or
                       double-counted transfers);
  work conservation    a pool never goes idle while it has active work
                       or is eligible for waiting work;
  progress sanity      no decode (hence no completion) before prefill
                       finishes; token timestamps are monotone, so
                       inter-token latencies are non-negative;
  freq-cap             a pool's frequency domain never executes above
                       the granted license level's frequency cap;
  freq-revert          a license revert never occurs earlier than
                       ``hysteresis`` after the last dense heavy
                       section that scheduled it;
  freq-residency       per-pool frequency residency integrals sum to
                       the pool's charged busy time (no unaccounted
                       wall time at any level).

Cluster replays (``--cluster N`` / :func:`replay_cluster`) run the same
audit per shard via a :class:`ClusterOracle` (one ``EngineOracle`` per
shard engine) and add the front-end router's contract
(:class:`RouterOracle`): strict-EDF dispatch order, admission
monotonicity (the router holds the head only when every shard is
saturated), no duplicate dispatch, no lost requests.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.cluster import (ClusterConfig, ClusterEngine,
                                 ClusterTopology)
from repro_torch.sched.engine import Engine, PoolModel, Request, ServeConfig
from repro_torch.sched.policy import (make_cluster_policy, make_policy,
                                registered_policies)
from repro_torch.sched.topology import Topology, WorkKind
from repro_torch.sched.workload import SCENARIOS, Trace, scenario_trace

# The reference replay cell (same service-time model the conformance
# suites pin): per-chip roofline terms of a mid-size dry-run cell.
REPLAY_MODEL = PoolModel(prefill_ms_per_ktok=320.0, decode_fixed_ms=760.0,
                         decode_ms_per_seq=24.0, handoff_ms=2.0)

MAX_RECORDED_VIOLATIONS = 100


class EngineOracle:
    """Checks engine invariants during a run via the hook points
    threaded through ``Engine.run``. Violations are collected, not
    raised — a replay reports every broken invariant, not just the
    first."""

    def __init__(self):
        self.violations: List[Dict] = []
        self.n_violations = 0
        self._engine: Optional[Engine] = None
        self._arrived: List[Request] = []
        self._pool_of: Dict[int, str] = {}     # rid -> current pool
        self._transfers = 0

    # ------------------------------------------------------- recording

    def _flag(self, check: str, t: float, detail: str):
        self.n_violations += 1
        if len(self.violations) < MAX_RECORDED_VIOLATIONS:
            self.violations.append(
                {"check": check, "t_ms": round(t, 3), "detail": detail})

    def _eligible(self, pool_name: str, kind: WorkKind) -> bool:
        eng = self._engine
        return eng.policy.eligible(eng.topo, eng.topo.pool(pool_name), kind)

    # ----------------------------------------------------------- hooks

    def bind(self, engine: Engine):
        self._engine = engine

    def on_arrive(self, t: float, r: Request):
        self._arrived.append(r)
        window = self._engine.cfg.deadline_window_ms \
            if r.deadline_window_ms is None else r.deadline_window_ms
        if r.deadline != r.arrive_ms + window:
            self._flag("deadline", t,
                       f"rid={r.rid} deadline {r.deadline} != "
                       f"arrive+window {r.arrive_ms + window}")

    def on_prefill(self, t: float, pool: str, r: Request, waiting):
        if waiting and r.deadline > min(w[0] for w in waiting):
            self._flag("edf", t,
                       f"rid={r.rid} deadline {r.deadline} prefilled "
                       f"before earlier-deadline waiting work")
        if not self._eligible(pool, WorkKind.HEAVY):
            self._flag("eligibility", t,
                       f"heavy work (rid={r.rid}) on ineligible "
                       f"pool {pool!r}")
        self._pool_of[r.rid] = pool

    def on_transfer(self, t: float, reqs: Sequence[Request], src: str,
                    dst: str):
        if src == dst:
            self._flag("handoff", t, f"self-transfer on {src!r}")
        for r in reqs:
            known = self._pool_of.get(r.rid)
            if known is not None and known != src:
                self._flag("handoff", t,
                           f"rid={r.rid} transferred from {src!r} but "
                           f"was resident on {known!r}")
            self._pool_of[r.rid] = dst
        self._transfers += len(reqs)

    def on_decode(self, t0: float, t1: float, pool: str,
                  batch: Sequence[Request]):
        if t1 < t0:
            self._flag("progress", t0, f"decode ends at {t1} < {t0}")
        if not self._eligible(pool, WorkKind.LIGHT):
            self._flag("eligibility", t0,
                       f"light work on ineligible pool {pool!r}")
        for r in batch:
            if r.prefilled < r.prompt_len:
                self._flag("progress", t0,
                           f"rid={r.rid} decoding with prefill "
                           f"{r.prefilled}/{r.prompt_len} incomplete")
            if r.last_token_ms is None or r.last_token_ms > t1:
                self._flag("progress", t0,
                           f"rid={r.rid} non-monotone token time "
                           f"{r.last_token_ms} > {t1}")
            resident = self._pool_of.get(r.rid)
            if resident is not None and resident != pool:
                self._flag("handoff", t0,
                           f"rid={r.rid} decoding on {pool!r} but "
                           f"resident on {resident!r} (transfer "
                           f"without handoff)")

    def on_freq(self, t: float, pool: str, domain):
        """Explicit license-transition event: the instantaneous speed
        must never exceed the granted level's frequency cap."""
        cap = domain.cfg.freqs_ghz[domain.level]
        v = domain.speed_ghz(t)
        if v > cap + 1e-9:
            self._flag("freq-cap", t,
                       f"pool {pool!r} at {v} GHz above level-"
                       f"{domain.level} cap {cap} GHz")

    def _check_domains(self, m):
        """The three frequency invariants, audited from each pool
        domain's recorded trace at end of run."""
        for pool, d in getattr(self._engine, "domains", {}).items():
            cfg = d.cfg
            for t0, t1, level, pending, v_ghz in d.sections:
                # cap of the GRANTED level; a pending (deeper) license
                # throttles below it, so any excursion above is a bug
                if v_ghz > cfg.freqs_ghz[level] + 1e-9:
                    self._flag("freq-cap", t0,
                               f"pool {pool!r} ran at {v_ghz} GHz with "
                               f"level {level} granted "
                               f"(cap {cfg.freqs_ghz[level]})")
            for ev in d.events:
                if ev[0] != "revert":
                    continue
                _, t_rev, _frm, heavy_end = ev
                if t_rev < heavy_end + cfg.hysteresis - 1e-9:
                    self._flag("freq-revert", t_rev,
                               f"pool {pool!r} reverted {t_rev - heavy_end}"
                               f" after last heavy section "
                               f"(< hysteresis {cfg.hysteresis})")
            res = sum(d.time_at_level)
            pb = m.pool_busy.get(pool, {})
            busy = sum(pb.values())
            tol = max(1e-3, 1e-6 * busy)
            if abs(res - d.busy_time) > tol:
                self._flag("freq-residency", m.total_ms,
                           f"pool {pool!r} residency sum {res} != domain "
                           f"busy time {d.busy_time}")
            if pb and abs(res - busy) > tol:
                self._flag("freq-residency", m.total_ms,
                           f"pool {pool!r} residency sum {res} != charged "
                           f"busy {busy}")

    def on_idle(self, t: float, pool: str, n_waiting: int, n_active: int):
        if n_active > 0:
            self._flag("work-conservation", t,
                       f"pool {pool!r} idles with {n_active} active "
                       f"requests")
        if n_waiting > 0 and self._eligible(pool, WorkKind.HEAVY):
            self._flag("work-conservation", t,
                       f"pool {pool!r} idles with {n_waiting} waiting "
                       f"heavy-eligible requests")

    def on_end(self, m):
        self._check_domains(m)
        if m.handoffs != self._transfers:
            self._flag("handoff", m.total_ms,
                       f"handoffs counted {m.handoffs} != transfers "
                       f"observed {self._transfers}")
        for r in self._arrived:
            if r.done_ms is None:
                continue
            if r.prefilled < r.prompt_len:
                self._flag("progress", r.done_ms,
                           f"rid={r.rid} finished with incomplete "
                           f"prefill {r.prefilled}/{r.prompt_len}")
            if r.ttft_ms is None or r.done_ms < r.arrive_ms + r.ttft_ms:
                self._flag("progress", r.done_ms,
                           f"rid={r.rid} finished before its first "
                           f"token")


# -------------------------------------------------------- cluster oracle


class RouterOracle:
    """Checks the front-end router's contract during a cluster replay.
    Violations collect like the engine oracle's — report everything.

      router-edf     only the earliest-deadline queued request may
                     dispatch (strict head-of-line);
      router-admit   a dispatch lands only on a LIVE shard whose backlog
                     is below its admission limit, and the router never
                     holds while some live shard still admits —
                     admission is monotone: a hold happens iff every
                     live shard is saturated (detected-failed shards
                     are out of the fleet for both sides of the check);
      router-dup     no request is dispatched twice without an
                     intervening requeue (drain / retry);
      router-requeue only an in-flight (dispatched) request may
                     requeue; only a queued request may expire or shed;
      router-loss    at end of run the requests the oracle believes
                     queued are exactly the router's queue (nothing
                     dropped, nothing invented);
      deadline       the router's EDF key is the trace arrival plus the
                     request's SLO window (router queueing, drains and
                     retries spend SLO budget; they never reset it).
    """

    def __init__(self, default_window_ms: float = 50.0):
        self.default_window_ms = default_window_ms
        self.violations: List[Dict] = []
        self.n_violations = 0
        # rid -> lifecycle state: queued / dispatched / expired / shed.
        # Dispatch->requeue->dispatch cycles are legal (fault retries);
        # everything else transitions exactly once.
        self._state: Dict[int, str] = {}
        self._arrived = 0

    def _flag(self, check: str, t: float, detail: str):
        self.n_violations += 1
        if len(self.violations) < MAX_RECORDED_VIOLATIONS:
            self.violations.append(
                {"check": check, "t_ms": round(t, 3), "detail": detail})

    # ----------------------------------------------------------- hooks

    def on_router_arrive(self, t: float, r: Request, deadline: float):
        self._arrived += 1
        if r.rid in self._state:
            self._flag("router-dup", t,
                       f"rid={r.rid} arrived twice at the router")
        self._state[r.rid] = "queued"
        window = self.default_window_ms if r.deadline_window_ms is None \
            else r.deadline_window_ms
        if abs(deadline - (r.arrive_ms + window)) > 1e-9:
            self._flag("deadline", t,
                       f"rid={r.rid} router deadline {deadline} != "
                       f"arrive+window {r.arrive_ms + window}")

    def on_requeue(self, t: float, r: Request):
        prev = self._state.get(r.rid, "dispatched")
        if prev != "dispatched":
            self._flag("router-requeue", t,
                       f"rid={r.rid} requeued from state {prev!r}")
        self._state[r.rid] = "queued"

    def on_expire(self, t: float, r: Request):
        prev = self._state.get(r.rid, "queued")
        if prev != "queued":
            self._flag("router-requeue", t,
                       f"rid={r.rid} expired from state {prev!r}")
        self._state[r.rid] = "expired"

    def on_shed(self, t: float, r: Request):
        prev = self._state.get(r.rid, "queued")
        if prev != "queued":
            self._flag("router-requeue", t,
                       f"rid={r.rid} shed from state {prev!r}")
        self._state[r.rid] = "shed"

    def on_dispatch(self, t: float, head: Request, views, target,
                    queue) -> None:
        """``queue`` is the router's EDF heap [(deadline, rid, req)];
        ``target`` is the chosen shard name or None (hold)."""
        if queue:
            dmin = min(e[0] for e in queue)
            if queue[0][0] > dmin + 1e-9 or head is not queue[0][2]:
                self._flag("router-edf", t,
                           f"rid={head.rid} dispatched ahead of an "
                           f"earlier-deadline queued request")
        vmap = {v.name: v for v in views}
        if target is None:
            admitting = [v.name for v in views if not v.failed
                         and v.queue_depth < v.admit_limit]
            if admitting:
                self._flag("router-admit", t,
                           f"router holds rid={head.rid} while shards "
                           f"{admitting} still admit")
            return
        v = vmap.get(target)
        if v is None:
            self._flag("router-admit", t,
                       f"rid={head.rid} dispatched to unknown shard "
                       f"{target!r}")
        elif v.failed:
            self._flag("router-admit", t,
                       f"rid={head.rid} dispatched to failed shard "
                       f"{target!r}")
        elif v.queue_depth >= v.admit_limit:
            self._flag("router-admit", t,
                       f"rid={head.rid} dispatched to saturated shard "
                       f"{target!r} ({v.queue_depth} >= {v.admit_limit})")
        if self._state.get(head.rid) == "dispatched":
            self._flag("router-dup", t,
                       f"rid={head.rid} dispatched twice without an "
                       f"intervening requeue (to {target!r})")
        self._state[head.rid] = "dispatched"

    def on_end(self, m, router) -> None:
        queued = len(router)
        believed = sum(1 for s in self._state.values() if s == "queued")
        if believed != queued:
            self._flag("router-loss", m.total_ms,
                       f"{believed} requests in queued state != "
                       f"{queued} actually queued at end of run")


class FaultOracle:
    """Fault-model contract for cluster replays under injection
    (``repro_torch.sched.faults``). Hooks fire from the cluster engine's
    fault machinery; violations collect like the other oracles'.

      fault-conservation  every injected request reaches EXACTLY ONE
                          terminal state (completed / shed / expired),
                          and the non-terminal residue matches the
                          engine's ``leftover`` count — nothing lost in
                          a drain, nothing completed twice, nothing
                          double-shed;
      fault-dup-complete  no request completes more than once
                          (exactly-once across retries and drops);
      fault-dead-dispatch no dispatch lands on a shard between failure
                          detection and recovery;
      fault-retry-cap     a request never retries at or beyond the
                          policy's ``max_attempts``;
      fault-drain-order   a failure drain requeues the dead shard's
                          residents in EDF order (deadline, rid).
    """

    def __init__(self, max_attempts: int = 3):
        self.max_attempts = max_attempts
        self.violations: List[Dict] = []
        self.n_violations = 0
        self.active = False
        self._terminal: Dict[int, str] = {}   # rid -> terminal state
        self._down: set = set()               # detected-failed shards
        self.counts: Dict[str, int] = {
            "faults": 0, "detects": 0, "recoveries": 0, "drained": 0,
            "retries": 0, "drops": 0, "completed": 0, "shed": 0,
            "expired": 0}

    def _flag(self, check: str, t: float, detail: str):
        self.n_violations += 1
        if len(self.violations) < MAX_RECORDED_VIOLATIONS:
            self.violations.append(
                {"check": check, "t_ms": round(t, 3), "detail": detail})

    # ----------------------------------------------------------- hooks

    def on_run_start(self, plan, max_attempts: int):
        self.active = True
        self.max_attempts = max_attempts

    def _terminate(self, t: float, r, state: str):
        prev = self._terminal.get(r.rid)
        if prev is not None:
            self._flag("fault-conservation", t,
                       f"rid={r.rid} reached terminal state {state!r} "
                       f"after already being {prev!r}")
            return
        self._terminal[r.rid] = state
        self.counts[state] += 1

    def on_fault(self, t: float, ev):
        self.active = True
        self.counts["faults"] += 1

    def on_detect(self, t: float, shard: str):
        self._down.add(shard)
        self.counts["detects"] += 1

    def on_recover(self, t: float, shard: str):
        self._down.discard(shard)
        self.counts["recoveries"] += 1

    def on_drain(self, t: float, shard: str, reqs) -> None:
        self.counts["drained"] += len(reqs)
        keys = [(r.deadline, r.rid) for r in reqs]
        if keys != sorted(keys):
            self._flag("fault-drain-order", t,
                       f"shard {shard!r} drain requeued out of EDF "
                       f"order: {keys[:6]}...")

    def on_dispatch(self, t: float, r, shard: str):
        if shard in self._down:
            self._flag("fault-dead-dispatch", t,
                       f"rid={r.rid} dispatched to shard {shard!r} "
                       f"between detection and recovery")

    def on_retry(self, t: float, r):
        self.counts["retries"] += 1
        if r.attempts >= self.max_attempts:
            self._flag("fault-retry-cap", t,
                       f"rid={r.rid} retrying with attempts="
                       f"{r.attempts} >= cap {self.max_attempts}")
        if r.rid in self._terminal:
            self._flag("fault-conservation", t,
                       f"rid={r.rid} retried after terminal state "
                       f"{self._terminal[r.rid]!r}")

    def on_drop(self, t: float, r):
        self.counts["drops"] += 1

    def on_complete(self, t: float, r):
        if self._terminal.get(r.rid) == "completed":
            self._flag("fault-dup-complete", t,
                       f"rid={r.rid} completed twice")
            return
        self._terminate(t, r, "completed")

    def on_shed(self, t: float, r, reason: str):
        self._terminate(t, r, "shed")

    def on_expire(self, t: float, r):
        self._terminate(t, r, "expired")

    def on_end(self, m) -> None:
        if not self.active:
            return
        residue = m.injected - len(self._terminal)
        if residue != m.leftover:
            self._flag("fault-conservation", m.total_ms,
                       f"{m.injected} injected - {len(self._terminal)} "
                       f"terminal = {residue} != engine leftover "
                       f"{m.leftover}")


class ClusterOracle:
    """One :class:`EngineOracle` per shard plus a :class:`RouterOracle`
    and a :class:`FaultOracle`, aggregated: the full multi-node audit —
    per-shard EDF order, work conservation, the three frequency
    invariants, the router's admission contract, and (under injection)
    the fault model's exactly-once / drain / retry contract."""

    def __init__(self, default_window_ms: float = 50.0):
        self.router = RouterOracle(default_window_ms)
        self.faults = FaultOracle()
        self.shards: Dict[str, EngineOracle] = {}
        # closed per-incarnation oracles of crashed shards, "name#k"
        self._archived: Dict[str, EngineOracle] = {}

    def shard(self, name: str) -> EngineOracle:
        orc = self.shards.get(name)
        if orc is None:
            orc = self.shards[name] = EngineOracle()
        return orc

    def restart_shard(self, name: str) -> EngineOracle:
        """A shard recovered from a crash: archive the dead
        incarnation's oracle (its invariants were closed by the
        crash-time ``finish()``) and bind a fresh one."""
        old = self.shards.pop(name, None)
        if old is not None:
            k = sum(1 for key in self._archived
                    if key.split("#")[0] == name)
            self._archived[f"{name}#{k}"] = old
        return self.shard(name)

    def on_end(self, m, router) -> None:
        # shard oracles close in Engine.finish(); the router's and
        # fault model's end-of-run conservation checks run here
        self.router.on_end(m, router)
        self.faults.on_end(m)

    @property
    def n_violations(self) -> int:
        return self.router.n_violations + self.faults.n_violations \
            + sum(o.n_violations for o in self.shards.values()) \
            + sum(o.n_violations for o in self._archived.values())

    @property
    def violations(self) -> List[Dict]:
        out = [{**v, "shard": "router"} for v in self.router.violations]
        out.extend({**v, "shard": "faults"}
                   for v in self.faults.violations)
        for name in sorted(self.shards):
            out.extend({**v, "shard": name}
                       for v in self.shards[name].violations)
        for name in sorted(self._archived):
            out.extend({**v, "shard": name}
                       for v in self._archived[name].violations)
        return out[:MAX_RECORDED_VIOLATIONS]


# ------------------------------------------------------ headline metrics


def headline_metrics(shared_summary: Dict, specialized_summary: Dict
                     ) -> Dict[str, float]:
    """The paper-analogue headline: ITL tail spread (p99 - p50, the
    variability measure) per setup and the specialized-vs-shared
    reductions. Single definition — the scenario matrix, the
    serving benchmark, and the regression pin all derive from here."""
    spread_ns = shared_summary["itl_p99_ms"] - shared_summary["itl_p50_ms"]
    spread_sp = specialized_summary["itl_p99_ms"] \
        - specialized_summary["itl_p50_ms"]
    return {
        "itl_spread_shared_ms": spread_ns,
        "itl_spread_specialized_ms": spread_sp,
        "itl_variability_reduction": 1.0 - spread_sp / max(spread_ns, 1e-9),
        "itl_p99_reduction": 1.0 - specialized_summary["itl_p99_ms"]
        / max(shared_summary["itl_p99_ms"], 1e-9),
    }


# --------------------------------------------------------- single replay


def default_topology(policy_name: str, n_devices: int,
                     prefill_devices: int) -> Topology:
    """Canonical layout per policy: splitting policies get the serving
    prefill/decode split, non-splitting ones the shared pool."""
    if policy_name in ("specialized", "adaptive"):
        return Topology.serving(n_devices, prefill_devices)
    return Topology.shared(n_devices)


def replay_engine(trace: Trace, policy_name: str, *, n_devices: int = 16,
                  prefill_devices: int = 4,
                  model: Optional[PoolModel] = None,
                  cfg: Optional[ServeConfig] = None,
                  horizon_ms: Optional[float] = None,
                  drain_ms: float = 20_000.0) -> Dict:
    """Replay one trace through the serving engine under one registered
    policy, with the oracle attached. Fresh policy + requests per call:
    replays never contaminate each other.

    The default horizon is the trace duration plus ``drain_ms`` so
    late-arriving requests finish decoding — engine completion counts
    stay comparable with the simulator leg, which drains too. An
    explicit ``horizon_ms`` is used as-is."""
    topo = default_topology(policy_name, n_devices, prefill_devices)
    policy = make_policy(policy_name)
    oracle = EngineOracle()
    eng = Engine(topo, policy, model or REPLAY_MODEL, cfg)
    m = eng.run(trace.to_engine_requests(),
                trace.duration_ms + drain_ms if horizon_ms is None
                else horizon_ms,
                oracle=oracle)
    s = m.summary()
    s["itl_spread_ms"] = s["itl_p99_ms"] - s["itl_p50_ms"]
    return {
        "mechanism": "engine",
        "policy": policy_name,
        "topology": topo.to_dict(),
        "metrics": s,
        "freq": dict(m.pool_freq),     # per-pool frequency-domain trace
        "n_violations": oracle.n_violations,
        "violations": oracle.violations,
    }


def replay_cluster(trace: Trace, cluster_policy: str = "cluster-adaptive",
                   *, n_shards: int = 4, devices_per_shard: int = 16,
                   prefill_devices: int = 4,
                   model: Optional[PoolModel] = None,
                   cfg: Optional[ClusterConfig] = None,
                   cluster: Optional[ClusterTopology] = None,
                   horizon_ms: Optional[float] = None,
                   drain_ms: float = 20_000.0,
                   fault_plan=None) -> Dict:
    """Replay one trace through an N-shard cluster under one registered
    cluster policy, with the full multi-node oracle attached (per-shard
    engine invariants + router contract + fault model). The default
    layout is ``ClusterTopology.homogeneous`` with each shard's engine
    policy taken from the cluster policy's ``shard_policy`` attribute;
    pass an explicit ``cluster`` to override.

    ``fault_plan`` (a name, dict or ``FaultPlan``) runs the replay
    under deterministic fault injection; ``None`` falls back to the
    trace's own ``meta["fault_plan"]`` (the ``faults/*`` scenarios
    carry one), and plans expand over the trace duration only, so the
    drain window lets every recovery and retry settle."""
    if cluster is None:
        shard_policy = make_cluster_policy(cluster_policy).shard_policy
        cluster = ClusterTopology.homogeneous(
            n_shards, devices_per_shard, prefill_devices,
            policy=shard_policy)
    from repro_torch.sched.faults import resolve_fault_plan
    plan = resolve_fault_plan(
        fault_plan if fault_plan is not None
        else trace.meta.get("fault_plan"))
    cfg = cfg or ClusterConfig()
    oracle = ClusterOracle(cfg.serve.deadline_window_ms)
    eng = ClusterEngine(cluster, cluster_policy, model or REPLAY_MODEL,
                        cfg)
    m = eng.run(trace.to_engine_requests(),
                trace.duration_ms + drain_ms if horizon_ms is None
                else horizon_ms,
                oracle=oracle, fault_plan=plan,
                fault_horizon_ms=trace.duration_ms)
    s = m.summary()
    s["itl_spread_ms"] = s["itl_p99_ms"] - s["itl_p50_ms"]
    out = {
        "mechanism": "cluster",
        "policy": cluster_policy,
        "cluster": cluster.to_dict(),
        "metrics": s,
        "shards": m.shard_summaries(),
        "n_violations": oracle.n_violations,
        "violations": oracle.violations,
    }
    if plan is not None:
        out["fault_plan"] = plan.name
        out["fault_plan_hash"] = plan.plan_hash
        out["fault_counts"] = dict(oracle.faults.counts)
    return out


# --------------------------------------------------------------- matrix

# Module-level trace cache: a process pool can only dispatch
# importable callables, so legs reference their trace by (scenario,
# duration, seed) coordinates against this cache. The parent populates
# it BEFORE the worker pool exists, so fork-started workers inherit
# every frozen trace with zero pickling per leg, and a worker that does
# not inherit (spawn start, or a pool outliving a cache update)
# regenerates the identical bytes from the deterministic generator.
# Leg execution itself lives in repro_torch.sched.sweep.run_leg — the matrix
# is a thin sweep over its default grid (sweep.matrix_spec).

_TRACE_CACHE: Dict[Tuple[str, float, int], Trace] = {}


def _leg_trace(name: str, duration_ms: float, seed: int) -> Trace:
    key = (name, float(duration_ms), int(seed))
    tr = _TRACE_CACHE.get(key)
    if tr is None:
        tr = _TRACE_CACHE[key] = scenario_trace(
            name, duration_ms=duration_ms, seed=seed)
    return tr


# Persistent worker pool: process startup (fork + interpreter state) is
# the dominant cost of a parallel sweep, so the pool survives across
# scenario_matrix calls and is only rebuilt when the worker count
# changes. Shut down at interpreter exit.
_POOL = None
_POOL_SIZE = 0


def _shutdown_pool():
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        _POOL.shutdown()
        _POOL, _POOL_SIZE = None, 0


def _kill_pool():
    """Forcibly tear the pool down — the leg-timeout path. A clean
    ``shutdown()`` would join a hung worker forever, so terminate the
    worker processes first, then reap the executor without waiting."""
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        for p in list(getattr(_POOL, "_processes", {}).values()):
            p.terminate()
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL, _POOL_SIZE = None, 0


atexit.register(_shutdown_pool)


@contextmanager
def pool_failsafe():
    """Exception-path teardown for ``--parallel`` entry points. The
    persistent pool deliberately survives clean sweeps (fork +
    interpreter startup dominate a parallel run), but an exception
    escaping a fan-out — a failing leg, a KeyboardInterrupt — must not
    leave workers behind for ``atexit`` to reap long after a CI step
    already failed: shut the pool down before propagating."""
    try:
        yield
    except BaseException:
        _shutdown_pool()
        raise


def _worker_pool(workers: int):
    global _POOL, _POOL_SIZE
    if _POOL is not None and _POOL_SIZE != workers:
        _shutdown_pool()
    if _POOL is None:
        from concurrent.futures import ProcessPoolExecutor
        _POOL = ProcessPoolExecutor(max_workers=workers)
        _POOL_SIZE = workers
    return _POOL


def default_workers() -> int:
    """CPU-aware worker count for ``--parallel`` without an argument.
    A ``REPRO_SWEEP_WORKERS`` env var overrides the CPU count — CI and
    local runs pin it so recorded throughput numbers are honestly
    comparable; the resolved value (and whether the override was set)
    lands in sweep/matrix result metadata."""
    env = os.environ.get("REPRO_SWEEP_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            raise ValueError(
                f"REPRO_SWEEP_WORKERS must be an integer, got {env!r}"
            ) from None
    n = os.cpu_count() or 1
    try:                               # respect container CPU limits
        n = min(n, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        pass
    return max(1, n)


def scenario_matrix(scenarios: Optional[Sequence[str]] = None, *,
                    duration_ms: float = 30_000.0, seed: int = 0,
                    n_devices: int = 16, prefill_devices: int = 4,
                    policies: Optional[Sequence[str]] = None,
                    simulator: bool = True, parallel: int = 0,
                    cluster: int = 0,
                    cluster_policies: Optional[Sequence[str]] = None,
                    timing: bool = False) -> Dict:
    """The differential matrix: every scenario x every registered
    policy through the engine (+ shared/specialized through the OS
    simulator, + N-shard cluster legs when ``cluster > 0``), one
    identical trace per scenario.

    The matrix is a thin sweep over its default grid: the legs compile
    through ``repro_torch.sched.sweep.matrix_spec`` and execute through the
    sweep runtime. ``parallel=N`` fans the independent scenario x
    policy x mechanism legs across a persistent process pool of N
    workers (``-1`` = CPU-aware default, honoring the
    ``REPRO_SWEEP_WORKERS`` override) over the shared frozen traces —
    generated once in the parent before any worker exists, inherited
    at fork, and regenerated bit-identically by any worker that missed
    the fork. Legs are pure functions of their inputs, submitted
    individually in descending cost-estimate order (longest first, so
    unequal-cost legs no longer strand a straggler chunk at the end of
    the sweep) and reassembled in compilation order: the matrix is
    identical to the serial one. ``parallel<=1`` keeps the serial
    path.

    ``cluster=N`` adds an N-shard cluster leg per scenario and cluster
    policy (default cluster-rr + cluster-adaptive), each shard sized
    like the single-node reference cell (``n_devices`` devices) — the
    scale-out comparison: N nodes behind the frequency-aware router vs
    one node, same trace — with per-scenario ``cluster_derived``
    headline reductions vs the shared engine baseline.

    ``timing=True`` records per-leg wall seconds under ``_timing``
    (kept out of the default matrix so determinism comparisons stay
    exact)."""
    names = list(scenarios) if scenarios is not None else sorted(SCENARIOS)
    pols = list(policies) if policies is not None \
        else list(registered_policies())
    cpols = list(cluster_policies) if cluster_policies is not None \
        else ["cluster-rr", "cluster-adaptive"]
    if parallel and parallel < 0:
        parallel = default_workers()
    out: Dict[str, Dict] = {
        "_config": {"duration_ms": duration_ms, "seed": seed,
                    "n_devices": n_devices,
                    "prefill_devices": prefill_devices,
                    "policies": pols, "scenarios": names},
    }
    dps, pfd = n_devices, prefill_devices
    if cluster:
        out["_config"]["cluster"] = {
            "n_shards": cluster, "devices_per_shard": dps,
            "prefill_devices": pfd, "policies": cpols}
    traces = {name: _leg_trace(name, duration_ms, seed) for name in names}
    for name in names:
        out[name] = {
            "trace": {"scenario": name, "seed": seed,
                      "duration_ms": duration_ms,
                      "n_requests": len(traces[name].requests)},
            "engine": {},
        }
        if simulator:
            out[name]["simulator"] = {}
        if cluster:
            out[name]["cluster"] = {}
    from repro_torch.sched.sweep import matrix_spec, run_legs
    spec = matrix_spec(names, pols, duration_ms=duration_ms, seed=seed,
                       n_devices=n_devices,
                       prefill_devices=prefill_devices,
                       simulator=simulator, cluster=cluster,
                       cluster_policies=cpols)
    legs = spec.legs()
    t_start = time.perf_counter()
    results, stats = run_legs(
        legs, workers=parallel if parallel and parallel > 1 else 1)
    walls: Dict[str, float] = {}
    for leg, res in zip(legs, results):
        slot = leg["mechanism"]
        out[leg["scenario"]][slot][leg["policy"]] = res
        wall = stats["leg_walls"].get(leg["key"])
        if wall is not None:
            walls[f"{leg['scenario']}/{slot}/{leg['policy']}"] = wall
    if timing:
        out["_timing"] = {
            "legs": walls,
            "wall_s": round(time.perf_counter() - t_start, 4),
            "workers": stats["workers"],
            "cpu_count": stats["cpu_count"],
            "workers_env": stats["workers_env"]}
    for name in names:
        cell = out[name]
        if "shared" in cell["engine"] and "specialized" in cell["engine"]:
            cell["derived"] = headline_metrics(
                cell["engine"]["shared"]["metrics"],
                cell["engine"]["specialized"]["metrics"])
        if cluster and "shared" in cell["engine"]:
            # cluster-vs-single-node headline: the "specialized" slots
            # of headline_metrics carry the cluster run
            cell["cluster_derived"] = {
                cpol: headline_metrics(
                    cell["engine"]["shared"]["metrics"], run["metrics"])
                for cpol, run in cell["cluster"].items()}
    return out


def total_violations(matrix: Dict) -> int:
    return sum(run.get("n_violations", 0)
               for name, cell in matrix.items() if not name.startswith("_")
               for slot in ("engine", "cluster")
               for run in cell.get(slot, {}).values())


def matrix_rows(matrix: Dict) -> List[str]:
    """Human-readable summary lines, one per scenario x policy (and per
    cluster policy when cluster legs ran). When the matrix carries
    ``_timing``, each row ends with its leg's wall seconds — sweep hot
    spots readable straight off the report."""
    walls = matrix.get("_timing", {}).get("legs", {})

    def wall(name, slot, key) -> str:
        w = walls.get(f"{name}/{slot}/{key}")
        return "" if w is None else f" wall={w:6.2f}s"

    rows = []
    for name, cell in matrix.items():
        if name.startswith("_"):
            continue
        for pol, run in cell.get("engine", {}).items():
            s = run["metrics"]
            rows.append(
                f"{name:<14} {pol:<16} itl_p50={s['itl_p50_ms']:7.1f}ms "
                f"itl_p99={s['itl_p99_ms']:8.1f}ms "
                f"spread={s['itl_spread_ms']:8.1f}ms "
                f"done={s['completed']:4d} "
                f"f={s['avg_freq_ghz']:.2f}GHz "
                f"thr={s['throttled_ms']:5.1f}ms "
                f"E={s['energy_proxy']:8.0f} "
                f"violations={run['n_violations']}"
                f"{wall(name, 'engine', pol)}")
        for cpol, run in cell.get("cluster", {}).items():
            s = run["metrics"]
            rows.append(
                f"{name:<14} {cpol:<16} itl_p50={s['itl_p50_ms']:7.1f}ms "
                f"itl_p99={s['itl_p99_ms']:8.1f}ms "
                f"spread={s['itl_spread_ms']:8.1f}ms "
                f"done={s['completed']:4d} "
                f"f={s['avg_freq_ghz']:.2f}GHz "
                f"holds={s['router_holds']:4.0f} "
                f"E={s['energy_proxy']:8.0f} "
                f"violations={run['n_violations']}"
                f"{wall(name, 'cluster', cpol)}")
        d = cell.get("derived")
        if d:
            rows.append(
                f"{name:<14} {'-> spec/shared':<16} "
                f"variability_reduction="
                f"{100 * d['itl_variability_reduction']:.0f}% "
                f"p99_reduction={100 * d['itl_p99_reduction']:.0f}%")
        for cpol, d in cell.get("cluster_derived", {}).items():
            rows.append(
                f"{name:<14} {'-> ' + cpol + '/shared':<16} "
                f"variability_reduction="
                f"{100 * d['itl_variability_reduction']:.0f}% "
                f"p99_reduction={100 * d['itl_p99_reduction']:.0f}%")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="short traces on a small cell (CI gate)")
    ap.add_argument("--duration", type=float, default=None,
                    help="trace duration in ms (default 30000; "
                         "smoke 8000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenarios", nargs="*", default=None)
    ap.add_argument("--no-simulator", action="store_true",
                    help="skip the OS-simulator leg of the differential")
    ap.add_argument("--parallel", type=int, nargs="?", const=-1,
                    default=0, metavar="N",
                    help="fan scenario x policy x mechanism legs across "
                         "a persistent process pool of N workers over "
                         "the shared frozen traces (bare --parallel = "
                         "CPU-aware count; 0/1 = serial; results are "
                         "identical either way)")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="add an N-shard cluster leg per scenario "
                         "(cluster-rr + cluster-adaptive through the "
                         "router, full multi-node oracle)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full metrics matrix as JSON")
    ap.add_argument("--freq-trace", type=Path, default=None,
                    help="write just the per-pool frequency-domain "
                         "trace (scenario x policy x pool residency / "
                         "transitions / energy) as JSON — the CI "
                         "artifact")
    args = ap.parse_args(argv)
    duration = args.duration or (8_000.0 if args.smoke else 30_000.0)
    matrix = scenario_matrix(
        args.scenarios, duration_ms=duration, seed=args.seed,
        n_devices=8 if args.smoke else 16,
        prefill_devices=2 if args.smoke else 4,
        simulator=not args.no_simulator, parallel=args.parallel,
        cluster=args.cluster, timing=True)
    for row in matrix_rows(matrix):
        print(row)
    t = matrix.get("_timing", {})
    if t:
        print(f"wall: {t['wall_s']:.2f}s across {t['workers']} "
              f"worker(s)")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(matrix, indent=1, sort_keys=True))
        print(f"matrix -> {args.out}")
    if args.freq_trace:
        trace = {
            name: {pol: run["freq"]
                   for pol, run in cell["engine"].items()}
            for name, cell in matrix.items() if not name.startswith("_")}
        args.freq_trace.parent.mkdir(parents=True, exist_ok=True)
        args.freq_trace.write_text(
            json.dumps(trace, indent=1, sort_keys=True))
        print(f"freq trace -> {args.freq_trace}")
    n_bad = total_violations(matrix)
    if n_bad:
        print(f"ORACLE VIOLATIONS: {n_bad}")
        for name, cell in matrix.items():
            if name.startswith("_"):
                continue
            for slot in ("engine", "cluster"):
                for pol, run in cell.get(slot, {}).items():
                    for v in run["violations"][:5]:
                        print(f"  {name}/{pol}: [{v['check']}] "
                              f"t={v['t_ms']} {v['detail']}")
        return 1
    n_scen = sum(1 for k in matrix if not k.startswith("_"))
    print(f"replay: OK — {n_scen} scenarios x "
          f"{len(matrix['_config']['policies'])} policies"
          + (f" + {matrix['_config']['cluster']['n_shards']}-shard "
             f"cluster legs" if "cluster" in matrix["_config"] else "")
          + ", 0 oracle violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
