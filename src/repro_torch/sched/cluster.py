"""Cluster-scale serving: N engine shards behind a frequency-aware
front-end router — the paper's mechanism, one level up.

The paper confines AVX-induced frequency reduction to a core subset and
migrates threads to absorb it. At cluster scale the same signal
reappears as *per-node* frequency variation (Schuchart et al.: the
problem shifts from power consumption to performance variation at
scale), and the same mitigation applies: measure each node's license
residency, and route/resize so frequency-reduced nodes shed the heavy
work that keeps them reduced.

Three pieces:

  * :class:`ClusterTopology` — N shards, each a named
    :class:`repro_torch.sched.topology.Topology` plus the registered engine
    policy that schedules inside it. Serializable (``to_dict`` /
    ``from_dict``) like the single-node ``Topology``.
  * :class:`Router` — SLO-aware admission control and placement.
    Requests queue at the front-end in strict EDF order (earliest
    deadline dispatches first — head-of-line, so admission is
    monotone and auditable); placement asks the cluster policy to
    score each shard's :class:`repro_torch.sched.policy.ShardView` (queue
    depth, per-window license residency, energy rate) and may HOLD the
    head when every shard is saturated.
  * :class:`ClusterEngine` — N shard :class:`repro_torch.sched.engine.Engine`
    instances interleaved on ONE global event heap. Each shard runs its
    normal event loop but pushes through the cluster's injected sink,
    so shard events, router arrivals and cluster observation windows
    are globally time-ordered. Once per ``window_ms`` the cluster
    closes every shard's load window (``Engine.load_signals`` with the
    cluster override) and lets the cluster policy resize shards
    cross-shard — ``AdaptivePolicy`` promoted to cluster level.

Shard engines never self-resize in cluster mode (their
``resize_interval_ms`` is forced to +inf); the cluster window is the
only observer, so the §4.3 estimator sees clean, non-overlapping
windows per shard.

Real-model mode (`launch/serve.py --mode cluster`) maps each shard onto
its own ``repro_torch.dist.DistContext`` mesh slice so jitted prefill/decode
executors run per-shard; the simulated mode used here prices work
through the shared :class:`PoolModel` exactly like the single-node
engine, so cluster runs replay deterministically under the oracle.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.sched.engine import (Engine, PoolModel, Request, ServeConfig,
                                ServeMetrics)
from repro_torch.sched.freq import ResidencyWindow
from repro_torch.sched.policy import (ClusterPolicy, ShardView,
                                make_cluster_policy, make_policy)
from repro_torch.sched.topology import Topology

# Pseudo-shard name for cluster-level events (router arrivals and
# observation windows) on the global heap. "@" sorts before any real
# shard name and is rejected by ShardSpec validation, so it can never
# collide.
ROUTER = "@router"

# Pseudo-shard for fault-injection events (sched/faults.py): shard
# crash/recover boundaries, failure detection, brownout/straggler
# windows, and retry re-entries all ride the same global heap so fault
# timing is exact and deterministic.
FAULTS = "@faults"


# ------------------------------------------------------------- topology


@dataclass(frozen=True)
class ShardSpec:
    """One shard: a named pool topology plus the registered engine
    policy that schedules inside it."""
    name: str
    topology: Topology
    policy: str = "specialized"

    def __post_init__(self):
        if not self.name or self.name.startswith("@"):
            raise ValueError(f"invalid shard name {self.name!r}")


@dataclass(frozen=True)
class ClusterTopology:
    """Ordered, uniquely named shards. The cluster-scale analogue of
    :class:`Topology`: shards partition the fleet's devices the way
    pools partition a node's."""
    shards: Tuple[ShardSpec, ...]

    def __post_init__(self):
        names = [s.name for s in self.shards]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate shard names in {names}")
        if not self.shards:
            raise ValueError("a cluster needs at least one shard")

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_units(self) -> int:
        return sum(s.topology.n_units for s in self.shards)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.shards)

    def shard(self, name: str) -> ShardSpec:
        for s in self.shards:
            if s.name == name:
                return s
        raise KeyError(name)

    # ----------------------------------------------------- serialization

    def to_dict(self) -> Dict:
        return {"shards": [{"name": s.name, "policy": s.policy,
                            "topology": s.topology.to_dict()}
                           for s in self.shards]}

    @staticmethod
    def from_dict(d: Dict) -> "ClusterTopology":
        return ClusterTopology(tuple(
            ShardSpec(s["name"], Topology.from_dict(s["topology"]),
                      s["policy"])
            for s in d["shards"]))

    # -------------------------------------------------------- factories

    @staticmethod
    def homogeneous(n_shards: int, devices_per_shard: int,
                    prefill_devices: int, *,
                    policy: str = "specialized",
                    prefix: str = "shard") -> "ClusterTopology":
        """N identical serving shards (prefill/decode split each) —
        the canonical scale-out layout benchmarks and tests use."""
        if n_shards < 1:
            raise ValueError("need at least one shard")
        return ClusterTopology(tuple(
            ShardSpec(f"{prefix}{i}",
                      Topology.serving(devices_per_shard, prefill_devices),
                      policy)
            for i in range(n_shards)))

    @staticmethod
    def shared_pool(n_shards: int, devices_per_shard: int, *,
                    prefix: str = "shard") -> "ClusterTopology":
        """N shared-pool shards (no specialization inside a shard) —
        the frequency-blind scale-out baseline."""
        return ClusterTopology(tuple(
            ShardSpec(f"{prefix}{i}", Topology.shared(devices_per_shard),
                      "shared")
            for i in range(n_shards)))


# --------------------------------------------------------------- config


@dataclass
class ClusterConfig:
    """Cluster-level knobs; per-shard engine knobs live in ``serve``.

    ``admit_per_unit`` bounds each shard's resident backlog (waiting +
    active + in-flight + routed-not-yet-arrived) to
    ``ceil(admit_per_unit * shard.n_units)`` — the router holds the EDF
    head above that, which is what makes admission auditable."""
    admit_per_unit: float = 2.0
    window_ms: float = 1000.0          # observation / reshard cadence
    serve: ServeConfig = field(default_factory=ServeConfig)

    def shard_serve_config(self) -> ServeConfig:
        """Per-shard engine config: identical knobs, but shard engines
        never self-resize — the cluster window is the only observer of
        their load signals."""
        s = self.serve
        return ServeConfig(prefill_chunk=s.prefill_chunk,
                           decode_batch_max=s.decode_batch_max,
                           deadline_window_ms=s.deadline_window_ms,
                           resize_interval_ms=float("inf"),
                           freq=s.freq)

    def admit_limit(self, topo: Topology) -> int:
        return max(1, int(-(-self.admit_per_unit * topo.n_units // 1)))


# -------------------------------------------------------------- metrics


def _pctl(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    return sorted_xs[min(int(q * len(sorted_xs)), len(sorted_xs) - 1)]


@dataclass
class ClusterMetrics:
    """Aggregated cluster run: per-shard :class:`ServeMetrics` plus
    router accounting. ``summary()`` speaks the same keys as
    ``ServeMetrics.summary()`` so headline derivations
    (`repro_torch.sched.replay.headline_metrics`) apply unchanged.

    Failure accounting is conservation-grade: every request that enters
    the router ends up exactly once in ``completed``, per-tenant
    ``shed`` (graceful degradation / retry exhaustion — never silent),
    per-tenant ``deadline_missed_at_router`` (budget hit zero while
    queued, held, or between retries), or the end-of-run ``leftover``
    (still resident when the horizon cut). ``sched/replay.FaultOracle``
    audits exactly this identity."""
    shard_metrics: Dict[str, ServeMetrics] = field(default_factory=dict)
    total_ms: float = 0.0
    routed: Dict[str, int] = field(default_factory=dict)
    router_holds: int = 0              # dispatch attempts that held the head
    router_max_queue: int = 0
    router_wait_ms: List[float] = field(default_factory=list)
    resize_events: List[Tuple[float, str, Dict[str, int]]] = \
        field(default_factory=list)
    # fault / recovery accounting (zero everywhere without a FaultPlan)
    injected: int = 0                  # requests entering the router
    faults_injected: Dict[str, int] = field(default_factory=dict)
    shard_recoveries: int = 0
    drained: int = 0                   # requests drained off dead shards
    retries: int = 0                   # scheduled re-entries
    dropped: int = 0                   # responses lost at completion time
    brownout_hedges: int = 0           # placements steered off brownouts
    shed: Dict[str, int] = field(default_factory=dict)          # per tenant
    shed_reasons: Dict[str, int] = field(default_factory=dict)
    deadline_missed_at_router: Dict[str, int] = \
        field(default_factory=dict)                             # per tenant
    leftover: int = 0                  # still resident at horizon

    def summary(self) -> Dict[str, float]:
        ms = self.shard_metrics.values()
        itl = sorted(x for m in ms for x in m.itl_ms)
        ttft = sorted(x for m in ms for x in m.ttft_ms)
        freq = [f for m in ms for f in m.pool_freq.values()]
        busy = sum(f["busy"] for f in freq)
        rwait = sorted(self.router_wait_ms)
        return {
            "throughput_tok_s": 1000.0 * len(itl) / self.total_ms
            if self.total_ms else 0.0,
            "ttft_p50_ms": _pctl(ttft, 0.5),
            "ttft_p99_ms": _pctl(ttft, 0.99),
            "itl_p50_ms": _pctl(itl, 0.5),
            "itl_p99_ms": _pctl(itl, 0.99),
            "completed": sum(m.completed for m in ms),
            "steals": sum(m.steals for m in ms),
            "handoffs": sum(m.handoffs for m in ms),
            "resizes": len(self.resize_events),
            "avg_freq_ghz": sum(f["avg_freq_ghz"] * f["busy"]
                                for f in freq) / busy if busy else 0.0,
            "license_residency": sum(f["reduced"] for f in freq) / busy
            if busy else 0.0,
            "throttled_ms": sum(f["throttled"] for f in freq),
            "freq_transitions": sum(f["transitions"] for f in freq),
            "energy_proxy": sum(f["energy_proxy"] for f in freq),
            "router_holds": self.router_holds,
            "router_max_queue": self.router_max_queue,
            "router_wait_p99_ms": _pctl(rwait, 0.99),
            # failure / degradation accounting
            "injected": self.injected,
            "shed_total": sum(self.shed.values()),
            "expired_total": sum(self.deadline_missed_at_router.values()),
            "faults_injected": sum(self.faults_injected.values()),
            "shard_recoveries": self.shard_recoveries,
            "drained": self.drained,
            "retries": self.retries,
            "dropped": self.dropped,
            "brownout_hedges": self.brownout_hedges,
            "leftover": self.leftover,
        }

    def shard_summaries(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, m in self.shard_metrics.items():
            s = m.summary()
            s["routed"] = self.routed.get(name, 0)
            out[name] = s
        return out


# ---------------------------------------------------------------- router


class Router:
    """SLO-aware front-end: strict-EDF admission + policy placement.

    Requests wait in an EDF heap keyed by their engine deadline
    (``arrive_ms + deadline_window_ms`` — the trace arrival, so router
    queueing eats into the SLO budget rather than resetting it). Only
    the head may dispatch; when no shard admits it, the whole queue
    holds — later-deadline work never overtakes (the monotone-admission
    invariant the oracle audits)."""

    def __init__(self, policy: ClusterPolicy, default_window_ms: float,
                 oracle=None):
        self.policy = policy
        self.default_window_ms = default_window_ms
        self.oracle = oracle
        self._q: List[Tuple[float, int, Request]] = []
        self.n_arrived = 0
        self.brownout_hedges = 0

    def __len__(self) -> int:
        return len(self._q)

    def head_deadline(self) -> Optional[float]:
        return self._q[0][0] if self._q else None

    def arrive(self, t: float, r: Request) -> None:
        window = self.default_window_ms if r.deadline_window_ms is None \
            else r.deadline_window_ms
        deadline = r.arrive_ms + window
        # stamp the ABSOLUTE deadline on the request: drains, retries
        # and expiry all spend this one budget (the shard engine later
        # recomputes the identical value on arrival)
        r.deadline = deadline
        self.n_arrived += 1
        if self.oracle is not None:
            self.oracle.on_router_arrive(t, r, deadline)
        heapq.heappush(self._q, (deadline, r.rid, r))

    def requeue(self, t: float, r: Request) -> None:
        """Re-admit a drained or retried request with its REMAINING
        deadline budget — the absolute deadline stamped at first
        arrival, not a fresh window."""
        if self.oracle is not None:
            self.oracle.on_requeue(t, r)
        heapq.heappush(self._q, (r.deadline, r.rid, r))

    def expire_due(self, t: float) -> List[Request]:
        """Pop and return every queued request whose deadline budget
        has hit zero. Without this, a total-saturation hold would park
        the head forever and the miss would vanish from tail stats."""
        out = []
        while self._q and self._q[0][0] <= t:
            _, _, r = heapq.heappop(self._q)
            if self.oracle is not None:
                self.oracle.on_expire(t, r)
            out.append(r)
        return out

    def shed_over(self, t: float, max_queue: int) -> List[Request]:
        """Graceful degradation: if the queue exceeds ``max_queue``,
        shed the excess starting from the lowest SLO class (largest
        deadline window), latest deadline first within a class. Returns
        the shed requests — the caller accounts them per tenant."""
        n_shed = len(self._q) - max_queue
        if n_shed <= 0:
            return []
        by_class = sorted(self._q, key=lambda e: (
            -(e[2].deadline_window_ms
              if e[2].deadline_window_ms is not None
              else self.default_window_ms), -e[0], -e[1]))
        victims = by_class[:n_shed]
        victim_rids = {e[1] for e in victims}
        self._q = [e for e in self._q if e[1] not in victim_rids]
        heapq.heapify(self._q)
        out = [e[2] for e in victims]
        if self.oracle is not None:
            for r in out:
                self.oracle.on_shed(t, r)
        return out

    def dispatch(self, t: float, views: Tuple[ShardView, ...],
                 browned=frozenset()) -> Optional[Tuple[str, Request]]:
        """Try to place the EDF head; returns ``(shard, request)`` or
        None (empty queue, or every shard refused — a HOLD).

        ``browned`` names shards inside an injected brownout window;
        with the policy's ``hedge_on_brownout`` knob the head is
        steered to a healthy shard whenever one also admits it (a
        placement hedge — never a duplicate dispatch)."""
        if not self._q:
            return None
        head = self._q[0][2]
        target = self.policy.place(views, head)
        if (target is not None and target in browned
                and self.policy.hedge_on_brownout):
            healthy = tuple(v for v in views if v.name not in browned)
            alt = self.policy.place(healthy, head) if healthy else None
            if alt is not None:
                target = alt
                self.brownout_hedges += 1
        if self.oracle is not None:
            self.oracle.on_dispatch(t, head, views, target, self._q)
        if target is None:
            return None
        heapq.heappop(self._q)
        return target, head


# -------------------------------------------------------- cluster engine


class ClusterEngine:
    """N shard engines + a router on ONE global event heap.

    Event tuples are ``(t, seq, shard, kind, payload, gen)``: shard
    engines push through the injected sink
    (``Engine.begin_run(push=...)``), the router contributes
    ``(ROUTER, "route", request)`` arrivals and the cluster its periodic
    ``(ROUTER, "window", None)`` observation events; fault injection
    (``repro_torch.sched.faults``) rides the same heap under the ``FAULTS``
    pseudo-shard. ``gen`` is the target shard's incarnation when the
    event was pushed — a crash bumps it, so stale events for a dead or
    restarted shard are salvaged (their requests re-enter the router)
    instead of reaching the new incarnation. One pop loop dispatches
    each event back to its shard's ``handle`` — N engines interleave in
    exact global time order, and after every event the router re-tries
    its head (a completion on any shard can unblock admission)."""

    def __init__(self, cluster: ClusterTopology, policy_name: str,
                 model: Optional[PoolModel] = None,
                 cfg: Optional[ClusterConfig] = None,
                 executors: Optional[Dict[str, object]] = None):
        """``executors`` maps shard name -> live executor (real-model
        mode: each shard's jitted prefill/decode runs on that shard's
        ``repro_torch.dist.DistContext`` mesh slice and reports measured
        durations); None prices work through the shared PoolModel."""
        self.cluster = cluster
        self.policy_name = policy_name
        self.policy = make_cluster_policy(policy_name)
        self.model = model or PoolModel()
        self.cfg = cfg or ClusterConfig()
        serve_cfg = self.cfg.shard_serve_config()
        executors = executors or {}
        self.engines: Dict[str, Engine] = {
            s.name: Engine(s.topology, make_policy(s.policy), self.model,
                           serve_cfg, executor=executors.get(s.name),
                           name=s.name)
            for s in cluster.shards}

    # ------------------------------------------------------------- run

    def run(self, requests: List[Request],
            horizon_ms: Optional[float] = None,
            oracle=None, fault_plan=None,
            fault_horizon_ms: Optional[float] = None) -> ClusterMetrics:
        """Replay ``requests`` through the router + shards. ``oracle``
        (see ``repro_torch.sched.replay.ClusterOracle``) carries one
        per-shard engine oracle each shard binds to, plus router hooks
        and (with faults) a ``FaultOracle``.

        ``fault_plan`` is a resolved :class:`repro_torch.sched.faults
        .FaultPlan` (or None); its events are expanded over
        ``fault_horizon_ms`` (default: the run horizon) so faults stop
        arriving before the post-trace drain window and every request
        reaches a terminal state — completed, shed, or expired."""
        horizon = float("inf") if horizon_ms is None else horizon_ms
        plan = fault_plan
        if plan is not None and horizon == float("inf"):
            raise ValueError("fault injection needs a finite horizon")
        heap: List[Tuple[float, int, str, str, object, int]] = []
        seq = 0
        # per-shard incarnation counter: events stamped with an old
        # generation (pushed before a crash) are salvaged or discarded
        # at pop time instead of reaching the restarted engine
        gen: Dict[str, int] = {n: 0 for n in self.engines}
        dead: set = set()          # crashed (detected or not)
        detected: set = set()      # crashed AND detection fired
        limbo: Dict[str, List[Request]] = {n: [] for n in self.engines}
        brownout_until: Dict[str, float] = {n: 0.0 for n in self.engines}
        straggler_until: Dict[str, float] = {n: 0.0
                                             for n in self.engines}
        partials: Dict[str, List[ServeMetrics]] = \
            {n: [] for n in self.engines}
        n_in_air = 0               # retry events pushed, not yet popped

        def push(eng, t, kind, payload):
            nonlocal seq
            g = gen.get(eng.name, 0)
            heapq.heappush(heap, (t, seq, eng.name, kind, payload, g))
            seq += 1

        router_oracle = getattr(oracle, "router", None)
        # fault hooks only fire under injection — a no-fault replay
        # must stay byte-identical to the pre-fault engine
        fo = getattr(oracle, "faults", None) if plan is not None \
            else None
        policy = self.policy
        if fo is not None:
            fo.on_run_start(plan, policy.max_attempts)
        router = Router(policy, self.cfg.serve.deadline_window_ms,
                        router_oracle)
        engines = self.engines
        for name, eng in engines.items():
            shard_oracle = oracle.shard(name) if oracle is not None \
                else None
            eng.begin_run([], horizon_ms, oracle=shard_oracle, push=push)
        # requests routed to a shard whose "arrive" event has not popped
        # yet: counted into the shard's view depth so back-to-back
        # dispatches at one instant see each other's placements
        pending: Dict[str, int] = {n: 0 for n in engines}
        routed: Dict[str, int] = {n: 0 for n in engines}
        dispatch_t: Dict[int, float] = {}
        m = ClusterMetrics(routed=routed)
        m.injected = len(requests)
        # per-shard routing windows over the live frequency domains;
        # rolled at every cluster window event
        route_win = {n: ResidencyWindow(engines[n].domains)
                     for n in engines}
        win_t0 = 0.0

        # ------------------------------------------- fault machinery

        def count(d: Dict[str, int], key: str):
            d[key] = d.get(key, 0) + 1

        def expire_one(t: float, r: Request):
            count(m.deadline_missed_at_router, r.tenant)
            if fo is not None:
                fo.on_expire(t, r)

        def shed_one(t: float, r: Request, reason: str):
            count(m.shed, r.tenant)
            count(m.shed_reasons, reason)
            if fo is not None:
                fo.on_shed(t, r, reason)

        def retry(t: float, r: Request):
            """Deadline-aware retry with capped exponential backoff:
            reset progress, spend the remaining deadline budget, shed
            at the attempt cap — never silently dropped."""
            nonlocal n_in_air
            r.prefilled = 0
            r.generated = 0
            r.ttft_ms = None
            r.itl_ms = []
            r.last_token_ms = None
            r.done_ms = None
            r.attempts += 1
            if r.attempts >= policy.max_attempts:
                shed_one(t, r, "retry_exhausted")
                return
            back = min(policy.retry_backoff_ms * (2 ** (r.attempts - 1)),
                       policy.retry_backoff_cap_ms)
            t_re = t + back
            if t_re >= r.deadline:
                expire_one(t, r)
                return
            m.retries += 1
            if fo is not None:
                fo.on_retry(t, r)
            push(_FaultTag(), t_re, "retry", r)
            n_in_air += 1

        def handle_drop(t: float, r: Request):
            # Engine.on_drop: the response was lost at completion time
            m.dropped += 1
            if fo is not None:
                fo.on_drop(t, r)
            retry(t, r)

        if plan is not None:
            if plan.drop_prob > 0.0:
                def _filter(t, r, _p=plan):
                    return not _p.should_drop(r.rid, r.attempts)
            else:
                _filter = None
            for eng in engines.values():
                eng.completion_filter = _filter
                eng.on_drop = handle_drop
                eng.on_complete = (fo.on_complete if fo is not None
                                   else None)

        def salvage(t: float, shard: str, kind: str, payload):
            """An event for a dead shard (or a stale incarnation): its
            requests are in-flight-but-unacked — recover them into the
            drain/retry path; pure engine events are discarded."""
            if kind == "arrive":
                pending[shard] -= 1
                dispatch_t.pop(payload.rid, None)
                reqs = [payload]
            elif kind == "deliver":
                reqs = list(payload[1])
            else:
                return
            if shard in dead and shard not in detected:
                # crashed but not detected yet: stuck on the dead node
                # until the detection drain
                limbo[shard].extend(reqs)
            else:
                for r in reqs:
                    retry(t, r)

        def fail_shard(t: float, ev):
            name = ev.shard
            if name in dead:
                return
            dead.add(name)
            count(m.faults_injected, "shard_fail")
            if fo is not None:
                fo.on_fault(t, ev)
            eng = engines[name]
            # crash-stop: capture resident requests (EDF order), close
            # this incarnation's metrics; heap events for it are
            # salvaged/discarded from now on
            limbo[name].extend(eng.drain_resident())
            partials[name].append(eng.finish())
            push(_FaultTag(), t + plan.detection_latency_ms,
                 "detect", name)

        def detect_shard(t: float, name: str):
            if name not in dead or name in detected:
                return
            detected.add(name)
            if fo is not None:
                fo.on_detect(t, name)
            drain(t, name)

        def drain(t: float, name: str):
            """Requeue everything stuck on a dead shard, EDF order,
            remaining deadline budget — the ROADMAP drain primitive."""
            reqs = limbo[name]
            limbo[name] = []
            reqs.sort(key=lambda r: (r.deadline, r.rid))
            m.drained += len(reqs)
            if fo is not None:
                fo.on_drain(t, name, reqs)
            for r in reqs:
                retry(t, r)

        def recover_shard(t: float, name: str):
            if name not in dead:
                return
            if name not in detected and limbo[name]:
                # recovered before the failure was even detected: the
                # node comes back with its requests; drain them anyway
                # (the restart wiped engine state)
                drain(t, name)
            dead.discard(name)
            detected.discard(name)
            gen[name] += 1
            m.shard_recoveries += 1
            if fo is not None:
                fo.on_recover(t, name)
            eng = engines[name]
            sub = oracle.restart_shard(name) if oracle is not None \
                else None
            eng.begin_run([], horizon_ms, oracle=sub, push=push, t0=t)
            route_win[name] = ResidencyWindow(eng.domains)

        def fault_event(t: float, kind: str, payload):
            nonlocal n_in_air
            if kind == "retry":
                n_in_air -= 1
                router.requeue(t, payload)
                return
            if kind == "detect":
                detect_shard(t, payload)
                return
            if kind == "straggler_end":
                if payload not in dead and t >= straggler_until[payload]:
                    engines[payload].slow_factor = 1.0
                return
            ev = payload
            if kind == "shard_fail":
                fail_shard(t, ev)
            elif kind == "shard_recover":
                recover_shard(t, ev.shard)
            elif kind == "shard_brownout":
                if ev.shard in dead:
                    return
                count(m.faults_injected, "shard_brownout")
                if fo is not None:
                    fo.on_fault(t, ev)
                until = t + ev.duration_ms
                brownout_until[ev.shard] = max(
                    brownout_until[ev.shard], until)
                for d in engines[ev.shard].domains.values():
                    d.set_clamp(ev.level, until)
            elif kind == "straggler":
                if ev.shard in dead:
                    return
                count(m.faults_injected, "straggler")
                if fo is not None:
                    fo.on_fault(t, ev)
                until = t + ev.duration_ms
                straggler_until[ev.shard] = max(
                    straggler_until[ev.shard], until)
                engines[ev.shard].slow_factor = ev.factor
                push(_FaultTag(), until, "straggler_end", ev.shard)

        # ------------------------------------------------ router loop

        def views(t: float) -> Tuple[ShardView, ...]:
            out = []
            for name in self.cluster.names:
                eng = engines[name]
                deltas = route_win[name].peek()
                busy = sum(d["busy"] for d in deltas.values())
                reduced = sum(d["reduced"] for d in deltas.values())
                energy = sum(d["energy"] for d in deltas.values())
                elapsed = t - win_t0
                out.append(ShardView(
                    name=name,
                    n_units=eng.topo.n_units,
                    heavy_units=eng.topo.heavy_units,
                    queue_depth=(eng.queue_depth() + pending[name]
                                 + len(limbo[name])),
                    admit_limit=self.cfg.admit_limit(eng.topo),
                    license_residency=reduced / busy if busy else 0.0,
                    energy_rate=energy / elapsed if elapsed > 0 else 0.0,
                    reduced_now=any(
                        d.speed_ghz(t) < d.cfg.freqs_ghz[0] - 1e-12
                        for d in eng.domains.values()),
                    failed=name in detected))
            return tuple(out)

        wake_t = float("inf")

        def drain_router(t: float):
            nonlocal wake_t
            if not len(router):     # fast path: called after every event
                return
            for r in router.expire_due(t):
                expire_one(t, r)
            browned = frozenset(
                n for n, u in brownout_until.items()
                if u > t and n not in dead) if plan is not None \
                else frozenset()
            while True:
                placed = router.dispatch(t, views(t), browned)
                if placed is None:
                    if len(router):
                        m.router_holds += 1
                    break
                target, r = placed
                if fo is not None:
                    fo.on_dispatch(t, r, target)
                pending[target] += 1
                routed[target] += 1
                dispatch_t[r.rid] = t
                engines[target]._push(t, "arrive", r)
            if plan is not None and len(router):
                # graceful degradation: bound the held backlog by the
                # ALIVE capacity; shed lowest SLO class first
                cap = sum(self.cfg.admit_limit(engines[n].topo)
                          for n in engines if n not in detected)
                max_q = max(1, int(policy.shed_queue_factor * cap))
                for r in router.shed_over(t, max_q):
                    shed_one(t, r, "overload")
            if len(router):
                # exact expiry even while the cluster idles: wake at
                # the head's deadline
                head_dl = router.head_deadline()
                if head_dl is not None and t < head_dl < horizon \
                        and head_dl < wake_t:
                    wake_t = head_dl
                    push(_RouterTag(), head_dl, "wake", None)
            m.router_max_queue = max(m.router_max_queue, len(router))

        def window(t: float):
            nonlocal win_t0
            signals, topologies = {}, {}
            for name, eng in engines.items():
                if name in dead:
                    continue
                sig = eng.load_signals(t, min_window_ms=1e-9)
                if sig is not None:
                    signals[name] = sig
                topologies[name] = eng.topo
            for name, new in sorted(
                    self.policy.reshard(topologies, signals).items()):
                engines[name].apply_topology(t, new)
                m.resize_events.append(
                    (t, name, {p.name: p.n_units for p in new}))
            for w in route_win.values():
                w.roll()
            win_t0 = t

        for r in sorted(requests, key=lambda r: r.arrive_ms):
            push(_RouterTag(), r.arrive_ms, "route", r)
        if self.cfg.window_ms > 0 and horizon != float("inf"):
            t_win = self.cfg.window_ms
            while t_win < horizon:
                push(_RouterTag(), t_win, "window", None)
                t_win += self.cfg.window_ms
        if plan is not None:
            f_horizon = horizon if fault_horizon_ms is None \
                else fault_horizon_ms
            for ev in plan.events(self.cluster.names, f_horizon):
                push(_FaultTag(), ev.t, ev.kind, ev)

        last_t = 0.0
        while heap:
            t, _, shard, kind, payload, g = heapq.heappop(heap)
            if t >= horizon:
                break
            last_t = t
            if shard == FAULTS:
                fault_event(t, kind, payload)
                drain_router(t)
                continue
            if shard == ROUTER:
                if kind == "route":
                    router.arrive(t, payload)
                elif kind == "wake":
                    wake_t = float("inf")
                elif kind == "window":
                    window(t)
                drain_router(t)
                continue
            if shard in dead or g != gen[shard]:
                salvage(t, shard, kind, payload)
                drain_router(t)
                continue
            if kind == "arrive":
                pending[shard] -= 1
                w = dispatch_t.pop(payload.rid, None)
                if w is not None:
                    m.router_wait_ms.append(t - payload.arrive_ms)
            engines[shard].handle(t, kind, payload)
            drain_router(t)

        for name, eng in engines.items():
            parts = partials[name]
            if name not in dead:
                parts = parts + [eng.finish()]
            m.shard_metrics[name] = _merge_serve_metrics(parts)
        m.total_ms = horizon if horizon != float("inf") else last_t
        m.brownout_hedges = router.brownout_hedges
        # conservation residue: requests still queued, resident on a
        # live shard, stuck in an undetected crash, in a handoff or
        # routed-but-unarrived heap event, or between retries
        m.leftover = (len(router) + n_in_air
                      + sum(len(v) for v in limbo.values())
                      + sum(pending.values())
                      + sum(eng.queue_depth()
                            for n, eng in engines.items()
                            if n not in dead))
        if oracle is not None:
            oracle.on_end(m, router)
        return m


def _merge_serve_metrics(parts: List[ServeMetrics]) -> ServeMetrics:
    """Merge the per-incarnation :class:`ServeMetrics` of a shard that
    crashed and recovered (latency samples concatenate, counters sum,
    per-pool frequency snapshots combine with busy-weighted average
    frequency)."""
    if not parts:
        return ServeMetrics()
    if len(parts) == 1:
        return parts[0]
    out = ServeMetrics()
    for p in parts:
        out.ttft_ms.extend(p.ttft_ms)
        out.itl_ms.extend(p.itl_ms)
        out.completed += p.completed
        out.prefill_busy_ms += p.prefill_busy_ms
        out.decode_busy_ms += p.decode_busy_ms
        out.steals += p.steals
        out.handoffs += p.handoffs
        for pool, kinds in p.pool_busy.items():
            slot = out.pool_busy.setdefault(
                pool, {"heavy": 0.0, "light": 0.0})
            for k, v in kinds.items():
                slot[k] = slot.get(k, 0.0) + v
        for pool, snap in p.pool_freq.items():
            cur = out.pool_freq.get(pool)
            if cur is None:
                out.pool_freq[pool] = dict(
                    snap, time_at_level=list(snap["time_at_level"]))
                continue
            busy = cur["busy"] + snap["busy"]
            cur["avg_freq_ghz"] = (
                (cur["avg_freq_ghz"] * cur["busy"]
                 + snap["avg_freq_ghz"] * snap["busy"]) / busy
                if busy else cur["avg_freq_ghz"])
            cur["time_at_level"] = [
                a + b for a, b in zip(cur["time_at_level"],
                                      snap["time_at_level"])]
            for k in ("throttled", "busy", "reduced", "transitions",
                      "energy_proxy"):
                cur[k] += snap[k]
        out.resize_events.extend(p.resize_events)
    out.total_ms = max(p.total_ms for p in parts)
    return out


class _RouterTag:
    """Duck-typed event source so cluster-level events ride the same
    injected sink signature as shard engines."""
    name = ROUTER


class _FaultTag:
    """Event source tag for fault-injection events on the global heap."""
    name = FAULTS
