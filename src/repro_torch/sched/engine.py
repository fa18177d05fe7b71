"""Event-driven serving engine on the shared Policy/Topology API.

The paper's mechanism, transplanted: prefill (MXU-saturating ≈ AVX task)
is HEAVY work; decode (memory-bound, latency-critical ≈ scalar task) is
LIGHT. The engine is pure mechanism — a heap of arrival/pool-free
events over a :class:`repro_torch.sched.topology.Topology` — and every
placement / steal / preemption / resize decision is delegated to a
:class:`repro_torch.sched.policy.Policy`:

  * ``SpecializedPolicy`` reproduces the paper's asymmetric rule: the
    decode pool NEVER prefills (one interleaved prefill stalls every
    co-located decode — the 2 ms-tail analogue); the prefill pool MAY
    run decode batches when idle (work conservation, §2.1/Fig. 3);
  * ``SharedBaselinePolicy`` over ``Topology.shared(n)`` is vLLM-style
    continuous batching with interleaved chunked prefill;
  * requests are deadline-scheduled — EDF by
    ``arrive_ms + deadline_window_ms`` — and migrate pools after
    prefill via a KV-cache handoff charged to the source pool (the
    400-500 ns migration analogue). Exactly one handoff is counted per
    pool transfer.

Service times come either from a :class:`PoolModel` (roofline terms of
a dry-run cell; deterministic, used by benchmarks) or from a live
``executor`` that runs real jitted prefill/decode and reports measured
durations (``launch/serve.py``).

The engine is *frequency-native*: every pool carries a
:class:`repro_torch.sched.freq.FrequencyDomain` (the same license state
machine that drives the OS simulator's cores) and every service
duration is integrated through it. A heavy prefill requests/refreshes
the pool's license; a decode landing inside the revert hysteresis runs
slow because the pool's clock is still reduced — the paper's
trailing-scalar slowdown, emergent instead of hand-tuned. License
reverts are explicit events on the engine's heap, and per-pool
frequency residency / transition counts / throttled time / an energy
proxy land in :class:`ServeMetrics`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.sched.freq import (ENGINE_FREQ_MS, KV_HANDOFF_MS,
                              FreqDomainConfig, FrequencyDomain,
                              ResidencyWindow)
from repro_torch.sched.policy import LoadSignals, Policy
from repro_torch.sched.topology import Topology, WorkKind


@dataclass(slots=True)
class Request:
    rid: int
    arrive_ms: float
    prompt_len: int
    max_new: int
    # SLO class (repro_torch.sched.workload): a per-request deadline window
    # overrides ServeConfig.deadline_window_ms in the EDF order
    tenant: str = "default"
    deadline_window_ms: Optional[float] = None
    # progress
    prefilled: int = 0
    generated: int = 0
    # metrics
    ttft_ms: Optional[float] = None
    itl_ms: List[float] = field(default_factory=list)
    done_ms: Optional[float] = None
    last_token_ms: Optional[float] = None
    deadline: float = 0.0
    # retry accounting (cluster tier): how many times this request has
    # re-entered the router after a drain or a dropped response. The
    # deadline above is ABSOLUTE and survives retries — router queueing,
    # drains and backoff all spend the same budget.
    attempts: int = 0

    @property
    def decoding(self) -> bool:
        return self.prefilled >= self.prompt_len and \
            self.generated < self.max_new


@dataclass
class PoolModel:
    """Service-time model per device group, derived from roofline terms.

    prefill: compute-bound -> ms per token per device
    decode:  memory-bound  -> ms per iteration (cache+params read) with a
             per-sequence increment.
    """
    prefill_ms_per_ktok: float = 16.0      # per device
    decode_fixed_ms: float = 4.0           # params read / iteration
    decode_ms_per_seq: float = 0.08        # cache read per active seq
    # KV migration cost between pools. Numerically equal to the license
    # revert hysteresis (ENGINE_FREQ_MS.hysteresis) BY COINCIDENCE —
    # see the block comment in repro_torch.sched.freq; never derive one from
    # the other.
    handoff_ms: float = KV_HANDOFF_MS

    def prefill_ms(self, tokens: int, n_dev: int) -> float:
        return self.prefill_ms_per_ktok * tokens / 1000.0 / max(n_dev, 1)

    def decode_ms(self, batch: int, n_dev: int) -> float:
        return self.decode_fixed_ms / max(n_dev, 1) \
            + self.decode_ms_per_seq * batch / max(n_dev, 1)


@dataclass
class ServeConfig:
    """Engine knobs. The pool layout and the specialization decision no
    longer live here — they are the ``Topology`` and ``Policy`` passed
    to :class:`Engine`."""
    prefill_chunk: int = 2048
    decode_batch_max: int = 256
    deadline_window_ms: float = 50.0
    resize_interval_ms: float = 1000.0
    # per-pool frequency-domain physics (license levels, 0.5 ms grant
    # window, 2 ms revert hysteresis) — the ms-base counterpart of the
    # OS simulator's per-core LicenseConfig
    freq: FreqDomainConfig = ENGINE_FREQ_MS


@dataclass
class ServeMetrics:
    ttft_ms: List[float] = field(default_factory=list)
    itl_ms: List[float] = field(default_factory=list)
    completed: int = 0
    total_ms: float = 0.0
    prefill_busy_ms: float = 0.0
    decode_busy_ms: float = 0.0
    steals: int = 0
    handoffs: int = 0
    # per-pool busy time by work kind ("heavy" = prefill, "light" = decode)
    pool_busy: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # per-pool frequency-domain accounting (FrequencyDomain.snapshot():
    # time_at_level / throttled / transitions / avg_freq_ghz / energy)
    pool_freq: Dict[str, Dict] = field(default_factory=dict)
    # (t_ms, {pool: n_units}) for every applied policy resize
    resize_events: List[Tuple[float, Dict[str, int]]] = \
        field(default_factory=list)
    # cached sorted views of ttft_ms / itl_ms, maintained by p(); an
    # append since the last sort (length mismatch) invalidates them
    _ttft_sorted: Optional[List[float]] = field(
        default=None, init=False, repr=False, compare=False)
    _itl_sorted: Optional[List[float]] = field(
        default=None, init=False, repr=False, compare=False)

    def charge(self, pool: str, kind: str, ms: float):
        slot = self.pool_busy.setdefault(pool, {"heavy": 0.0, "light": 0.0})
        slot[kind] += ms
        if kind == "heavy":
            self.prefill_busy_ms += ms
        else:
            self.decode_busy_ms += ms

    def p(self, xs, q):
        """Percentile over ``xs``. When ``xs`` is one of this object's
        latency lists (ttft_ms / itl_ms) the sorted view is cached and
        invalidated by appends (length check), so a summary() computing
        four percentiles sorts each list once — not once per
        percentile. Arbitrary other lists are sorted on the spot."""
        if not xs:
            return 0.0
        if xs is self.ttft_ms:
            s = self._ttft_sorted
            if s is None or len(s) != len(xs):
                s = self._ttft_sorted = sorted(xs)
        elif xs is self.itl_ms:
            s = self._itl_sorted
            if s is None or len(s) != len(xs):
                s = self._itl_sorted = sorted(xs)
        else:
            s = sorted(xs)
        return s[min(int(q * len(s)), len(s) - 1)]

    def summary(self) -> Dict[str, float]:
        busy = sum(f["busy"] for f in self.pool_freq.values())
        freq_time = sum(f["avg_freq_ghz"] * f["busy"]
                        for f in self.pool_freq.values())
        reduced = sum(f["reduced"] for f in self.pool_freq.values())
        return {
            "throughput_tok_s": 1000.0 * len(self.itl_ms)
            / self.total_ms if self.total_ms else 0.0,
            "ttft_p50_ms": self.p(self.ttft_ms, 0.5),
            "ttft_p99_ms": self.p(self.ttft_ms, 0.99),
            "itl_p50_ms": self.p(self.itl_ms, 0.5),
            "itl_p99_ms": self.p(self.itl_ms, 0.99),
            "completed": self.completed,
            "steals": self.steals,
            "handoffs": self.handoffs,
            "resizes": len(self.resize_events),
            # frequency/energy columns (busy-time-weighted across pools)
            "avg_freq_ghz": freq_time / busy if busy else 0.0,
            "license_residency": reduced / busy if busy else 0.0,
            "throttled_ms": sum(f["throttled"]
                                for f in self.pool_freq.values()),
            "freq_transitions": sum(f["transitions"]
                                    for f in self.pool_freq.values()),
            "energy_proxy": sum(f["energy_proxy"]
                                for f in self.pool_freq.values()),
        }


class Engine:
    """Event-driven engine: a heap of (arrival | pool-free) events.

    Replaces the discrete-time argmin loop: pools sleep when idle and
    wake on the events that can give them work (arrivals for
    heavy-eligible pools, handoffs/evictions for the target pool), so
    simulated time advances directly between events.

    The engine is *shard-embeddable*: the run lifecycle is split into
    ``begin_run`` / ``handle`` / ``finish`` with an injectable event
    sink, so a :class:`repro_torch.sched.cluster.ClusterEngine` can interleave
    N engines on ONE global heap — each shard pushes its events through
    the cluster's sink instead of a private heap, and the cluster loop
    dispatches popped events back to ``shard.handle``. Standalone
    ``run()`` wraps the same three phases around a private heap, so
    single-node behaviour is bit-identical to the pre-shard engine.
    """

    def __init__(self, topology: Topology, policy: Policy,
                 model: Optional[PoolModel] = None,
                 cfg: Optional[ServeConfig] = None,
                 executor: Optional[object] = None,
                 name: str = "engine"):
        self._topo0 = topology          # every run starts from this
        self.topo = topology
        self.policy = policy
        self.model = model or PoolModel()
        self.cfg = cfg or ServeConfig()
        self.executor = executor
        self.name = name                # shard id in cluster mode
        self.oracle = None              # set per run()
        self.domains: Dict[str, FrequencyDomain] = {}   # set per run()
        # fault-injection hooks (sched/faults.py, wired by the cluster;
        # all inert by default). slow_factor scales every service
        # duration while a straggler window is open; completion_filter
        # decides whether a finishing request's response is actually
        # delivered (False = drop fault — the request leaves the batch
        # uncompleted and on_drop fires); on_complete observes every
        # delivered completion (exactly-once conservation auditing).
        self.slow_factor = 1.0
        self.completion_filter = None   # (t, Request) -> bool
        self.on_complete = None         # (t, Request) callback
        self.on_drop = None             # (t, Request) callback

    # --------------------------------------------------- run lifecycle

    def begin_run(self, requests: List[Request],
                  horizon_ms: Optional[float] = None,
                  oracle: Optional[object] = None,
                  push=None, t0: float = 0.0) -> None:
        """Reset per-run state and enqueue ``requests`` as arrivals.

        ``push`` is the event sink: ``None`` uses a private heap (the
        standalone ``run()`` loop); a cluster passes
        ``push(engine, t, kind, payload)`` so shard events land on the
        shared heap, globally ordered with every other shard's.

        ``t0`` is the simulated time this incarnation starts at — 0 for
        a normal run, the recovery time when a cluster restarts a
        crashed shard (so the first resize window is not measured from
        the beginning of time)."""
        cfg = self.cfg
        self.topo = self._topo0         # resizes do not leak across runs
        self.oracle = orc = oracle
        if orc is not None:
            orc.bind(self)
        self.m = ServeMetrics()
        self.horizon = float("inf") if horizon_ms is None else horizon_ms
        self._n_units = {p.name: p.n_units for p in self.topo}
        self._active = {p.name: [] for p in self.topo}
        # one frequency domain per pool, fresh per run (license state
        # must not leak across replays); per-span recording only when an
        # oracle wants to audit the frequency trace
        self.domains = {p.name: FrequencyDomain(cfg.freq,
                                                record=orc is not None)
                        for p in self.topo}
        self._idle = set(self._n_units)
        self._waiting: List[Tuple[float, int, Request]] = []   # EDF heap
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._ext_push = push
        self.n_inflight = 0             # requests inside a handoff copy
        # resize window accumulators; the reduced-frequency window
        # (ResidencyWindow) measures the license residency the adaptive
        # policy sizes pools from
        self._win_start = t0
        self._win_busy = {"heavy": 0.0, "light": 0.0}
        self._win_handoffs = 0
        self._win_freq = ResidencyWindow(self.domains)
        self._last_t = t0
        self.slow_factor = 1.0          # faults never leak across runs
        for r in sorted(requests, key=lambda r: r.arrive_ms):
            self._push(r.arrive_ms, "arrive", r)

    def _push(self, t: float, kind: str, payload):
        if self._ext_push is not None:
            self._ext_push(self, t, kind, payload)
        else:
            heapq.heappush(self._events, (t, self._seq, kind, payload))
            self._seq += 1

    def queue_depth(self) -> int:
        """Waiting + active + in-flight requests resident on this
        engine — the router's per-shard backlog signal."""
        return len(self._waiting) + self.n_inflight \
            + sum(len(a) for a in self._active.values())

    def drain_resident(self) -> List[Request]:
        """Crash-stop drain: remove and return every request resident
        on this engine (EDF-waiting heap + active decode batches), in
        EDF order. Requests inside a handoff copy ride on the event
        heap as ``deliver`` payloads — the cluster salvages those from
        the stale events itself — so ``n_inflight`` is simply reset
        here and a later ``begin_run`` starts clean."""
        out = [r for _, _, r in self._waiting]
        self._waiting.clear()
        for pool in self._active:
            out.extend(self._active[pool])
            self._active[pool] = []
        self.n_inflight = 0
        out.sort(key=lambda r: (r.deadline, r.rid))
        return out

    def handle(self, t: float, kind: str, payload) -> None:
        """Process one popped event. The caller (standalone loop or
        cluster) owns the horizon check."""
        self._last_t = t
        self._maybe_resize(t)
        orc = self.oracle
        if kind == "arrive":
            r: Request = payload
            window = self.cfg.deadline_window_ms \
                if r.deadline_window_ms is None else r.deadline_window_ms
            r.deadline = r.arrive_ms + window
            if orc is not None:
                orc.on_arrive(t, r)
            heapq.heappush(self._waiting, (r.deadline, r.rid, r))
            # wake by policy eligibility, not topology capability: a
            # permissive policy over a split topology runs prefill
            # everywhere
            for p in self.topo.pools:
                if self.policy.eligible(self.topo, p, WorkKind.HEAVY):
                    self._wake(p.name, t)
            return
        if kind == "deliver":
            target, reqs = payload
            self._active[target].extend(reqs)
            self.n_inflight -= len(reqs)
            self._wake(target, t)
            return
        if kind == "freq":
            # explicit license transition (grant or revert) at its
            # boundary — applied even while the pool is idle, so
            # residency timelines and transition counts are exact
            d = self.domains[payload]
            d.advance(t)
            if orc is not None:
                fn = getattr(orc, "on_freq", None)
                if fn is not None:
                    fn(t, payload, d)
            self._sched_freq(payload, t)
            return
        pool: str = payload
        free_at = self._step(pool, t)
        if free_at is None:
            if orc is not None:
                orc.on_idle(t, pool, len(self._waiting),
                            len(self._active[pool]))
            self._idle.add(pool)
        else:
            self._push(free_at, "step", pool)
        self._sched_freq(pool, t)

    def finish(self) -> ServeMetrics:
        m = self.m
        m.total_ms = self.horizon if self.horizon != float("inf") \
            else self._last_t
        for name, d in self.domains.items():
            m.pool_freq[name] = d.snapshot()
        if self.oracle is not None:
            self.oracle.on_end(m)
        return m

    def run(self, requests: List[Request],
            horizon_ms: Optional[float] = None,
            oracle: Optional[object] = None) -> ServeMetrics:
        """Replay ``requests``; an optional ``oracle`` (duck-typed, see
        ``repro_torch.sched.replay.EngineOracle``) observes every scheduling
        event and checks engine invariants — EDF order, one handoff per
        pool transfer, work conservation, capability respect."""
        self.begin_run(requests, horizon_ms, oracle)
        events = self._events
        while events:
            t, _, kind, payload = heapq.heappop(events)
            if t >= self.horizon:
                break
            self.handle(t, kind, payload)
        return self.finish()

    # -------------------------------------------------- event internals

    def _sched_freq(self, pool: str, t: float):
        """Schedule the pool's next license transition (grant or
        revert) as an explicit heap event, so level changes apply at
        their boundary even while the pool is idle."""
        nxt = self.domains[pool].next_event(t)
        if nxt is not None:
            self._push(nxt, "freq", pool)

    def _wake(self, pool: str, t: float):
        if pool in self._idle:
            self._idle.discard(pool)
            self._push(t, "step", pool)

    def _transfer(self, reqs: List[Request], src: str, target: str,
                  t: float):
        """Move decoding requests between pools: one handoff each.

        Delivery is an event at ``t`` (the handoff completion time),
        not an immediate list append: a busy target pool must not
        see — and decode — a request before its prefill+handoff has
        finished in simulated time. (The immediate-append version
        produced negative inter-token latencies; the replay oracle's
        monotonicity check caught it.)"""
        if not reqs:
            return
        if self.oracle is not None:
            self.oracle.on_transfer(t, reqs, src, target)
        self.m.handoffs += len(reqs)
        self._win_handoffs += len(reqs)
        self.n_inflight += len(reqs)
        self._push(t, "deliver", (target, list(reqs)))

    def load_signals(self, t: float,
                     min_window_ms: Optional[float] = None
                     ) -> Optional[LoadSignals]:
        """Windowed load observation over [win_start, t), or None while
        the window is still shorter than ``resize_interval_ms`` (or the
        explicit ``min_window_ms`` override). Closing the window resets
        the accumulators — the caller decides the cadence: the engine's
        own event loop uses the config interval, while a cluster sets
        the shard interval to +inf and reads signals on ITS window via
        the override (so shard engines never self-resize or consume the
        window the cluster is about to observe)."""
        cfg = self.cfg
        window = t - self._win_start
        if window < (cfg.resize_interval_ms if min_window_ms is None
                     else min_window_ms):
            return None
        win_busy, n_units = self._win_busy, self._n_units
        busy = win_busy["heavy"] + win_busy["light"]
        total = sum(n_units.values())
        heavy_pools = self.topo.pools_with(WorkKind.HEAVY)
        reduced = self._win_freq.peek_reduced(
            p.name for p in heavy_pools)
        sig = LoadSignals(
            heavy_share=win_busy["heavy"] / busy if busy else 0.0,
            light_share=win_busy["light"] / busy if busy else 0.0,
            utilization=busy / (window * total) if total else 0.0,
            type_changes_per_s=2e3 * self._win_handoffs / window,
            heavy_residency=min(
                win_busy["heavy"] / window / max(
                    sum(n_units[p.name] for p in heavy_pools), 1),
                1.0),
            license_residency=min(
                reduced / window / max(len(heavy_pools), 1), 1.0),
            window_ms=window)
        self._win_start, self._win_handoffs = t, 0
        self._win_busy = {"heavy": 0.0, "light": 0.0}
        self._win_freq.roll()
        return sig

    def apply_topology(self, t: float, new: Topology) -> None:
        """Install a resized topology (engine-local resize, or a
        cluster-level policy resizing this shard)."""
        self.topo = new
        for p in new:
            self._n_units[p.name] = p.n_units
        self.m.resize_events.append((t, dict(self._n_units)))

    def _maybe_resize(self, t: float):
        sig = self.load_signals(t)
        if sig is None:
            return
        new = self.policy.resize(self.topo, sig)
        if new is not None:
            self.apply_topology(t, new)

    def _charge(self, pool: str, kind: str, ms: float):
        self.m.charge(pool, kind, ms)
        # resize signals accumulate device-ms, not pool-ms: the work
        # mix must read the same whatever the current pool split is
        self._win_busy[kind] += ms * self._n_units[pool]

    def _step(self, pool: str, t: float) -> Optional[float]:
        """Run one scheduling decision; return the pool-free time or
        None when the pool found nothing to do."""
        policy, active, waiting = self.policy, self._active, self._waiting
        pobj = self.topo.pool(pool)
        if waiting and policy.eligible(self.topo, pobj, WorkKind.HEAVY):
            # heavy work waits for this pool: stolen light work leaves
            # (the paper's IPI preemption of scalar tasks on AVX cores)
            if active[pool] and policy.on_type_change(
                    self.topo, pobj,
                    WorkKind.LIGHT).yield_if_heavy_waiting:
                evicted, active[pool] = active[pool], []
                target = next((n for n in policy.placement(
                    self.topo, WorkKind.LIGHT) if n != pool), None)
                if target is not None:
                    self._transfer(evicted, pool, target, t)
                else:
                    active[pool] = evicted
            end = t
            burst = max(1, policy.heavy_burst(self.topo, pobj))
            for _ in range(burst):
                if not waiting:
                    break
                end = self._prefill_chunk(pool, self._n_units[pool], end)
            return end
        if active[pool]:
            if pool not in policy.placement(self.topo, WorkKind.LIGHT):
                self.m.steals += 1      # heavy pool running decode batches
            return self._decode_round(pool, self._n_units[pool], t)
        return None

    # ----------------------------------------------------------- steps

    def _prefill_chunk(self, pool: str, ndev: int, t: float) -> float:
        cfg, model, m = self.cfg, self.model, self.m
        waiting, active = self._waiting, self._active
        r: Request = waiting[0][2]
        if self.oracle is not None:
            self.oracle.on_prefill(t, pool, r, waiting)
        chunk = min(cfg.prefill_chunk, r.prompt_len - r.prefilled)
        d = self.domains[pool]
        if self.executor is not None:
            # measured wall time: drive the license state machine for
            # residency accounting but never stretch a real duration
            dur = self.executor.prefill(r, chunk, pool, ndev) \
                * self.slow_factor
            end = d.observe(t, dur, d.cfg.max_level, dense=True)
        else:
            # heavy section: requests/refreshes the pool's license and
            # runs through the domain (only the grant-window throttle
            # can extend it — the roofline prefill time is already the
            # licensed speed)
            dur = model.prefill_ms(chunk, ndev) * self.slow_factor
            end = d.heavy_section(t, dur)
        r.prefilled += chunk
        self._charge(pool, "heavy", end - t)
        if r.prefilled >= r.prompt_len:
            heapq.heappop(waiting)
            r.ttft_ms = end - r.arrive_ms
            m.ttft_ms.append(r.ttft_ms)
            r.last_token_ms = end
            r.generated = 1          # prefill emits the first token
            homes = self.policy.placement(self.topo, WorkKind.LIGHT)
            # work conservation: decode where we prefilled whenever this
            # pool is a placement target at all; otherwise hand off
            target = pool if pool in homes else homes[0]
            overloaded = len(active.get(target, ())) >= cfg.decode_batch_max
            if target == pool or (
                    overloaded and self.policy.eligible(
                        self.topo, self.topo.pool(pool), WorkKind.LIGHT)):
                # asymmetric overload rule: decode locally on the
                # prefill pool rather than pile onto a saturated target
                active[pool].append(r)
            else:
                # KV handoff: the source pool drives the copy, so the
                # handoff time extends ITS busy window (one count, one
                # charge — per actual pool transfer). The copy is light
                # work through the pool's domain: right after a prefill
                # the license is still down, so it too runs slow (on the
                # modeled path only — with a live executor nothing is
                # stretched).
                hand_ms = model.handoff_ms * self.slow_factor
                if self.executor is not None:
                    hand_end = d.observe(end, hand_ms)
                else:
                    hand_end = d.light_section(end, hand_ms)
                self._charge(pool, "heavy", hand_end - end)
                self._transfer([r], pool, target, hand_end)
                end = hand_end
        return end

    def _decode_round(self, pool: str, ndev: int, t: float) -> float:
        cfg, model, m = self.cfg, self.model, self.m
        active = self._active
        batch = active[pool][:cfg.decode_batch_max]
        d = self.domains[pool]
        if self.executor is not None:
            # measured wall time: residency accounting only
            dur = self.executor.decode(batch, pool, ndev) \
                * self.slow_factor
            end = d.observe(t, dur)
        else:
            # light section: a decode round inside the hysteresis window
            # after a prefill runs at the reduced frequency — the
            # trailing slowdown the specialization removes, now emergent
            dur = model.decode_ms(len(batch), ndev) * self.slow_factor
            end = d.light_section(t, dur)
        if self.oracle is not None:
            self.oracle.on_decode(t, end, pool, batch)
        self._charge(pool, "light", end - t)
        still = []
        for r in batch:
            r.generated += 1
            if r.last_token_ms is not None:
                m.itl_ms.append(end - r.last_token_ms)
            r.last_token_ms = end
            if r.generated >= r.max_new:
                if self.completion_filter is not None and \
                        not self.completion_filter(end, r):
                    # drop fault: the response is lost at completion
                    # time — the request leaves the batch uncompleted
                    # and the cluster decides retry vs shed
                    if self.on_drop is not None:
                        self.on_drop(end, r)
                else:
                    r.done_ms = end
                    m.completed += 1
                    if self.on_complete is not None:
                        self.on_complete(end, r)
            else:
                still.append(r)
        active[pool] = still + active[pool][cfg.decode_batch_max:]
        return end


def pool_model_from_dryrun(results: dict, arch: str,
                           mesh: str = "single") -> PoolModel:
    """Derive per-chip service times from the dry-run roofline terms.

    step_s is the per-device roofline time on `chips` devices, so one
    chip-second per unit of work is step_s * chips; the engine divides by
    its own pool size. Missing or failed dry-run entries fall back to the
    default PoolModel."""
    pre = results.get(f"{arch}|prefill_32k|{mesh}")
    dec = results.get(f"{arch}|decode_32k|{mesh}")
    if not (pre and dec and pre["status"] == dec["status"] == "ok"):
        return PoolModel()
    rp, rd = pre["roofline"], dec["roofline"]
    chips = rp.get("chips", 256)
    shape_tokens = 32 * 32768
    prefill_chip_s_per_tok = rp["step_s"] * chips / shape_tokens
    decode_chip_s_per_iter = rd["step_s"] * rd.get("chips", 256)
    return PoolModel(
        prefill_ms_per_ktok=max(prefill_chip_s_per_tok * 1e6, 1e-3),
        decode_fixed_ms=max(decode_chip_s_per_iter * 1e3 * 0.2, 1e-3),
        decode_ms_per_seq=max(decode_chip_s_per_iter * 1e3 * 0.8 / 128.0,
                              1e-4),
    )
