"""Discrete-event simulator: cores x license model x MuQSS scheduler.

Tasks are generators yielding Segment (code), TypeChange (the paper's
with_avx()/without_avx() syscalls) or RequestDone (workload bookkeeping).
The simulator charges scheduler invocation / migration / IPI costs from
SchedConfig, integrates per-core frequency through the license state
machine, and collects everything Figs. 5/6/7 need: throughput, per-core
frequency averages, migration counts, throttle cycles and flame-graph
attribution (§3.3).

Execution model — **event horizons** (default): for a task picked onto a
core the simulator computes the next *real* boundary and executes the
whole span through the core's ``FrequencyDomain`` in closed-form
``execute_until`` calls (analytic across license grant/revert
transitions). Consecutive segments with identical execution class are
merged into a single integration. A 10 ms AVX section is one heap event
instead of 400.

Span boundaries. A span ends only at events another core could observe
or that change this core's task: a genuine cross-core migration (the
type-change decision table says the new type must move pools), a
type-change whose yield-if-heavy-waiting policy sees heavy work queued,
end of the task's item stream, quantum expiry, or the slice cap below.
Everything else runs *through* the span analytically: same-core type
changes commit inline (logged with their simulated times so the
scheduler's ``ttype_probe`` can answer IPI-target scans as-of any
time), ``RequestDone`` items update metrics in place, and
yield-if-heavy-waiting changes are inlined speculatively while the
heavy pool is empty — any later heavy-pool push revalidates in-flight
spans (``_heavy_pushed``) and rolls back the ones whose speculation it
invalidates.

Preemption: IPIs are *pushed* to the simulator (the scheduler's
``preempt_listener`` hook) instead of being polled every chunk. Spans
are committed optimistically; when an IPI lands inside an in-flight
span, the span is rolled back (domain snapshot + metric/flame/type
deltas) and replayed analytically (``_replay``): one closed-form
``execute_until`` to the IPI time, then a run-out to the exact 25 µs
chunk boundary the chunked simulator would have used — no chunk loop.
Spans that are preemptable at all (a SCALAR task holding an AVX-pool
core, the only IPI target) are built in bounded ``_SLICE_US`` slices so
a rollback discards at most one slice of integration, not a whole 6 ms
quantum. Boundary ties: an IPI raised exactly at a span's start time is
treated as landing inside the span (the first chunk does not start
strictly after it), matching the chunked loop's flag visibility.

``strict_chunks=True`` keeps the original execution loop — every
segment stepped in <=25 µs ``chunk`` heap events with polled preemption
— as a debug oracle. The differential suite
(tests/test_event_horizon.py) replays every registered scenario through
both modes and asserts identical scheduling decisions and metrics.
Known strict-vs-horizon semantic difference: quantum expiry. Chunked
stepping overshoots the quantum to the next 25 µs chunk boundary and
requeues the task when that chunk *starts*; horizon mode ends the span
exactly at quantum expiry (and when an IPI rollback replays into a
quantum stop, at the replayed chunk's end — never at a heap position
already processed). Quanta (6 ms) are much longer than the
paper-workload segment runs, so the pinned figures are insensitive to
this.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.license import LEVEL_OF, LicenseConfig
from repro_torch.core.muqss import SchedConfig, Scheduler
from repro_torch.core.task import IClass, Segment, Task, TaskType, TypeChange
from repro_torch.sched.freq import FrequencyDomain
from repro_torch.sched.policy import Policy
from repro_torch.sched.topology import Topology

CHUNK_US = 25.0   # preemption (IPI) granularity

_INF = float("inf")


@dataclass(slots=True)
class RequestDone:
    """Yielded by workload generators when one request completes."""
    kind: str = "request"


@dataclass
class Metrics:
    completed: int = 0
    latencies_us: List[float] = field(default_factory=list)
    completions: List[Tuple[float, float, str]] = field(default_factory=list)
    #            (t_done_us, latency_us, task_name)
    flame_throttle: Dict[Tuple[str, ...], float] = field(default_factory=dict)
    flame_cycles: Dict[Tuple[str, ...], float] = field(default_factory=dict)
    busy_us: float = 0.0
    total_us: float = 0.0
    # cached sorted view of latencies_us — appends invalidate it (length
    # check) so every reported percentile shares ONE sort
    _lat_sorted: Optional[List[float]] = field(
        default=None, init=False, repr=False, compare=False)

    def throughput_per_s(self) -> float:
        return self.completed / (self.total_us / 1e6) if self.total_us else 0.0

    def p(self, q: float) -> float:
        xs = self.latencies_us
        if not xs:
            return 0.0
        cache = self._lat_sorted
        if cache is None or len(cache) != len(xs):
            cache = self._lat_sorted = sorted(xs)
        return cache[min(int(q * len(cache)), len(cache) - 1)]

    def latencies_by_task(self) -> Dict[str, List[float]]:
        """Per-task-name request latencies. Trace replays name tasks
        ``tenant:rid`` (core/workloads.trace_tasks), so grouping on the
        prefix gives per-tenant latency distributions."""
        out: Dict[str, List[float]] = {}
        for _t, lat, name in self.completions:
            out.setdefault(name, []).append(lat)
        return out


class _Span:
    """One in-flight event-horizon execution span (plan + undo log).

    The span is committed optimistically at plan time; everything here
    exists so a preemption IPI landing inside [t0, end) can roll the
    commit back and re-execute with legacy chunk granularity."""
    __slots__ = ("task", "t0", "end", "reason", "epoch", "lic_snap",
                 "task_snap", "met_snap", "busy_delta", "completed_delta",
                 "tc_delta", "flame_deltas", "req_old", "consumed",
                 "pushed_back", "flag", "tc_log", "spec")

    def __init__(self, task: Task, t0: float, epoch: int):
        self.task = task
        self.t0 = t0
        self.end = t0
        self.reason = "item"     # "item" | "quantum" | "preempt" | "slice"
        self.epoch = epoch
        # True once the log holds >= 1 speculative entry — the O(1)
        # guard _heavy_pushed checks before scanning the log
        self.spec = False
        self.lic_snap = None
        self.task_snap = (None, 0.0, task.ttype)
        self.met_snap = (0, 0)
        self.busy_delta = 0.0
        self.completed_delta = 0
        self.tc_delta = 0
        self.flame_deltas: Dict[Tuple[str, ...], List[float]] = {}
        self.req_old: Optional[Tuple[bool, float]] = None
        self.consumed: List[object] = []
        self.pushed_back = 0
        # preemption IPI raised for this span (None until one lands) —
        # doubles as the repeat-IPI coalescing guard (the flag is a set)
        self.flag: Optional[float] = None
        # type changes committed inline: (time, new_type, speculative).
        # Speculative entries are yield-if-heavy-waiting changes taken
        # while the heavy pool had nothing queued; a later heavy push
        # with an earlier timestamp invalidates them (_heavy_pushed).
        self.tc_log: List[Tuple[float, TaskType, bool]] = []


class Simulator:
    def __init__(self, sched_cfg: SchedConfig,
                 lic_cfg: LicenseConfig = LicenseConfig(),
                 ipc_locality_bonus: float = 0.0,
                 topology: Optional[Topology] = None,
                 policy: Optional[Policy] = None,
                 strict_chunks: bool = False):
        """ipc_locality_bonus: fractional IPC gain on cores with a reduced
        code footprint under specialization (paper §4.2 measured +0.7%).
        topology/policy: explicit repro_torch.sched layout + decisions; default
        derives both from sched_cfg (n_avx_cores / specialization).
        strict_chunks: debug mode — execute every segment in 25 µs chunk
        events with polled preemption (the pre-event-horizon loop)."""
        self.sched = Scheduler(sched_cfg, topology=topology, policy=policy)
        n_cores = self.sched.n_cores
        # one frequency domain per core — the same state machine the
        # serving engine attaches per pool (repro_torch.sched.freq)
        self.lic = [FrequencyDomain(lic_cfg.domain_config())
                    for _ in range(n_cores)]
        self.cfg = sched_cfg
        self.ipc_bonus = ipc_locality_bonus
        self.strict_chunks = strict_chunks
        self.metrics = Metrics()
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self.events_processed = 0
        self._idle: Set[int] = set(range(n_cores))
        # min-tracking idle structure: one heap per task type holding
        # only eligibility-compatible cores, validated lazily against
        # self._idle (replaces the sorted(self._idle) scan per kick)
        self._idle_heaps: Dict[TaskType, List[int]] = {
            tt: [c for c in range(n_cores) if self.sched.can_run(c, tt)]
            for tt in TaskType}
        for h in self._idle_heaps.values():
            heapq.heapify(h)
        self._quantum_end: Dict[int, float] = {}
        self._req_start: Dict[int, float] = {}
        # event-horizon state
        self._span: Dict[int, _Span] = {}
        self._span_epoch = itertools.count()
        # pending preemption flags, stamped with the IPI raise time (the
        # legacy flag was a bare set: consumption is "first chunk whose
        # start follows the raise", which needs the time once spans can
        # begin at or before a pending flag)
        self._pending_preempt: Dict[int, float] = {}
        if not strict_chunks:
            self.sched.preempt_listener = self._notify_preempt
            self.sched.ttype_probe = self._running_ttype_at
        # hot-path constants (identical FP values to the per-chunk
        # recomputation they replace)
        f0 = self.lic[0].cfg.freqs_ghz[0] if n_cores else 0.0
        self._chunk_cycles = CHUNK_US * f0 * 1000.0
        self._bonus_div = 1.0 + self.ipc_bonus
        self._bonus_on = bool(self.ipc_bonus and self.sched.specialized)
        # Span handling of a TypeChange to each new type, per core:
        #   1 = inline: pure bookkeeping (never migrates, no queue-state
        #       dependency) — committed inside the span; the scheduler's
        #       ttype probe keeps the IPI-target scan time-accurate.
        #   2 = speculative inline: yield-if-heavy-waiting — inlined
        #       only while the heavy pool has nothing queued; every
        #       heavy-pool push revalidates in-flight spans
        #       (_heavy_pushed) and rolls back wrong speculation.
        #   0 = boundary: a genuine cross-core migration ends the span.
        self._tc_mode = [
            {tt: (0 if d.migrate
                  else (2 if d.yield_if_heavy_waiting else 1))
             for tt, d in per.items()}
            for per in self.sched._tc_dec]
        self._avx_val = TaskType.AVX.value

    # ------------------------------------------------------------ events

    def _push(self, t: float, kind: str, payload):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def add_task(self, task: Task, at: float = 0.0):
        self._push(at, "arrive", task)

    # ------------------------------------------------------------- main

    def run(self, until_us: float):
        events = self._events
        while events and events[0][0] <= until_us:
            # peek-then-pop: an event beyond the horizon stays queued, so
            # resuming with a later until_us does not silently lose it
            t, _, kind, payload = heapq.heappop(events)
            if kind == "span":
                # preemption / invalidation re-pushes a span under a new
                # epoch and the old heap entry stays behind; a stale
                # tombstone is heap garbage, not a simulation event
                span = self._span.get(payload[0])
                if span is None or span.epoch != payload[1]:
                    continue
            self.events_processed += 1
            if kind == "arrive":
                self._on_arrive(t, payload)
            elif kind == "pick":
                self._on_pick(t, payload)
            elif kind == "span":
                self._on_span(t, *payload)
            elif kind == "exec":
                self._on_exec(t, *payload)
            elif kind == "chunk":
                self._on_chunk(t, *payload)
        self.metrics.total_us = until_us
        return self.metrics

    def _on_arrive(self, t: float, task: Task):
        task.created_t = t
        self._req_start[task.tid] = t
        self._enqueue(task, t, t)
        self._kick(t, task.ttype)

    def _kick(self, t: float, ttype: TaskType):
        """Wake the lowest-numbered idle core the policy allows to run
        this task type (lazy min-heap per type; stale entries — cores
        woken since they were pushed — are discarded on sight)."""
        heap = self._idle_heaps[ttype]
        idle = self._idle
        while heap:
            core = heap[0]
            if core not in idle:
                heapq.heappop(heap)
                continue
            idle.discard(core)
            self._push(t, "pick", core)
            return

    def _set_idle(self, core: int):
        if core in self._idle:
            return
        self._idle.add(core)
        for tt, heap in self._idle_heaps.items():
            if self.sched.can_run(core, tt):
                heapq.heappush(heap, core)

    def _on_pick(self, t: float, core: int):
        task = self.sched.pick_next(core, t)
        if task is None:
            self._set_idle(core)
            return
        cost = self.cfg.sched_cost_us
        if task.last_core is not None and task.last_core != core:
            cost += self.cfg.migration_cost_us
        self._quantum_end[core] = t + cost + self.cfg.rr_interval_us
        if self.strict_chunks:
            self._push(t + cost, "chunk", (core, task))
        else:
            # run the first scheduling step inline instead of a
            # zero-information heap event: the pick decision is already
            # made, so the span can open at t+cost directly. Items whose
            # handling reads cross-core state fall back to a real event
            # (_on_exec checks wall < t).
            self._on_exec(t + cost, core, task, wall=t)

    def _requeue(self, t: float, core: int, task: Task,
                 fresh_deadline: bool, wall: Optional[float] = None):
        self.sched.on_done(task, core)
        self._enqueue(task, t, t if wall is None else wall,
                      fresh_deadline=fresh_deadline)
        self._kick(t, task.ttype)
        self._push(t, "pick", core)

    def _enqueue(self, task: Task, t: float, wall: float,
                 fresh_deadline: bool = True):
        """All simulator enqueues funnel through here so heavy-pool
        pushes can revalidate speculative span commits. ``wall`` is the
        processing time at which the push becomes visible to other
        cores' live queue checks — for future-dated requeues (t + IPI
        cost) that is *earlier* than the queue timestamp ``t``."""
        core = self.sched.enqueue(task, t, fresh_deadline=fresh_deadline)
        if not self.strict_chunks and core in self.sched.avx_cores \
                and task.ttype is TaskType.AVX:
            self._heavy_pushed(wall)
        return core

    def _record_done(self, t: float, task: Task):
        m = self.metrics
        m.completed += 1
        t0 = self._req_start.get(task.tid, t)
        m.latencies_us.append(t - t0)
        m._lat_sorted = None
        m.completions.append((t, t - t0, task.name))
        self._req_start[task.tid] = t

    # ------------------------------------------- event-horizon execution

    def _on_exec(self, t: float, core: int, task: Task,
                 wall: Optional[float] = None):
        """Scheduling steps at time ``t``: process non-segment items in
        a loop (the legacy zero-width exec-event chains, without the
        heap round-trips) and open an execution span at the first
        Segment. When called ahead of wall time (``wall < t``, inlined
        from a pick), items whose handling reads live cross-core state —
        type changes and task end — fall back to a real heap event at
        ``t`` so they observe every earlier event's effects."""
        if wall is None:
            wall = t
        while True:
            item = task.next_segment()
            if item is None:
                if wall < t:
                    self._push(t, "exec", (core, task))
                    return
                task.done = True
                task.finished_t = t
                self.sched.on_done(task, core)
                self._push(t, "pick", core)
                return
            if isinstance(item, TypeChange):
                if wall < t:
                    self._push(t, "exec", (core, task))
                    return
                task.current_seg = None
                requeue, _preempt = self.sched.on_type_change(
                    task, item.new_type, t)
                if requeue:
                    self._requeue(t + self.cfg.ipi_cost_us, core, task,
                                  fresh_deadline=False, wall=t)
                    return
                continue
            if isinstance(item, RequestDone):
                task.current_seg = None
                self._record_done(t, task)
                continue
            self._start_span(t, core, task, wall=wall)
            return

    def _exec_chunk(self, core: int, task: Task, seg: Segment, t: float
                    ) -> float:
        """Execute exactly one legacy 25 µs chunk of ``seg`` (identical
        arithmetic to the strict-mode loop); returns the end time."""
        lic = self.lic[core]
        m = self.metrics
        remaining = seg.cycles - task.seg_done_cycles
        run = min(remaining, self._chunk_cycles)
        if self.ipc_bonus and self.sched.specialized \
                and seg.iclass == IClass.SCALAR:
            run_eff = run / self._bonus_div
        else:
            run_eff = run
        thr0 = lic.throttle_cycles
        t_end = lic.execute(t, run_eff, LEVEL_OF[seg.iclass], seg.dense)
        m.busy_us += t_end - t
        if seg.stack:
            dthr = lic.throttle_cycles - thr0
            fm = m.flame_throttle
            fm[seg.stack] = fm.get(seg.stack, 0.0) + dthr
            fc = m.flame_cycles
            fc[seg.stack] = fc.get(seg.stack, 0.0) + run
        task.seg_done_cycles += run
        if task.seg_done_cycles >= seg.cycles - 1e-6:
            task.current_seg = None
        return t_end

    def _start_span(self, t: float, core: int, task: Task,
                    wall: Optional[float] = None):
        """Plan AND optimistically commit a span: pull items until the
        next real boundary (genuine cross-core migration / task end /
        quantum expiry), merging consecutive same-class segments into
        single closed-form ``execute_until`` calls. Type changes that
        stay on this core run straight through (committed inline, see
        ``_tc_mode``). The undo log makes the commit revocable until the
        span event fires (preemption shortening, yield invalidation)."""
        if wall is None:
            wall = t
        pend = self._pending_preempt.pop(core, None)
        if pend is not None and pend < t:
            # a preemption IPI predates this span: the freshly scheduled
            # task runs exactly one chunk, then the still-pending IPI
            # takes effect (legacy polling consumed the flag at the
            # first chunk boundary whose start follows the raise)
            seg = task.next_segment()
            t_end = self._exec_chunk(core, task, seg, t)
            self._requeue(t_end + self.cfg.ipi_cost_us, core, task,
                          fresh_deadline=False, wall=wall)
            return
        lic = self.lic[core]
        m = self.metrics
        qend = self._quantum_end.get(core, _INF)
        # Preemptable spans build in bounded slices: a SCALAR task on an
        # AVX-pool core is the only IPI target (and the only speculation
        # that _heavy_pushed can invalidate), and measured IPI inter-
        # arrival there is ~100-200 µs — building the full 6 ms quantum
        # optimistically throws away ~30x that on every rollback. Slice
        # ends land on the 25 µs chunk grid so continuation spans keep
        # legacy-exact preemption boundaries. Unpreemptable spans (whole
        # scalar pool, AVX-typed work) still run boundary-to-boundary.
        avx_core = core in self.sched.avx_cores
        cap = t + self._SLICE_US \
            if avx_core and task.ttype is TaskType.SCALAR else _INF
        span = _Span(task, t, next(self._span_epoch))
        # Only AVX-pool cores can ever take a rollback (preempt IPIs
        # target them exclusively, and _heavy_pushed only revalidates
        # them) — scalar-pool spans skip the whole undo log.
        rev = avx_core
        if rev:
            span.lic_snap = lic.save_state()
            span.task_snap = (task.current_seg, task.seg_done_cycles,
                              task.ttype)
            span.met_snap = (len(m.latencies_us), len(m.completions))
        tc_mode = self._tc_mode[core]
        heavy_waiting: Optional[bool] = None
        tc_log = span.tc_log
        sched = self.sched
        consumed = span.consumed
        flame_deltas = span.flame_deltas
        bonus_on = self._bonus_on
        bonus_div = self._bonus_div
        fm = m.flame_throttle
        fc = m.flame_cycles
        gen = task.segments
        buf = task.pending
        execute_until = lic.execute_until
        # the first item honors the cached current segment (resume after
        # quantum expiry); all later pulls are raw and go to the rollback
        # log. `item`/`start_done` describe the next unprocessed item.
        item = task.current_seg
        if item is not None:
            start_done = task.seg_done_cycles
            task.current_seg = None
        else:
            item = buf.pop(0) if buf else next(gen, None)
            if rev and item is not None:
                consumed.append(item)
            start_done = 0.0
        now = t
        while True:
            cls = type(item)
            if cls is not Segment:
                if cls is RequestDone:
                    t0r = self._req_start.get(task.tid, now)
                    if rev and span.req_old is None:
                        span.req_old = (task.tid in self._req_start, t0r)
                    m.completed += 1
                    m.latencies_us.append(now - t0r)
                    m._lat_sorted = None
                    m.completions.append((now, now - t0r, task.name))
                    self._req_start[task.tid] = now
                    span.completed_delta += 1
                    item = buf.pop(0) if buf else next(gen, None)
                    if rev and item is not None:
                        consumed.append(item)
                    start_done = 0.0
                    continue
                if cls is TypeChange:
                    mode = tc_mode[item.new_type]
                    if mode == 2:
                        # yield-if-heavy-waiting: inline only while the
                        # heavy pool has nothing queued (state is frozen
                        # during the build; later pushes invalidate via
                        # _heavy_pushed). Non-empty now -> boundary; the
                        # finalize step re-checks live, so a drain
                        # before the change's time still resolves right.
                        if heavy_waiting is None:
                            avx_val = self._avx_val
                            heavy_waiting = any(
                                len(sched.rqs[c].by_val[avx_val]) > 0
                                for c in sched._avx_sorted)
                        if heavy_waiting:
                            mode = 0
                    if mode:
                        # stays on this core: commit inline and keep the
                        # span running — exactly what the legacy loop
                        # did across zero-width events
                        task.type_changes += 1
                        sched.type_changes += 1
                        task.ttype = item.new_type
                        if rev:
                            span.tc_delta += 1
                            tc_log.append((now, item.new_type, mode == 2))
                            if mode == 2:
                                span.spec = True
                        if cap == _INF and avx_core \
                                and item.new_type is TaskType.SCALAR:
                            # became an IPI target mid-span: bound the
                            # rest of the build like any scalar-on-avx
                            cap = now + self._SLICE_US
                        item = buf.pop(0) if buf else next(gen, None)
                        if rev and item is not None:
                            consumed.append(item)
                        start_done = 0.0
                        continue
                # migrating/heavy-waiting TypeChange or end-of-task:
                # span boundary. Cache the item so the finalize event
                # processes it like any scheduling step.
                task.current_seg = item
                task.seg_done_cycles = 0.0
                span.reason = "item"
                break
            # Segment: gather a maximal run of consecutive segments with
            # the same execution class, then integrate it in one call
            seg: Segment = item
            iclass = seg.iclass
            key_dense = seg.dense
            stack = seg.stack
            segs = [(seg, start_done)]
            run_nominal = seg.cycles - start_done
            while True:
                nxt = buf.pop(0) if buf else next(gen, None)
                if rev and nxt is not None:
                    consumed.append(nxt)
                if type(nxt) is Segment and nxt.iclass is iclass \
                        and nxt.dense == key_dense and nxt.stack == stack:
                    segs.append((nxt, 0.0))
                    run_nominal += nxt.cycles
                else:
                    break
            if bonus_on and iclass == IClass.SCALAR:
                run_eff = run_nominal / bonus_div
                nominal_scale = bonus_div
            else:
                run_eff = run_nominal
                nominal_scale = 1.0
            dl = qend if qend <= cap else cap
            thr0 = lic.throttle_cycles
            end, done_eff = execute_until(
                now, run_eff, LEVEL_OF[iclass], key_dense, deadline=dl)
            m.busy_us += end - now
            if rev:
                span.busy_delta += end - now
            partial = done_eff < run_eff - 1e-6
            nominal_done = run_nominal if not partial \
                else done_eff * nominal_scale
            if stack:
                dthr = lic.throttle_cycles - thr0
                fm[stack] = fm.get(stack, 0.0) + dthr
                fc[stack] = fc.get(stack, 0.0) + nominal_done
                if rev:
                    d = flame_deltas.get(stack)
                    if d is None:
                        flame_deltas[stack] = [dthr, nominal_done]
                    else:
                        d[0] += dthr
                        d[1] += nominal_done
            now = end
            if partial:
                # deadline hit inside the run: attribute the executed
                # cycles to the merged segments in order; the partial
                # segment becomes the task's current segment again, and
                # everything pulled-but-unexecuted (unstarted tail
                # segments, plus the non-matching item that ended the
                # gather) goes back onto the pushback buffer
                acc = nominal_done
                part = None
                tail: List[object] = []
                for s, sd in segs:
                    avail = s.cycles - sd
                    if part is None:
                        if acc >= avail - 1e-6:
                            acc -= avail
                        else:
                            part = (s, sd + acc)
                    else:
                        tail.append(s)
                if nxt is not None:
                    tail.append(nxt)
                if tail:
                    buf[:0] = tail
                    if rev:
                        span.pushed_back = len(tail)
                if qend <= cap or part is None:
                    if part is not None:
                        task.current_seg, task.seg_done_cycles = part
                    span.reason = "quantum" if qend <= cap else "slice"
                    break
                # slice cap hit mid-chunk: run the in-flight legacy
                # chunk out to its 25 µs grid point so the continuation
                # span stays on the lattice preemption replay anchors to
                s, pos = part
                cc = self._chunk_cycles
                k = int((pos + self._SNAP_C) // cc)
                tgt = min((k + 1) * cc, s.cycles)
                extra_eff = (tgt - pos) / nominal_scale
                thr0 = lic.throttle_cycles
                end2, de2 = execute_until(
                    now, extra_eff, LEVEL_OF[iclass], key_dense,
                    deadline=qend)
                m.busy_us += end2 - now
                if rev:
                    span.busy_delta += end2 - now
                d2 = de2 * nominal_scale
                if stack:
                    dthr = lic.throttle_cycles - thr0
                    fm[stack] = fm.get(stack, 0.0) + dthr
                    fc[stack] = fc.get(stack, 0.0) + d2
                    if rev:
                        d = flame_deltas.get(stack)
                        if d is None:
                            flame_deltas[stack] = [dthr, d2]
                        else:
                            d[0] += dthr
                            d[1] += d2
                now = end2
                if de2 < extra_eff - 1e-6:
                    # quantum expired inside the run-out chunk
                    task.current_seg = s
                    task.seg_done_cycles = pos + d2
                    span.reason = "quantum"
                    break
                # chunk completed: the position is the exact grid point
                task.seg_done_cycles = tgt
                task.current_seg = None if tgt >= s.cycles - 1e-6 else s
                span.reason = "quantum" if now >= qend else "slice"
                break
            if now >= qend:
                # full run done exactly at/after expiry: the gather's
                # non-matching item is the task's next item
                task.current_seg = nxt
                task.seg_done_cycles = 0.0
                span.reason = "quantum"
                break
            if now >= cap:
                # slice budget exhausted exactly at a gather boundary
                task.current_seg = nxt
                task.seg_done_cycles = 0.0
                span.reason = "slice"
                break
            item = nxt
            start_done = 0.0
        span.end = now
        self._span[core] = span
        self._push(now, "span", (core, span.epoch))
        if pend is not None:
            # flag raised exactly at the span start (pend == t): the
            # first chunk does not start *after* it, so the span runs
            # and the IPI lands inside it like any mid-span raise
            self._notify_preempt(core, pend)

    def _on_span(self, t: float, core: int, epoch: int):
        """Finalize a committed span: the boundary action happens here,
        at the span's event time, so requeue visibility to other cores
        matches the legacy event order."""
        span = self._span.get(core)
        if span is None or span.epoch != epoch:
            return    # superseded by a preemption shortening
        del self._span[core]
        task = span.task
        if span.reason == "quantum":
            self._requeue(span.end, core, task, fresh_deadline=True,
                          wall=t)
            return
        if span.reason == "preempt":
            self._requeue(span.end + self.cfg.ipi_cost_us, core, task,
                          fresh_deadline=False, wall=t)
            return
        if span.reason == "slice":
            # preemptable span reached its slice cap with no IPI: keep
            # running from the exact grid position in a fresh span
            self._start_span(t, core, task, wall=t)
            return
        self._on_exec(t, core, task)    # boundary item is cached

    # ------------------------------------------------------- preemption

    def _notify_preempt(self, core: int, t: float):
        """Scheduler push-notification: an IPI was raised for ``core`` at
        time ``t``. If a span is in flight, roll its optimistic commit
        back and re-run it analytically so the IPI takes effect at the
        exact 25 µs boundary polling would have used; otherwise leave
        the IPI pending for the core's next span."""
        span = self._span.get(core)
        if span is None:
            self._pending_preempt[core] = t
            return
        if span.flag is not None or core in self._pending_preempt:
            return    # legacy flag was a set: repeat IPIs coalesce
        span.flag = t
        budget = len(self._rollback(core, span))
        ev_t, end, reason = self._replay(core, span, t, budget)
        span.epoch = next(self._span_epoch)
        span.end = end
        span.reason = reason
        self._push(ev_t, "span", (core, span.epoch))

    def _rollback(self, core: int, span: _Span) -> List[Tuple]:
        """Undo a span's optimistic commit and re-arm its undo log so
        the replay's own re-commit stays revocable (an IPI-shortened
        span can later be invalidated by a heavy push, and vice versa).
        Returns the rolled-back inline type-change log."""
        task = span.task
        m = self.metrics
        self.lic[core].restore_state(span.lic_snap)
        m.busy_us -= span.busy_delta
        if span.completed_delta:
            n_lat, n_comp = span.met_snap
            d = span.completed_delta
            del m.latencies_us[n_lat:n_lat + d]
            del m.completions[n_comp:n_comp + d]
            m.completed -= d
            m._lat_sorted = None
            has_old, old = span.req_old
            if has_old:
                self._req_start[task.tid] = old
            else:
                self._req_start.pop(task.tid, None)
            # other in-flight spans' metric snapshots point past the
            # deleted block: shift them, or their own rollback would
            # cut someone else's completions
            for other in self._span.values():
                if other is not span and other.met_snap[0] > n_lat:
                    other.met_snap = (other.met_snap[0] - d,
                                      other.met_snap[1] - d)
        for stack, (dthr, dcyc) in span.flame_deltas.items():
            m.flame_throttle[stack] -= dthr
            m.flame_cycles[stack] -= dcyc
        cs0, sd0, tt0 = span.task_snap
        task.current_seg = cs0
        task.seg_done_cycles = sd0
        if span.tc_delta:
            task.ttype = tt0
            task.type_changes -= span.tc_delta
            self.sched.type_changes -= span.tc_delta
        if span.pushed_back:
            # a quantum-partial commit already returned pulled items to
            # the buffer; drop them before replaying from the consumed
            # log or they would be duplicated
            del task.pending[:span.pushed_back]
        task.pending = span.consumed + task.pending
        # fresh undo log for the replay's re-commit
        span.busy_delta = 0.0
        span.completed_delta = 0
        span.tc_delta = 0
        span.flame_deltas = {}
        span.req_old = None
        span.consumed = []
        span.pushed_back = 0
        span.met_snap = (len(m.latencies_us), len(m.completions))
        old_log = span.tc_log
        span.tc_log = []
        span.spec = False
        return old_log

    def _heavy_pushed(self, t_push: float):
        """A heavy task became queued on the heavy pool, visible from
        wall time ``t_push``: every speculative yield-skip committed
        inside an in-flight span at a later simulated time is wrong —
        the legacy loop would have seen heavy work waiting and requeued
        there. Roll such spans back and replay with the inline budget
        capped at the first invalidated change, which then ends the span
        and is re-decided live at its finalize step."""
        for core in self.sched._avx_sorted:
            span = self._span.get(core)
            if span is None or not span.spec:
                continue
            budget = None
            for i, (tc_t, _tt, spec) in enumerate(span.tc_log):
                if spec and tc_t > t_push:
                    budget = i
                    break
            if budget is None:
                continue
            self._rollback(core, span)
            flag = span.flag if span.flag is not None else _INF
            ev_t, end, reason = self._replay(core, span, flag, budget)
            span.epoch = next(self._span_epoch)
            span.end = end
            span.reason = reason
            self._push(ev_t, "span", (core, span.epoch))

    def _running_ttype_at(self, core: int, task: Task,
                          now: float) -> TaskType:
        """Scheduler probe: the task type ``task`` presents at ``now``.
        Inside an optimistically committed span, ``task.ttype`` already
        holds the value after every inlined change; walking the span's
        log gives concurrent IPI-target scans the as-of-now type."""
        span = self._span.get(core)
        if span is None or span.task is not task or not span.tc_log:
            return task.ttype
        tt = span.task_snap[2]
        for tc_t, new_tt, _spec in span.tc_log:
            if tc_t <= now:
                tt = new_tt
            else:
                break
        return tt

    # IPI-replay float guards: times match the chunked loop only up to
    # FP dust (closed-form integration sums differently), so grid and
    # flag comparisons snap within these bands. Real offsets are >= the
    # 1/f0 cycle time (~3.6e-4 us / ~1 cycle) — orders above the dust.
    _EPS_T = 1e-9        # us: "chunk starts after the flag" slack
    _SNAP_C = 1e-3       # cycles: "position is on the chunk grid" slack
    # us: build horizon for preemptable (scalar-on-avx-core) spans —
    # a few measured IPI inter-arrival times, so most slices either
    # retire whole or lose at most one slice of work to a rollback
    # (swept 100-600 us on webserver/avx512/specialized; flat within
    # noise, 400 the shallow optimum for both wall time and events)
    _SLICE_US = 400.0

    def _replay(self, core: int, span: _Span, t_flag: float,
                budget: int) -> Tuple[float, float, str]:
        """Closed-form replay of a rolled-back span from its start. The
        IPI (raised at ``t_flag``; ``_INF`` when the replay is for a
        speculation invalidation and no IPI is in play) is consumed at
        the end of the first 25 µs chunk that *starts* after it —
        exactly when the polled flag became visible to the chunked loop
        — but instead of stepping every chunk, each segment is
        integrated straight to ``execute_until(deadline=t_flag)`` and
        only the one or two grid chunks around the flag run
        individually (their boundaries are fixed points of the
        nominal-cycle grid, so the consuming chunk is computed, not
        discovered). Inline type changes re-apply only while their
        index is below ``budget``; the first at or past it ends the
        span and is re-decided live at the finalize step. The replay
        re-commits through the span's re-armed undo log, so it stays
        revocable (an IPI can land after an invalidation and vice
        versa). Returns ``(event_time, end_time, reason)``: the time
        the finalize event must fire (the legacy pop time, where
        requeues became visible) and the time execution stopped."""
        task = span.task
        qend = self._quantum_end.get(core, _INF)
        lic = self.lic[core]
        m = self.metrics
        cc = self._chunk_cycles
        bonus_on = bool(self.ipc_bonus and self.sched.specialized)
        bonus_div = self._bonus_div
        tc_mode = self._tc_mode[core]
        tc_log = span.tc_log
        consumed = span.consumed
        flame_deltas = span.flame_deltas
        gen = task.segments
        buf = task.pending
        n_tc = 0
        now = span.t0
        while True:
            item = task.current_seg
            if item is None:
                # fresh pull: log it so a second rollback can restore
                item = buf.pop(0) if buf else next(gen, None)
                if item is not None:
                    consumed.append(item)
                    task.current_seg = item
                    task.seg_done_cycles = 0.0
            cls = type(item)
            if cls is not Segment:
                if cls is RequestDone:
                    t0r = self._req_start.get(task.tid, now)
                    if span.req_old is None:
                        span.req_old = (task.tid in self._req_start, t0r)
                    m.completed += 1
                    m.latencies_us.append(now - t0r)
                    m._lat_sorted = None
                    m.completions.append((now, now - t0r, task.name))
                    self._req_start[task.tid] = now
                    span.completed_delta += 1
                    task.current_seg = None
                    continue
                if cls is TypeChange and n_tc < budget:
                    # within the replay budget: this change was (and
                    # stays) committed inline — the original build's
                    # decision is grandfathered up to the first
                    # invalidated entry, no live re-decision here
                    task.current_seg = None
                    task.type_changes += 1
                    self.sched.type_changes += 1
                    task.ttype = item.new_type
                    span.tc_delta += 1
                    spec = tc_mode[item.new_type] == 2
                    tc_log.append((now, item.new_type, spec))
                    if spec:
                        span.spec = True
                    n_tc += 1
                    continue
                # end-of-task, or a type change at/past the budget:
                # span boundary without consuming the IPI — it stays
                # pending for this core (legacy flag semantics)
                if t_flag != _INF:
                    self._pending_preempt[core] = t_flag
                return (now, now, "item")
            seg: Segment = item
            base = task.seg_done_cycles
            rem = seg.cycles - base
            scaled = bonus_on and seg.iclass == IClass.SCALAR
            lvl = LEVEL_OF[seg.iclass]
            stack = seg.stack

            def run(n_nom: float, deadline: Optional[float] = None,
                    _now=None) -> Tuple[float, float]:
                """Integrate ``n_nom`` nominal cycles of ``seg`` from
                the current position with chunk-identical accounting;
                returns (end_time, nominal_cycles_done)."""
                t_in = now if _now is None else _now
                n_eff = n_nom / bonus_div if scaled else n_nom
                thr0 = lic.throttle_cycles
                end, done_eff = lic.execute_until(
                    t_in, n_eff, lvl, seg.dense, deadline=deadline)
                m.busy_us += end - t_in
                span.busy_delta += end - t_in
                done_nom = done_eff * bonus_div if scaled else done_eff
                if stack:
                    dthr = lic.throttle_cycles - thr0
                    fm = m.flame_throttle
                    fm[stack] = fm.get(stack, 0.0) + dthr
                    fc = m.flame_cycles
                    fc[stack] = fc.get(stack, 0.0) + done_nom
                    d = flame_deltas.get(stack)
                    if d is None:
                        flame_deltas[stack] = [dthr, done_nom]
                    else:
                        d[0] += dthr
                        d[1] += done_nom
                return end, done_nom

            if now > t_flag + self._EPS_T:
                # the flag predates this segment: its first chunk is
                # the consuming one (start > t_flag beats every other
                # check in the legacy loop)
                b = min(cc, rem)
                start = now
                now, _ = run(b)
                task.seg_done_cycles = base + b
                if b >= rem - 1e-6:
                    task.current_seg = None
                return (start, now, "preempt")
            # bulk phase: integrate to the earlier of flag and quantum
            # expiry (both only take effect at chunk-grid boundaries,
            # resolved below)
            dl = t_flag if t_flag <= qend else qend
            end1, prog = run(rem, deadline=dl)
            now = end1
            if prog >= rem - 1e-6:
                # segment completed with every chunk start <= t_flag
                task.seg_done_cycles = seg.cycles
                task.current_seg = None
                if now >= qend:
                    # its last chunk ended exactly at quantum expiry
                    if t_flag != _INF:
                        self._pending_preempt[core] = t_flag
                    return (now, now, "quantum")
                continue
            # capped at ``dl`` mid-run: locate the in-flight chunk on
            # the nominal grid (chunk k covers [k*cc, (k+1)*cc) past
            # ``base``; a position within SNAP of the grid means the
            # previous chunk ended exactly at ``dl``)
            kfit = int((prog + self._SNAP_C) // cc)
            on_grid = abs(prog - kfit * cc) <= self._SNAP_C
            if on_grid and prog > 0.0 and now >= qend:
                # previous chunk ended exactly at quantum expiry and
                # its start was <= t_flag: quantum wins, nothing more
                # runs (the IPI stays pending)
                if t_flag != _INF:
                    self._pending_preempt[core] = t_flag
                return (now, now, "quantum")
            # finish the chunk in flight (or, on-grid, the full chunk
            # starting exactly at the flag — "starts after" is strict)
            b1 = min((kfit + 1) * cc, rem)
            end2, _ = run(b1 - prog)
            task.seg_done_cycles = base + b1
            if b1 >= rem - 1e-6:
                task.current_seg = None
            if end2 >= qend:
                # that chunk crossed quantum expiry before any chunk
                # started after the flag
                if t_flag != _INF:
                    self._pending_preempt[core] = t_flag
                return (end2, end2, "quantum")
            now = end2
            if task.current_seg is None:
                continue    # consuming chunk belongs to the next item
            # the next chunk starts strictly after the flag: consume
            b2 = min(b1 + cc, rem)
            end3, _ = run(b2 - b1)
            task.seg_done_cycles = base + b2
            if b2 >= rem - 1e-6:
                task.current_seg = None
            return (end2, end3, "preempt")

    # --------------------------------------- strict chunked mode (debug)

    def _on_chunk(self, t: float, core: int, task: Task):
        item = task.next_segment()
        if item is None:
            task.done = True
            task.finished_t = t
            self.sched.on_done(task, core)
            self._push(t, "pick", core)
            return
        if isinstance(item, TypeChange):
            task.current_seg = None
            requeue, _preempt = self.sched.on_type_change(
                task, item.new_type, t)
            if requeue:
                self._requeue(t + self.cfg.ipi_cost_us, core, task,
                              fresh_deadline=False)
            else:
                self._push(t, "chunk", (core, task))
            return
        if isinstance(item, RequestDone):
            task.current_seg = None
            self._record_done(t, task)
            self._push(t, "chunk", (core, task))
            return
        seg: Segment = item
        t_end = self._exec_chunk(core, task, seg, t)
        # preemption / quantum checks at chunk boundary
        if self.sched.should_preempt(core):
            self._requeue(t_end + self.cfg.ipi_cost_us, core, task,
                          fresh_deadline=False)
            return
        if t_end >= self._quantum_end.get(core, _INF):
            self._requeue(t_end, core, task, fresh_deadline=True)
            return
        self._push(t_end, "chunk", (core, task))

    # ------------------------------------------------------------- stats

    def avg_frequency_ghz(self) -> float:
        """Time-weighted average frequency over busy time (Fig. 6)."""
        wsum, tsum = 0.0, 0.0
        for lic in self.lic:
            avg, tt = lic.freq_time_integral()
            wsum += avg * tt
            tsum += tt
        return wsum / tsum if tsum else self.lic[0].cfg.freqs_ghz[0]

    def counters(self) -> Dict[str, float]:
        """CORE_POWER.* counter totals (§3.3)."""
        return {
            "LVL0_TURBO_LICENSE": sum(l.cycles_at_level[0] for l in self.lic),
            "LVL1_TURBO_LICENSE": sum(l.cycles_at_level[1] for l in self.lic),
            "LVL2_TURBO_LICENSE": sum(l.cycles_at_level[2] for l in self.lic),
            "THROTTLE": sum(l.throttle_cycles for l in self.lic),
            "transitions": sum(l.transitions for l in self.lic),
            "migrations": self.sched.migrations,
            "type_changes": self.sched.type_changes,
            "steals": self.sched.steals,
            "ipis": self.sched.ipis,
        }

    def license_snapshot(self) -> Dict[str, float]:
        """Aggregated frequency-domain accounting across all cores —
        the same columns the serving engine reports per pool."""
        busy = sum(l.busy_time for l in self.lic)
        reduced = sum(l.reduced_time() for l in self.lic)
        return {
            "busy_us": busy,
            "reduced_us": reduced,
            "license_residency": reduced / busy if busy else 0.0,
            "throttled_us": sum(l.throttled_time for l in self.lic),
            "transitions": sum(l.transitions for l in self.lic),
            "energy_proxy": sum(l.energy for l in self.lic),
        }
