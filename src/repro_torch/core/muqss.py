"""MuQSS-style scheduler with the paper's core-specialization extension.

Faithful to §3.1–3.2:

  * per-core deadline run queues, replicated 3x (scalar / AVX / untyped);
  * scalar cores pick only from {scalar, untyped};
  * AVX cores pick from all queues but deprioritize scalar tasks by a
    large deadline penalty (same trick MuQSS uses for idle-priority);
  * earliest-deadline work stealing across all cores does the load
    balancing (a core selecting its next task checks every other core's
    minimum deadline locklessly);
  * when a scalar task becomes an AVX task on a scalar core, it is put
    back on a run queue and a scalar task running on an AVX core is
    preempted via IPI so the AVX core picks the new AVX task;
  * untyped tasks run anywhere (system tasks pinned to AVX cores must not
    be starved — they do not get the scalar penalty).

The scheduler is pure mechanism: the core partition is a
:class:`repro_torch.sched.topology.Topology` (the ``avx``/``scalar`` pools)
and every allowed-queues / penalty / placement / preemption decision is
delegated to a :class:`repro_torch.sched.policy.Policy` — the same API the
serving engine (`sched/engine.py`) consumes. ``SchedConfig.n_avx_cores``
and ``specialization`` survive as conveniences that build the default
``Topology.cores(...)`` + ``SpecializedPolicy`` pair.

Virtual deadlines: MuQSS computes deadline = niffies + prio_ratio *
rr_interval; with equal priorities this is FIFO-ish within a quantum.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.runqueue import QUEUES, CoreRunQueues
from repro_torch.core.task import Task, TaskType
from repro_torch.sched.policy import (LIGHT_PENALTY, Policy, SharedBaselinePolicy,
                                SpecializedPolicy)
from repro_torch.sched.topology import Topology, WorkKind

# Added to scalar deadlines on AVX cores. No longer a magic 1e12: the
# value is derived from the frequency domain's worst-case slowdown
# (repro_torch.sched.policy.light_penalty) so the deprioritization traces to
# the same license physics both mechanisms share.
SCALAR_PENALTY = LIGHT_PENALTY

# TaskType <-> WorkKind: the scheduler speaks TaskType (the paper's
# annotation API), the policy speaks WorkKind (mechanism-agnostic).
KIND_OF: Dict[TaskType, WorkKind] = {
    TaskType.SCALAR: WorkKind.LIGHT,
    TaskType.AVX: WorkKind.HEAVY,
    TaskType.UNTYPED: WorkKind.ANY,
}
TASKTYPE_OF: Dict[WorkKind, TaskType] = {v: k for k, v in KIND_OF.items()}


@dataclass(frozen=True)
class SchedConfig:
    n_cores: int = 12
    n_avx_cores: int = 2               # paper: last two physical cores
    rr_interval_us: float = 6_000.0    # MuQSS default 6 ms
    specialization: bool = True        # off -> plain MuQSS (baseline)
    migration_cost_us: float = 0.15    # per cross-core migration (Fig. 7)
    sched_cost_us: float = 0.05        # per scheduler invocation
    ipi_cost_us: float = 0.15          # preemption IPI delivery

    def topology(self) -> Topology:
        """The default core layout this config describes."""
        return Topology.cores(
            self.n_cores, self.n_avx_cores if self.specialization else 0)

    def default_policy(self, topology: Topology) -> Policy:
        if len(topology.pools) > 1:
            return SpecializedPolicy()
        return SharedBaselinePolicy()


class Scheduler:
    def __init__(self, cfg: SchedConfig,
                 topology: Optional[Topology] = None,
                 policy: Optional[Policy] = None):
        self.cfg = cfg
        self.topo = topology if topology is not None else cfg.topology()
        self.policy = policy if policy is not None \
            else cfg.default_policy(self.topo)
        self.n_cores = self.topo.n_units
        self.rqs = [CoreRunQueues(i) for i in range(self.n_cores)]
        # Global steal index: one heap per queue type over every core's
        # alive queue entries, keyed (deadline, rq_id, seq). pick_next
        # reads the per-type minima in O(log n) instead of rescanning
        # all cores' queues per invocation; the entries are the
        # runqueues' own records (repro_torch.core.runqueue.DeadlineQueue),
        # so lazy deletion is shared — a local pop kills the index copy.
        self._steal_idx: List[list] = [[] for _ in QUEUES]
        # cores of dedicated heavy pools (empty when nothing is split)
        self.avx_cores: Set[int] = set()
        if len(self.topo.pools_with(WorkKind.HEAVY)) < len(self.topo.pools):
            for p in self.topo.pools_with(WorkKind.HEAVY):
                self.avx_cores.update(p.units)
        self.running: Dict[int, Optional[Task]] = {
            i: None for i in range(self.n_cores)}
        self.preempt_requests: Set[int] = set()
        # Preemption delivery. With no listener the scheduler keeps the
        # legacy polling contract: ``should_preempt(core)`` consumes a
        # one-shot flag (re-checked by the chunked simulator every 25 µs).
        # The event-horizon simulator registers ``preempt_listener`` and
        # is NOTIFIED the moment an IPI is raised, so it can invalidate
        # the target core's execution horizon instead of polling.
        self.preempt_listener: Optional[Callable[[int, float], None]] = None
        # Running-type probe. The event-horizon simulator commits type
        # changes optimistically inside execution spans, so a running
        # task's ``ttype`` attribute may already hold a *future* value.
        # The IPI-target scan below must see the type as of ``now``; the
        # simulator registers this hook to answer from its span logs.
        self.ttype_probe: Optional[Callable[[int, Task, float],
                                            TaskType]] = None
        self._avx_sorted: Tuple[int, ...] = tuple(sorted(self.avx_cores))
        # The topology is static for a Scheduler's lifetime, so the
        # per-core policy answers are snapshotted off the hot path
        # (pick_next/_kick run every few simulated microseconds).
        pools = [self.topo.pool_of_unit(c) for c in range(self.n_cores)]
        self._allowed = [tuple(TASKTYPE_OF[k] for k in
                               self.policy.queue_order(self.topo, p))
                         for p in pools]
        self._penalty = [{TASKTYPE_OF[k]: v for k, v in
                          self.policy.penalty(self.topo, p).items()}
                         for p in pools]
        # flattened (queue-index, penalty) scan plan per core, in the
        # core's allowed-queue order — the pick_next inner loop reads
        # this instead of hashing enum keys per queue per invocation
        self._scan = [tuple((tt.value, self._penalty[c].get(tt, 0.0))
                            for tt in self._allowed[c])
                      for c in range(self.n_cores)]
        self._can_run = [{tt: self.policy.eligible(self.topo, p,
                                                   KIND_OF[tt])
                          for tt in TaskType} for p in pools]
        # type-change decisions are pure in (pool, kind) — snapshot them
        # like the other policy answers (~55k type changes per simulated
        # second at the paper's operating point)
        self._tc_dec = [{tt: self.policy.on_type_change(
            self.topo, p, KIND_OF[tt]) for tt in TaskType} for p in pools]
        # tc_local[core][ttype]: the change neither migrates nor depends
        # on live queue state — pure bookkeeping. The event-horizon
        # simulator executes such changes inline within a span (only
        # when no dedicated heavy cores exist: the IPI-target scan reads
        # running tasks' ttype and must never see a future value).
        self.tc_local = [
            {tt: not (d.migrate or d.yield_if_heavy_waiting)
             for tt, d in per_core.items()} for per_core in self._tc_dec]
        self._placement = {
            tt: [u for n in self.policy.placement(self.topo, KIND_OF[tt])
                 for u in self.topo.pool(n).units] for tt in TaskType}
        self._pool_of_unit = pools
        # stats
        self.migrations = 0
        self.type_changes = 0
        self.steals = 0
        self.ipis = 0
        self.invocations = 0

    # ------------------------------------------------------------ helpers

    @property
    def specialized(self) -> bool:
        return bool(self.avx_cores)

    def is_avx_core(self, core: int) -> bool:
        return core in self.avx_cores

    def can_run(self, core: int, ttype: TaskType) -> bool:
        return self._can_run[core][ttype]

    def set_deadline(self, task: Task, now: float):
        task.deadline = now + self.cfg.rr_interval_us

    # ----------------------------------------------------------- enqueue

    def enqueue(self, task: Task, now: float, fresh_deadline: bool = True):
        if fresh_deadline:
            self.set_deadline(task, now)
        core = self._choose_core(task)
        e = self.rqs[core].push(task)
        heapq.heappush(self._steal_idx[task.ttype.value],
                       (e[0], core, e[1], e))
        return core

    def _choose_core(self, task: Task) -> int:
        """Queue on the allowed core with the fewest queued tasks,
        preferring the task's last core (cache affinity). Which cores are
        allowed is the policy's placement decision."""
        cands = self._placement[task.ttype]
        if task.last_core in cands and \
                self.rqs[task.last_core].n_queued == 0:
            return task.last_core
        rqs = self.rqs
        return min(cands, key=lambda c: rqs[c].n_queued)

    # --------------------------------------------------------- pick next

    def pick_next(self, core: int, now: float) -> Optional[Task]:
        """MuQSS selection: best deadline among own queues and every
        other core's queues (lockless steal — eligibility is global,
        placement is local). The global per-type steal index replaces
        the legacy flattened all-cores rescan: each allowed queue type
        costs one lazy heap peek. The legacy loop visited (rq_id,
        scan_pos) in lexicographic order with strict-<, so equal
        deadlines kept the lowest rq then the first allowed queue —
        exactly the (deadline+penalty, rq_id, scan_pos) lexicographic
        minimum the index keys reproduce."""
        self.invocations += 1
        idx = self._steal_idx
        best_d = best_rq = best_qv = None
        for qv, pen in self._scan[core]:
            h = idx[qv]
            while h and not h[0][3][3]:   # entry popped/removed locally
                heapq.heappop(h)
            if not h:
                continue
            dline, rq_id = h[0][0], h[0][1]
            d = dline + pen
            if best_d is None or d < best_d or \
                    (d == best_d and rq_id < best_rq):
                best_d, best_rq, best_qv = d, rq_id, qv
        if best_d is None:
            return None
        heapq.heappop(idx[best_qv])
        rq_id, qv = best_rq, best_qv
        task = self.rqs[rq_id].pop_by_val(qv)
        if task is None:
            return None
        if rq_id != core:
            self.steals += 1
        if task.last_core is not None and task.last_core != core:
            task.migrations += 1
            self.migrations += 1
        task.running_on = core
        self.running[core] = task
        return task

    # -------------------------------------------------------- type change

    def on_type_change(self, task: Task, new_type: TaskType, now: float
                       ) -> Tuple[bool, Optional[int]]:
        """Returns (must_requeue, preempt_core).

        must_requeue: the task must stop running on its current core
        (paper: an AVX task on a scalar core is suspended immediately).
        preempt_core: an AVX core currently running a scalar task that
        should receive an IPI so it can pick up the new AVX task.

        The decision comes from the policy; finding the IPI target and
        checking queue occupancy are mechanism.
        """
        task.type_changes += 1
        self.type_changes += 1
        task.ttype = new_type
        core = task.running_on
        dec = self._tc_dec[core][new_type] if core is not None \
            else self.policy.on_type_change(self.topo, None,
                                            KIND_OF[new_type])
        if dec.migrate:
            # current core must never run this kind: suspend + requeue,
            # and IPI a heavy core running stolen light work (if any —
            # an idle heavy core will naturally pick the task up).
            preempt = None
            if dec.preempt:
                probe = self.ttype_probe
                for c in self._avx_sorted:
                    r = self.running.get(c)
                    if r is not None:
                        tt = r.ttype if probe is None else probe(c, r, now)
                        if tt == TaskType.SCALAR:
                            preempt = c
                            break
                    else:
                        preempt = None
                        break
            if preempt is not None:
                self.ipis += 1
                self.request_preempt(preempt, now)
            return (True, preempt)
        if dec.yield_if_heavy_waiting:
            # asymmetric policy: keep running light work on the heavy
            # pool unless heavy work is queued for it
            avx_val = TaskType.AVX.value
            waiting = any(len(self.rqs[c].by_val[avx_val]) > 0
                          for c in self._avx_sorted)
            if waiting:
                return (True, None)
        return (False, None)

    def request_preempt(self, core: int, now: float):
        """Deliver a preemption IPI: push-notify the registered listener
        (event-horizon mode) or set the polled one-shot flag (legacy
        chunked mode, and direct scheduler use in tests)."""
        if self.preempt_listener is not None:
            self.preempt_listener(core, now)
        else:
            self.preempt_requests.add(core)

    def should_preempt(self, core: int) -> bool:
        if core in self.preempt_requests:
            self.preempt_requests.discard(core)
            return True
        return False

    def on_done(self, task: Task, core: int):
        self.running[core] = None
        task.running_on = None
        task.last_core = core

    def queued_total(self) -> int:
        return sum(rq.total() for rq in self.rqs)
