"""Deadline-sorted run queues with MuQSS semantics.

MuQSS keeps one skip-list run queue per physical core, sorted by virtual
deadline, and replicates it three ways in the paper's extension (scalar /
AVX / untyped). A binary heap gives the same ordering semantics; lazy
deletion stands in for the lockless removal.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.task import Task, TaskType

QUEUES = (TaskType.SCALAR, TaskType.AVX, TaskType.UNTYPED)


class DeadlineQueue:
    """Min-heap by (deadline, seq) with lazy removal.

    Entries are shared mutable records ``[deadline, seq, task, alive]``.
    ``push`` returns the record so callers (the scheduler's global steal
    index) can insert the *same* object into other heaps: a pop or
    removal here flips ``alive`` and every other heap discards the entry
    lazily on sight. The previous tid-keyed tombstone set only worked
    inside one queue — a task popped here and re-queued elsewhere would
    have matched its stale tid in a global index and been dropped twice.
    """

    __slots__ = ("_h", "_seq", "_by_tid", "_n")

    def __init__(self):
        self._h: List[list] = []
        self._seq = itertools.count()
        self._by_tid: Dict[int, list] = {}
        self._n = 0

    def push(self, task: Task) -> list:
        e = [task.deadline, next(self._seq), task, True]
        heapq.heappush(self._h, e)
        self._by_tid[task.tid] = e
        self._n += 1
        return e

    def remove(self, task: Task):
        e = self._by_tid.pop(task.tid, None)
        if e is not None:
            e[3] = False
            self._n -= 1

    def _settle(self):
        h = self._h
        while h and not h[0][3]:
            heapq.heappop(h)

    def peek(self) -> Optional[Task]:
        self._settle()
        return self._h[0][2] if self._h else None

    def pop(self) -> Optional[Task]:
        self._settle()
        if not self._h:
            return None
        e = heapq.heappop(self._h)
        e[3] = False
        del self._by_tid[e[2].tid]
        self._n -= 1
        return e[2]

    def __len__(self):
        return max(self._n, 0)


@dataclass
class CoreRunQueues:
    """The paper's 3-way replicated per-core run queue (§3.2).

    ``n_queued`` is maintained incrementally: emptiness is checked on
    every scheduler invocation for every core (the lockless cross-core
    steal scan), so it must be O(1)."""
    core_id: int
    queues: Dict[TaskType, DeadlineQueue] = field(
        default_factory=lambda: {q: DeadlineQueue() for q in QUEUES})
    n_queued: int = 0
    # queues indexed by TaskType.value — the steal scan touches every
    # core's queues on every scheduler invocation and enum hashing is
    # measurable there
    by_val: List[DeadlineQueue] = field(default_factory=list)

    def __post_init__(self):
        self.by_val = [None] * len(QUEUES)
        for q in QUEUES:
            self.by_val[q.value] = self.queues[q]

    def push(self, task: Task) -> list:
        e = self.queues[task.ttype].push(task)
        self.n_queued += 1
        return e

    def remove(self, task: Task):
        self.queues[task.ttype].remove(task)
        self.n_queued -= 1

    def pop_by_val(self, qv: int) -> Optional[Task]:
        """Pop the earliest-deadline task of queue index ``qv``
        (TaskType.value). The only pop path — owns the n_queued
        decrement so the O(1) emptiness count cannot drift."""
        task = self.by_val[qv].pop()
        if task is not None:
            self.n_queued -= 1
        return task

    def total(self) -> int:
        return self.n_queued
