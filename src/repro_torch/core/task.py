"""Task model + the paper's annotation API.

Tasks are SCALAR, AVX, or UNTYPED (never declared — e.g. system tasks
pinned to AVX cores; they must not be starved, see §3.2). ``with_avx`` /
``without_avx`` are the paper's Figure-4 calls: they flip the task type
and let the scheduler migrate the thread to a suitable core.
"""
from __future__ import annotations

import enum
import itertools
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Tuple


class TaskType(enum.Enum):
    SCALAR = 0
    AVX = 1
    UNTYPED = 2


class IClass(enum.Enum):
    """Instruction class of a code segment (drives the power license)."""
    SCALAR = 0      # license L0
    AVX2 = 1        # heavy AVX2 -> L1
    AVX512 = 2      # heavy AVX-512 -> L2


@dataclass(slots=True)
class Segment:
    """A stretch of straight-line code: cycles at nominal frequency.

    ``dense`` — whether the instruction mix is dense enough to trigger a
    license request (paper §2: ~1 heavy op/cycle sustained; §3.3: short or
    stall-ridden sections do not change frequency).
    ``stack`` — call-stack label for flame-graph attribution (§3.3).

    ``__slots__``: segments are the innermost simulator object (one per
    scheduled span, millions per run) — attribute storage matters.
    """
    cycles: float
    iclass: IClass = IClass.SCALAR
    dense: bool = True
    stack: Tuple[str, ...] = ()


_task_ids = itertools.count()


@dataclass(slots=True)
class Task:
    """A schedulable entity (thread in the paper; request in the serving
    adaptation). ``segments`` yields Segments; None terminates.

    ``pending`` is a pushback buffer consumed before the generator: the
    event-horizon simulator pulls items ahead of execution to plan a
    span, and returns the unexecuted tail here when a preemption IPI
    shortens the span (generators cannot rewind)."""
    segments: Iterator[Optional[Segment]]
    ttype: TaskType = TaskType.UNTYPED
    name: str = ""
    tid: int = field(default_factory=lambda: next(_task_ids))
    # scheduler state
    deadline: float = 0.0
    last_core: Optional[int] = None
    running_on: Optional[int] = None
    current_seg: Optional[Segment] = None
    seg_done_cycles: float = 0.0
    pending: list = field(default_factory=list)
    done: bool = False
    # stats
    created_t: float = 0.0
    finished_t: float = 0.0
    migrations: int = 0
    type_changes: int = 0

    def next_segment(self) -> Optional[Segment]:
        if self.current_seg is not None:
            return self.current_seg
        if self.pending:
            seg = self.pending.pop(0)
        else:
            try:
                seg = next(self.segments)
            except StopIteration:
                seg = None
        self.current_seg = seg
        self.seg_done_cycles = 0.0
        return seg


class AnnotationAPI:
    """The paper's syscall pair, exposed to workload code.

    Inside a task's segment generator, yield ``TypeChange(...)`` markers —
    the simulator translates them into scheduler calls, exactly like the
    prototype's ``with_avx()`` / ``without_avx()`` system calls.
    """


@dataclass(slots=True)
class TypeChange:
    """Marker yielded by a task generator instead of a Segment."""
    new_type: TaskType


def with_avx() -> TypeChange:
    return TypeChange(TaskType.AVX)


def without_avx() -> TypeChange:
    return TypeChange(TaskType.SCALAR)


@contextmanager
def heavy_region(emit: Callable[[TypeChange], None]):
    """Context-manager flavour of the annotation API (used by the serving
    engine where code runs for real rather than in the simulator)."""
    emit(with_avx())
    try:
        yield
    finally:
        emit(without_avx())
