"""Spans and counters of the port: one in-memory recorder for the process.

* ``span(name, **attrs)`` — a ``with`` block recorded as a span: its
  name, start and end on ``time.perf_counter_ns``, the span it opened
  inside (on the same thread) and its attributes (request ids, pool,
  layer, phase). A recorded span also opens a ``torch.profiler``
  ``record_function`` range of the same name, so a profile that records
  the host's activity shows it.
* ``count(name, n=1)`` — adds ``n`` to a counter. Counters are integer
  adds and count at every moment.
* ``take()`` — the spans and counters so far, which it clears.

Spans record while a ``torch.profiler`` session runs, and at no other
time: any device trace, the benchmark's or an operator's own, gets the
program's spans over the same window. That is the recorder's one switch.
``call(name, **attrs)`` is the span of a call into the program (an
executor call, a part of a train step, a collective, a backward): it
reads the profiler's state into a flag, which the spans opened inside it
test, and puts the flag back when it closes. So an idle span costs one
test, and a span opened outside every call records nothing.
``paused()`` clears that flag for a block.

On its first record after a ``take()`` the recorder reads the Unix clock
and ``perf_counter_ns`` together: ``Records.offset_ns``, their difference,
moves a span onto the clock the profiler stamps its events on.

The newest ``CAPACITY`` spans are kept; ``Records.dropped`` counts the
older ones let go.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

CAPACITY = 2_000_000

# a span's profiler range: the C++ form of ``record_function`` (the same
# user range in a profile, at a sixth of the host time a span)
_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int             # time.perf_counter_ns
    end_ns: int
    id: int
    parent: int | None        # the enclosing span on the same thread
    attrs: dict


@dataclass
class Records:
    spans: list
    counters: dict
    offset_ns: int | None     # Unix clock - perf_counter_ns; None: no span
    dropped: int              # spans let go for the capacity


class Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.spans = collections.deque(maxlen=capacity)
        self.counters: dict = {}
        self.dropped = 0
        self.offset_ns = None
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        """Ids of the spans open on this thread, innermost last."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, span: Span) -> None:
        if self.offset_ns is None:
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(span)

    def take(self) -> Records:
        out = Records(list(self.spans), self.counters, self.offset_ns,
                      self.dropped)
        self.spans.clear()
        self.counters = {}
        self.offset_ns, self.dropped = None, 0
        return out


RECORDER = Recorder()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "attrs", "id", "parent", "start", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = RECORDER.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(RECORDER.ids)
        stack.append(self.id)
        self.range = _RANGE(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        RECORDER.stack().pop()
        RECORDER.add(Span(self.name, self.start, end, self.id, self.parent,
                          self.attrs))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Call:
    """A call's span: records it, and the spans inside it, if a profiler
    session runs (on this thread) as it opens."""
    __slots__ = ("name", "attrs", "was", "open")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.was = RECORDER.on
        RECORDER.on = torch._C._autograd._profiler_enabled()
        self.open = _Open(self.name, self.attrs) if RECORDER.on else None
        if self.open is not None:
            self.open.__enter__()

    def __exit__(self, *exc):
        if self.open is not None:
            self.open.__exit__(*exc)
        RECORDER.on = self.was
        return False


def span(name: str, **attrs):
    """``with span("model.attn", layer=i, phase="decode"): ...``; records
    inside a recorded ``call``."""
    return _Open(name, attrs) if RECORDER.on else _OFF


def call(name: str, **attrs):
    """``with call("executor.decode", rids=..., pool=...): ...``"""
    return _Call(name, attrs)


class _Paused:
    """Inside it no span records (a CUDA graph's capture, which issues a
    step's work without running it); counters still count."""
    __slots__ = ("was",)

    def __enter__(self):
        self.was, RECORDER.on = RECORDER.on, False

    def __exit__(self, *exc):
        RECORDER.on = self.was
        return False


def paused():
    """``with paused(): ...``: no span records inside."""
    return _Paused()


def count(name: str, n: int = 1) -> None:
    c = RECORDER.counters
    c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    return RECORDER.counters.get(name, 0)


def reset(*names: str) -> None:
    """Sets the counters ``names`` to 0."""
    for name in names:
        RECORDER.counters.pop(name, None)


def take() -> Records:
    """The spans and counters recorded so far; clears them."""
    return RECORDER.take()


__all__ = ["CAPACITY", "RECORDER", "Records", "Recorder", "Span", "call",
           "count", "counter", "paused", "reset", "span", "take"]
