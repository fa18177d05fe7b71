"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity alone (no host op events, so a whole window of millions of
kernels stays cheap to record and to read) around the measured window,
read straight from the profiler's results.

It gives the device's busy seconds (the union of every kernel, copy and
set's interval), the kernels launched, each kernel name's count and
device seconds, and the idle time by what the host was doing: inside a
prefill call, inside a decode call, or between calls (the engine, the
next call's cache and prompt). Host spans are taken on
``time.perf_counter_ns``; the profiler stamps its events in Unix time
(its approximate clock converted), so the spans move onto that clock by
the difference between ``time.time_ns`` and ``perf_counter_ns`` read when
the trace starts. The executor synchronises the card at both ends of a
call, so every kernel of the window lies inside one: the share that does
is printed, and below 0.9 the idle is left unsplit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# device events that are no kernel launch
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    by_name: dict = field(default_factory=dict)    # name -> [count, s]
    idle_by_host: dict = field(default_factory=dict)  # phase -> s
    aligned: float = 0.0     # share of kernels inside an executor call

    def kernel(self, *functions: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose function is one
        of ``functions``: the name without its return type, template
        arguments and parameters."""
        n = s = 0
        for name, (c, sec) in self.by_name.items():
            if function(name) in functions:
                n, s = n + c, s + sec
        return n, s

    def top(self, k: int = 10) -> list:
        return sorted(([n[:160], v[1]] for n, v in self.by_name.items()),
                      key=lambda x: -x[1])[:k]


def function(name: str) -> str:
    """``void (anonymous namespace)::ns::f<T, 4>(float*)`` -> ``f``."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


class Tracer:
    """Start before the window opens, stop once it has closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.offset_ns = 0        # perf_counter_ns -> the profiler's clock

    def start(self) -> None:
        import torch
        if not self.enabled or not torch.cuda.is_available():
            return                      # the trace is of the card alone
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.stop()

    def summary(self, window_s: float, calls: list) -> Summary | None:
        """``calls``: (kind, start ns, end ns) of each executor call on
        ``time.perf_counter_ns``. None when nothing ran on the device."""
        if self.prof is None:
            return None
        ev = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                name = e.name()
                ev.append((e.start_ns(), e.end_ns(), name,
                           not name.startswith(NOT_KERNELS)))
        self.prof = None
        if not ev:
            return None
        ev.sort()
        out = Summary(window_s=window_s, busy_s=0.0,
                      kernels=sum(k for *_, k in ev))
        for a, b, name, _ in ev:
            c = out.by_name.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) * 1e-9
        busy = []                       # merged device intervals
        for a, b, _, _ in ev:
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        out.busy_s = sum(b - a for a, b in busy) * 1e-9
        _idle_by_host(out, busy, [(kind, a + self.offset_ns,
                                   b + self.offset_ns)
                                  for kind, a, b in calls])
        return out


def _idle_by_host(out: Summary, busy: list, calls: list) -> None:
    """``calls``: (kind, start ns, end ns) on the profiler's clock."""
    if not calls:
        return
    import bisect
    spans = [(a, b, kind) for kind, a, b in calls]
    starts = [s[0] for s in spans]
    inside = 0
    for a, b in busy:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= spans[i][1]:
            inside += 1
    out.aligned = inside / len(busy)
    if out.aligned < 0.9:
        return                          # the clocks did not match
    idle = {"inside prefill calls": 0.0, "inside decode calls": 0.0,
            "between calls (engine, next call's set-up)": 0.0}
    for (a0, b0), (a1, _) in zip(busy, busy[1:]):
        gap = (a1 - b0) * 1e-9
        i = bisect.bisect_right(starts, b0) - 1
        if i >= 0 and a1 <= spans[i][1]:
            idle[f"inside {spans[i][2]} calls"] += gap
        else:
            idle["between calls (engine, next call's set-up)"] += gap
    out.idle_by_host = idle
