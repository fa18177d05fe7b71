"""The program's own spans in a traced run, for the readers that read them.

The port records spans (``repro_torch.obs``) while a ``torch.profiler``
session runs, which in a ``--trace 1`` run is the measured window. The
first reader takes the window's records from the recorder, once a run,
and keeps them on the run for the others. Every function gives None where
there is nothing to read: an untraced run, or a program without the
recorder.
"""
from __future__ import annotations


def records(run):
    """The recorder's ``Records`` of the run's window, or None."""
    if "program_spans" not in vars(run):
        run.program_spans = _take()
    return run.program_spans


def _take():
    try:
        from repro_torch import obs
    except ImportError:             # a program that records no spans
        return None
    rec = obs.take()
    return rec if rec.spans else None


def named(run, name: str, **attrs) -> list | None:
    """The spans called ``name`` whose attributes include ``attrs``."""
    rec = records(run)
    if rec is None:
        return None
    return [s for s in rec.spans if s.name == name
            and all(s.attrs.get(k) == v for k, v in attrs.items())]


def total_ns(spans) -> int:
    return sum(s.end_ns - s.start_ns for s in spans)


def mean_us(run, name: str, **attrs) -> float | None:
    """Mean duration of the matching spans, microseconds."""
    got = named(run, name, **attrs)
    return total_ns(got) / len(got) / 1e3 if got else None
