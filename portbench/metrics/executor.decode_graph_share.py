"""Share of the window's request-steps that replayed a captured CUDA
graph (``executor.step`` spans whose ``mode`` is ``replay``, over every
``executor.step``), %: the decode graph's hit share. Nothing where the
program records no such span."""
from portbench import spans


def read(run):
    steps = spans.named(run, "executor.step")
    if not steps:
        return None
    replays = sum(s.attrs.get("mode") == "replay" for s in steps)
    return 100.0 * replays / len(steps)
