"""Mean host time of one decoder layer's attention in a decode step (the
span ``model.attn`` with ``phase=decode``: norm, attention, residual, for
one model call), microseconds: the host's time to issue it."""
from portbench import spans


def read(run):
    return spans.mean_us(run, "model.attn", phase="decode")
