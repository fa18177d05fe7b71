"""Mean host time of one application of the hybrid's shared block in a
prefill (the span ``model.shared`` with ``phase=prefill``: for the
published block from the concatenation [x; embedding] through the
application's own linear map), microseconds: the host's time to issue
it. Nothing where the program records no such span."""
from portbench import spans


def read(run):
    return spans.mean_us(run, "model.shared", phase="prefill")
