"""Mean host time of one Mamba2 layer in a prefill of the hybrid (the span
``model.mamba`` with ``phase=prefill``: its norm, chunked Mamba2 forward
and state write, and residual, for one model call), microseconds: the
host's time to issue it. The prefill runs eagerly where the decode steps
replay a CUDA graph, which issues no layer from the host and records no
such span. Nothing where the program records no such span."""
from portbench import spans


def read(run):
    return spans.mean_us(run, "model.mamba", phase="prefill")
