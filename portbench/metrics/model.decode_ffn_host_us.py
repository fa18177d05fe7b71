"""Mean host time of one decoder layer's FFN and its residual in a decode
step (the span ``model.ffn`` with ``phase=decode``), microseconds."""
from portbench import spans


def read(run):
    return spans.mean_us(run, "model.ffn", phase="decode")
