"""CUDA kernels launched in the traced window per output token."""


def read(run):
    t = run.trace
    if t is None or not run.tokens:
        return None
    return t.kernels / run.tokens
