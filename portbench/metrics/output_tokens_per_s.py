"""Output tokens produced in the window (each prefill's first token and
every decoded one) over the window's wall seconds."""


def read(run):
    return run.tokens / run.wall_s if run.wall_s > 0 else None
