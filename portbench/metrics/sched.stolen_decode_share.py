"""Share of the prefill pool's executor time spent on stolen decode
rounds (``executor.decode`` spans on pool ``prefill`` over every executor
span on that pool), %: a prefill that arrives during one waits for it."""
from portbench import spans


def read(run):
    dec = spans.named(run, "executor.decode", pool="prefill")
    pre = spans.named(run, "executor.prefill", pool="prefill")
    if dec is None or not dec + pre:
        return None
    stolen = spans.total_ns(dec)
    return 100.0 * stolen / (stolen + spans.total_ns(pre))
