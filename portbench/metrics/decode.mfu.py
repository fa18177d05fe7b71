"""The decode rounds' least time on the chip's peaks over their measured
time, %. A round's least time is the larger of its FLOPs at the bf16 peak
and its bytes at the HBM peak, with every weight counted once a round
(what a batched step reads) and each request's own cache or state once,
so a later batched decode cannot read above 100%."""
from portbench import arith, stats


def read(run):
    calls = stats.decode_calls(run)
    if not calls:
        return None
    c, m = run.counts, run.model
    least = sum(arith.least_s(
        sum(c.decode_flops(m, L) for L in k.lengths),
        c.weight_bytes(m) + sum(c.request_bytes(m, L) for L in k.lengths))
        for k in calls)
    return 100.0 * least / (sum(k.ms for k in calls) * 1e-3)
