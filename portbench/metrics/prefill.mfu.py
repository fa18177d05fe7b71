"""The prefill calls' model FLOPs (the configuration's counts module: what
the inputs need, the logits of the last position only) over their
measured time, as a share of the bf16 peak, %."""
from portbench import arith, stats


def read(run):
    calls = stats.prefill_calls(run)
    if not calls:
        return None
    flops = len(calls) * run.counts.prefill_flops(run.model, run.prompt)
    secs = sum(c.ms for c in calls) * 1e-3
    return 100.0 * flops / secs / arith.BF16_FLOPS_PER_S
