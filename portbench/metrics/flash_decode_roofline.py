"""``flash_decode``'s share of its roofline in the window's decode steps,
%: the least time of every call the executor's decode rounds made (each
request's step, at the positions it attends: its valid K and V read once)
over the device time of ``flash_decode_kernel`` in the trace. Nothing
when the trace holds another number of its launches than the steps made
calls: the count or the time would then be wrong."""
from portbench import arith, stats


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernel("flash_decode_kernel")
    calls = stats.decode_calls(run)
    per_step = run.counts.attention_calls(run.model)
    want = per_step * sum(len(c.lengths) for c in calls)
    if not want or n != want or secs <= 0:
        return None
    least = per_step * sum(arith.least_s(*run.counts.flash_decode_call(
        run.model, L)) for c in calls for L in c.lengths)
    return 100.0 * least / secs
