"""``flash_attention``'s share of its roofline in the window's prefills, %:
each call's least time (``arith.flash_attention_cost`` at the cell's
prompt: causal, q, k, v read and o written once) over the device time of
``flash_attention_tc_kernel`` and ``flash_attention_kernel`` in the
trace. Nothing when the trace holds another number of their launches
than the prefills made calls: the count or the time would then be
wrong."""
from portbench import arith, stats


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernel("flash_attention_tc_kernel",
                               "flash_attention_kernel")
    want = run.counts.attention_calls(run.model) * len(
        stats.prefill_calls(run))
    if not want or n != want or secs <= 0:
        return None
    least = arith.least_s(*run.counts.flash_attention_call(run.model,
                                                           run.prompt))
    return 100.0 * want * least / secs
