"""Mean of the executor's measured prefill calls in the window, ms
(``RealModelExecutor.prefill``'s own time between two synchronises)."""
from portbench import stats


def read(run):
    calls = stats.prefill_calls(run)
    return sum(c.ms for c in calls) / len(calls) if calls else None
