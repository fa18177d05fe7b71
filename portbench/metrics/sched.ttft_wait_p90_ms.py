"""90th percentile of TTFT less the request's own prefill call, engine ms:
the queueing and handoffs the scheduler adds."""
from portbench import stats


def read(run):
    return stats.percentile(stats.waits(run), 90)
