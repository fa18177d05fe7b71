"""90th percentile of time to first token, engine ms, over every request
that arrived in the window (a request still waiting at the cut counts at
its wait so far, so a stall shows)."""
from portbench import stats


def read(run):
    return stats.percentile(stats.ttfts(run), 90)
