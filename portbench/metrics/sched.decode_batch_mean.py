"""Requests a decode round, averaged over the window's rounds."""
from portbench import stats


def read(run):
    calls = stats.decode_calls(run)
    return sum(len(c.lengths) for c in calls) / len(calls) if calls \
        else None
