"""The executor's decode-round ms over the tokens the rounds produced
(one a request a round), over the window."""
from portbench import stats


def read(run):
    calls = stats.decode_calls(run)
    n = sum(len(c.lengths) for c in calls)
    return sum(c.ms for c in calls) / n if n else None
