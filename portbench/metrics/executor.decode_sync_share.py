"""Share of the decode calls' host time spent in their closing
synchronisation (``executor.sync`` inside ``executor.decode``), %: how
long the host waited on the card. Near 0 the host sets the pace, near 100
the card does."""
from portbench import spans


def read(run):
    calls = spans.named(run, "executor.decode")
    if not calls:
        return None
    ids = {s.id for s in calls}
    syncs = [s for s in spans.named(run, "executor.sync") if s.parent in ids]
    return 100.0 * spans.total_ns(syncs) / spans.total_ns(calls)
