"""Share of the prefill calls' host time spent in Mamba2's chunked SSD
scan (the spans ``mamba2.ssd_scan`` over the ``executor.prefill`` spans),
%. Nothing where the program records no scan span or no prefill."""
from portbench import spans


def read(run):
    scans = spans.named(run, "mamba2.ssd_scan")
    calls = spans.named(run, "executor.prefill")
    if not scans or not calls:
        return None
    return 100.0 * spans.total_ns(scans) / spans.total_ns(calls)
