"""Latency samples of a window, in engine time, and their percentiles."""
from __future__ import annotations

import numpy as np


def percentile(xs, q: float):
    """The q-th percentile (linear between order statistics, numpy's
    default); None for no samples."""
    return float(np.percentile(np.asarray(xs, dtype=float), q)) \
        if len(xs) else None


def ttfts(run) -> list:
    """Time to first token of every request that arrived by the cut; a
    request still waiting counts at its wait so far."""
    return [r.ttft_ms if r.ttft_ms is not None else run.t_now - r.arrive_ms
            for r in run.requests]


def waits(run) -> list:
    """TTFT less the request's own prefill call: queueing and handoffs
    (the wait so far for a request still waiting)."""
    return [r.ttft_ms - run.prefill_ms.get(r.rid, 0.0)
            if r.ttft_ms is not None else run.t_now - r.arrive_ms
            for r in run.requests]


def itls(run) -> list:
    """Every gap between output tokens in the window, the open gap of a
    request still decoding at the cut counted at its length so far."""
    out = list(run.itl_ms)
    for r in run.requests:
        if r.done_ms is None and r.last_token_ms is not None \
                and r.last_token_ms < run.t_now:
            out.append(run.t_now - r.last_token_ms)
    return out


def decode_calls(run) -> list:
    return [c for c in run.calls if c.kind == "decode"]


def prefill_calls(run) -> list:
    return [c for c in run.calls if c.kind == "prefill"]
