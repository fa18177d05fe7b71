"""Workload models for the paper's experiments.

The nginx/OpenSSL/brotli web-server scenario (§4) is modelled per
request: parse (scalar) -> SSL_read (annotated crypto) -> brotli
compression (scalar, dominant) -> SSL_write (annotated crypto).
Closed-loop connection tasks saturate the server like wrk2 at capacity.

Calibration (documented in EXPERIMENTS.md §Fig5): the paper's operating
point is 12 server cores and ~55,000 task-type changes/s, i.e. ~1,146
requests/core/s with 4 annotated SSL calls each. Only a fraction of SSL
write sections sustain a dense-enough heavy mix to trigger a license
request (paper §3.3: stalls and short bursts do not change frequency);
that fraction (``p_trigger``) is the single calibrated free parameter —
0.19 for AVX-512 / 0.16 for AVX2 reproduces the measured average
frequency drops (11.4% / 4.4%), and everything else follows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch.core.simulator import RequestDone
from repro_torch.core.task import IClass, Segment, Task, TaskType, TypeChange

GHZ0 = 2.8  # nominal frequency (cycles below are at L0)

ICLASS_OF_ISA = {"sse4": IClass.SCALAR, "avx2": IClass.AVX2,
                 "avx512": IClass.AVX512}


@dataclass
class WebConfig:
    isa: str = "avx512"
    n_conns: int = 24
    compressed: bool = True
    # per-request work (cycles at 2.8 GHz)
    parse_cycles: float = 30_000.0          # accept/parse/headers
    brotli_cycles: float = 2_390_000.0      # on-the-fly compression (~860 µs)
    uncompressed_scalar_cycles: float = 530_000.0
    response_bytes: int = 16_384            # compressed payload (one record)
    uncompressed_bytes: int = 204_800
    request_bytes: int = 1_024
    # ChaCha20-Poly1305 cycles/byte by ISA (microbenchmark ratios ~1:2:3.6)
    cycles_per_byte: dict = field(default_factory=lambda: {
        "sse4": 3.4, "avx2": 1.7, "avx512": 0.94})
    # fraction of SSL_write sections dense enough to trigger a license
    p_trigger: dict = field(default_factory=lambda: {
        "sse4": 0.0, "avx2": 0.16, "avx512": 0.19})
    seed: int = 0


def _connection(cfg: WebConfig, rng: np.random.Generator
                ) -> Iterator[object]:
    """Infinite closed-loop connection: request after request."""
    icl = ICLASS_OF_ISA[cfg.isa]
    cpb = cfg.cycles_per_byte[cfg.isa]
    p_trig = cfg.p_trigger[cfg.isa]
    resp = cfg.response_bytes if cfg.compressed else cfg.uncompressed_bytes
    scalar = (cfg.parse_cycles + cfg.brotli_cycles) if cfg.compressed \
        else (cfg.parse_cycles + cfg.uncompressed_scalar_cycles)
    annotated = icl != IClass.SCALAR
    while True:
        yield Segment(cfg.parse_cycles * 0.5, IClass.SCALAR,
                      stack=("nginx", "http_parse"))
        # SSL_read — short, never dense enough to trigger
        if annotated:
            yield TypeChange(TaskType.AVX)
        yield Segment(cfg.request_bytes * cpb, icl, dense=False,
                      stack=("nginx", "SSL_read", f"chacha20_{cfg.isa}"))
        if annotated:
            yield TypeChange(TaskType.SCALAR)
        # compression / static serving (scalar, dominant)
        yield Segment(scalar, IClass.SCALAR,
                      stack=("nginx", "brotli" if cfg.compressed
                             else "sendfile"))
        # SSL_write — the big crypto section. Longer sections are more
        # likely to sustain the dense heavy mix (certain at ~10x a record).
        if annotated:
            yield TypeChange(TaskType.AVX)
        p_eff = min(1.0, p_trig * resp / 16_384)
        dense = bool(rng.random() < p_eff)
        yield Segment(resp * cpb, icl, dense=dense,
                      stack=("nginx", "SSL_write", f"chacha20_{cfg.isa}"))
        if annotated:
            yield TypeChange(TaskType.SCALAR)
        yield RequestDone()


def webserver_tasks(cfg: WebConfig):
    rng = np.random.default_rng(cfg.seed)
    return [Task(_connection(cfg, np.random.default_rng(rng.integers(1 << 31))),
                 ttype=TaskType.SCALAR, name=f"conn{i}")
            for i in range(cfg.n_conns)]


def _cohort_connection(cfg: WebConfig, rng: np.random.Generator,
                       batch_n: int = 8) -> Iterator[object]:
    """Cohort-scheduling alternative (paper §5): batch the AVX sections of
    several requests back-to-back to reduce frequency transitions. The
    paper expects this to help LESS than core specialization because all
    cores still periodically drop their frequency — reproduced by
    benchmarks/figures.bench_cohort."""
    icl = ICLASS_OF_ISA[cfg.isa]
    cpb = cfg.cycles_per_byte[cfg.isa]
    p_trig = cfg.p_trigger[cfg.isa]
    resp = cfg.response_bytes if cfg.compressed else cfg.uncompressed_bytes
    scalar = cfg.parse_cycles + (cfg.brotli_cycles if cfg.compressed
                                 else cfg.uncompressed_scalar_cycles)
    while True:
        for _ in range(batch_n):      # scalar phases of the cohort
            yield Segment(scalar, IClass.SCALAR, stack=("nginx", "brotli"))
        p_eff = min(1.0, p_trig * resp / 16_384)
        for _ in range(batch_n):      # crypto phases back-to-back
            dense = bool(rng.random() < p_eff)
            yield Segment(resp * cpb, icl, dense=dense,
                          stack=("nginx", "SSL_write", f"chacha20_{cfg.isa}"))
        for _ in range(batch_n):
            yield RequestDone()


def cohort_tasks(cfg: WebConfig, batch_n: int = 8):
    rng = np.random.default_rng(cfg.seed)
    return [Task(_cohort_connection(cfg, np.random.default_rng(
        rng.integers(1 << 31)), batch_n), ttype=TaskType.SCALAR,
        name=f"cohort{i}") for i in range(cfg.n_conns)]


def crypto_microbench(isa: str, section_bytes: int = 1 << 16
                      ) -> Iterator[object]:
    """Pure encryption loop (Fig. 2 'microbenchmark' column): infinite;
    throughput = completed sections over a fixed interval."""
    cfgd = WebConfig(isa=isa)
    icl = ICLASS_OF_ISA[isa]
    cpb = cfgd.cycles_per_byte[isa]
    while True:
        if icl != IClass.SCALAR:
            yield TypeChange(TaskType.AVX)
        yield Segment(section_bytes * cpb, icl, dense=True,
                      stack=("micro", f"chacha20_{isa}"))
        if icl != IClass.SCALAR:
            yield TypeChange(TaskType.SCALAR)
        yield RequestDone()


# ------------------------------------------------ serving-trace replay

# Time compression for replaying serving traces (repro_torch.sched.workload)
# through the OS simulator: 1 trace-ms maps to 1 sim-µs, and per-token
# cycle costs are scaled so the heavy/light duty cycle matches the
# serving engine's prefill/decode ratio. The differential replay
# harness uses this to drive the *same* trace through both mechanisms.
TRACE_PREFILL_CYCLES_PER_TOK = 205.0   # ~150 sim-µs per 2k-tok prefill
TRACE_DECODE_CYCLES_PER_TOK = 6_000.0  # ~2 sim-µs per generated token


def _trace_request(prompt_len: int, max_new: int, isa: str,
                   prefill_cycles_per_tok: float,
                   decode_cycles_per_tok: float) -> Iterator[object]:
    """One serving request as an OS-simulator task body: an annotated
    heavy (AVX-analogue) prefill section, then light decode segments."""
    icl = ICLASS_OF_ISA[isa]
    yield TypeChange(TaskType.AVX)
    yield Segment(prompt_len * prefill_cycles_per_tok, icl,
                  dense=True, stack=("serve", "prefill"))
    yield TypeChange(TaskType.SCALAR)
    for _ in range(max_new):
        yield Segment(decode_cycles_per_tok, IClass.SCALAR,
                      stack=("serve", "decode"))
    yield RequestDone()


def trace_tasks(trace, isa: str = "avx512"):
    """Convert a serving trace (``repro_torch.sched.workload.Trace`` or any
    object with ``.requests`` carrying rid/arrive_ms/prompt_len/max_new/
    tenant) into ``[(Task, arrive_us)]`` for ``Simulator.add_task``.
    Task names are ``tenant:rid`` so per-tenant latencies group.

    Per-token cycle costs default to the hand-tuned constants above; a
    trace whose ``meta['sim_work']`` carries analyzer-derived values
    (the ``zoo/*`` scenarios, stamped by ``repro_torch.analysis.calibrate``)
    replays that model's duty cycle instead."""
    sim_work = {}
    if getattr(trace, "meta", None):
        sim_work = trace.meta.get("sim_work") or {}
    pre = float(sim_work.get("prefill_cycles_per_tok",
                             TRACE_PREFILL_CYCLES_PER_TOK))
    dec = float(sim_work.get("decode_cycles_per_tok",
                             TRACE_DECODE_CYCLES_PER_TOK))
    return [(Task(_trace_request(r.prompt_len, r.max_new, isa, pre, dec),
                  ttype=TaskType.SCALAR, name=f"{r.tenant}:{r.rid}"),
             r.arrive_ms)          # 1 trace-ms == 1 sim-µs
            for r in trace.requests]


# ---------------------------------------------------- Fig. 7 microbench


@dataclass
class OverheadConfig:
    """Scalar loop with 5% marked as-if-AVX (§4.3): measures pure
    scheduler/migration overhead — the marked part is still scalar code,
    so there are no frequency effects."""
    loop_cycles: float = 280_000.0     # one loop iteration (varied)
    n_threads: int = 26
    n_cores: int = 24
    avx_fraction: float = 0.05


def overhead_loop(cfg: OverheadConfig) -> Iterator[object]:
    while True:
        yield Segment(cfg.loop_cycles * (1 - cfg.avx_fraction),
                      IClass.SCALAR, stack=("micro", "scalar_loop"))
        yield TypeChange(TaskType.AVX)
        yield Segment(cfg.loop_cycles * cfg.avx_fraction,
                      IClass.SCALAR,  # marked as AVX, actually scalar
                      stack=("micro", "marked_section"))
        yield TypeChange(TaskType.SCALAR)
        yield RequestDone()


def overhead_tasks(cfg: OverheadConfig):
    return [Task(overhead_loop(cfg), ttype=TaskType.SCALAR, name=f"t{i}")
            for i in range(cfg.n_threads)]
