"""Experiment drivers for the paper's figures — shared by benchmarks/
and tests. Each returns plain dicts so benches can print CSV and tests
can assert the paper's headline numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.license import LicenseConfig
from repro_torch.core.muqss import SchedConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.task import Task, TaskType
from repro_torch.core.workloads import (
    OverheadConfig, WebConfig, crypto_microbench, overhead_tasks,
    webserver_tasks,
)
from repro_torch.sched import (CohortPolicy, Policy, SharedBaselinePolicy,
                         SpecializedPolicy, Topology)

N_CORES = 12          # paper: web server on 12 of 16 cores
N_AVX = 2             # paper: SSL restricted to the last two cores
SIM_US = 3_000_000.0  # 3 simulated seconds


def run_webserver(isa: str, specialization: bool, *,
                  compressed: bool = True, sim_us: float = SIM_US,
                  n_cores: int = N_CORES, n_avx: int = N_AVX,
                  seed: int = 0, ipc_bonus: float = 0.007,
                  policy: Optional[Policy] = None,
                  strict_chunks: bool = False) -> Dict:
    """One webserver run through the shared repro_torch.sched API: the core
    partition is an explicit Topology, the specialization decision an
    explicit Policy (override `policy` to plug in a custom one).
    strict_chunks replays with the legacy 25 µs chunked execution loop
    (perf-benchmark baseline / differential debugging)."""
    wcfg = WebConfig(isa=isa, compressed=compressed, seed=seed,
                     n_conns=2 * n_cores)
    scfg = SchedConfig(n_cores=n_cores, n_avx_cores=n_avx,
                       specialization=specialization)
    topo = Topology.cores(n_cores, n_avx if specialization else 0)
    pol = policy or (SpecializedPolicy() if specialization
                     else SharedBaselinePolicy())
    sim = Simulator(scfg, LicenseConfig(),
                    ipc_locality_bonus=ipc_bonus if specialization else 0.0,
                    topology=topo, policy=pol,
                    strict_chunks=strict_chunks)
    for task in webserver_tasks(wcfg):
        sim.add_task(task, 0.0)
    m = sim.run(sim_us)
    return {
        "isa": isa,
        "spec": specialization,
        "policy": pol.name,
        "throughput_rps": m.throughput_per_s(),
        "avg_freq_ghz": sim.avg_frequency_ghz(),
        "p50_us": m.p(0.50),
        "p99_us": m.p(0.99),
        "counters": sim.counters(),
        "license": sim.license_snapshot(),
        "events_processed": sim.events_processed,
        "flame_throttle": {"/".join(k): v
                           for k, v in m.flame_throttle.items()},
    }


def fig5_throughput(**kw) -> Dict[str, Dict]:
    """Fig. 5: normalized throughput, with and without specialization."""
    out = {}
    for spec in (False, True):
        base = run_webserver("sse4", spec, **kw)
        for isa in ("sse4", "avx2", "avx512"):
            r = run_webserver(isa, spec, **kw) if isa != "sse4" else base
            key = f"{isa}|{'spec' if spec else 'nospec'}"
            r["normalized"] = r["throughput_rps"] / base["throughput_rps"]
            out[key] = r
    return out


def fig6_frequency(results: Optional[Dict] = None, **kw) -> Dict[str, float]:
    res = results or fig5_throughput(**kw)
    return {k: v["avg_freq_ghz"] for k, v in res.items()}


def fig2_sensitivity(sim_us: float = SIM_US) -> Dict[str, Dict[str, float]]:
    """Fig. 2: normalized performance per workload class (no spec)."""
    out = {"compressed": {}, "uncompressed": {}, "micro": {}}
    for mode in ("compressed", "uncompressed"):
        base = None
        for isa in ("sse4", "avx2", "avx512"):
            r = run_webserver(isa, False, compressed=(mode == "compressed"),
                              sim_us=sim_us)
            if isa == "sse4":
                base = r["throughput_rps"]
            out[mode][isa] = r["throughput_rps"] / base
    # crypto microbenchmark: single busy core
    base = None
    for isa in ("sse4", "avx2", "avx512"):
        scfg = SchedConfig(n_cores=1, n_avx_cores=0, specialization=False)
        sim = Simulator(scfg)
        sim.add_task(Task(crypto_microbench(isa), ttype=TaskType.SCALAR))
        m = sim.run(sim_us / 3)
        thr = m.completed / (sim_us / 3)
        if isa == "sse4":
            base = thr
        out["micro"][isa] = thr / base
    return out


def run_cohort(isa: str, *, sim_us: float = SIM_US, n_cores: int = N_CORES,
               batch_n: int = 8, seed: int = 0) -> Dict:
    """Cohort scheduling (paper §5 comparison): no specialization, AVX
    sections batched per connection."""
    from repro_torch.core.workloads import cohort_tasks
    wcfg = WebConfig(isa=isa, seed=seed, n_conns=2 * n_cores)
    scfg = SchedConfig(n_cores=n_cores, n_avx_cores=0, specialization=False)
    sim = Simulator(scfg, LicenseConfig(), topology=Topology.shared(n_cores),
                    policy=CohortPolicy(batch_n))
    for task in cohort_tasks(wcfg, batch_n):
        sim.add_task(task, 0.0)
    m = sim.run(sim_us)
    return {"isa": isa, "throughput_rps": m.throughput_per_s(),
            "avg_freq_ghz": sim.avg_frequency_ghz(),
            "counters": sim.counters()}


def cohort_comparison(sim_us: float = 1_000_000.0) -> Dict[str, float]:
    """Returns normalized-throughput drops: nospec vs cohort vs spec for
    AVX-512 (the paper's §5 expectation: spec > cohort > nothing)."""
    base = run_webserver("sse4", False, sim_us=sim_us)["throughput_rps"]
    nospec = run_webserver("avx512", False, sim_us=sim_us)["throughput_rps"]
    spec = run_webserver("avx512", True, sim_us=sim_us)["throughput_rps"]
    base_c = run_cohort("sse4", sim_us=sim_us)["throughput_rps"]
    cohort = run_cohort("avx512", sim_us=sim_us)["throughput_rps"]
    return {"drop_nospec": 1 - nospec / base,
            "drop_cohort": 1 - cohort / base_c,
            "drop_spec": 1 - spec / base}


def run_trace_sim(trace, specialization: bool, *, n_cores: int = 12,
                  n_avx: int = 4, policy: Optional[Policy] = None,
                  isa: str = "avx512", slack_us: float = 20_000.0,
                  strict_chunks: bool = False) -> Dict:
    """Replay a serving trace (repro_torch.sched.workload) through the OS
    simulator — the second mechanism of the differential replay harness.
    Arrival times are time-compressed (1 trace-ms == 1 sim-µs, see
    core/workloads.trace_tasks); the run extends ``slack_us`` past the
    last arrival so admitted requests can drain. ``strict_chunks``
    replays with the legacy 25 µs chunked loop (differential baseline)."""
    from repro_torch.core.workloads import trace_tasks
    scfg = SchedConfig(n_cores=n_cores,
                       n_avx_cores=n_avx if specialization else 0,
                       specialization=specialization)
    topo = Topology.cores(n_cores, n_avx if specialization else 0)
    pol = policy or (SpecializedPolicy() if specialization
                     else SharedBaselinePolicy())
    sim = Simulator(scfg, LicenseConfig(), topology=topo, policy=pol,
                    strict_chunks=strict_chunks)
    tasks = trace_tasks(trace, isa=isa)
    for task, at in tasks:
        sim.add_task(task, at)
    until = max((at for _, at in tasks), default=0.0) + slack_us
    m = sim.run(until)
    c = sim.counters()
    lic = sim.license_snapshot()
    return {
        "mechanism": "simulator",
        "policy": pol.name,
        "n_requests": len(tasks),
        "completed": m.completed,
        "latency_p50_us": m.p(0.50),
        "latency_p99_us": m.p(0.99),
        "avg_freq_ghz": sim.avg_frequency_ghz(),
        "license_residency": lic["license_residency"],
        "freq_transitions": lic["transitions"],
        "energy_proxy": lic["energy_proxy"],
        "migrations": c["migrations"],
        "type_changes": c["type_changes"],
        "sim_us": until,
        "events_processed": sim.events_processed,
    }


def fig7_overhead(rates_hint: Optional[List[float]] = None,
                  sim_us: float = 1_000_000.0) -> List[Dict]:
    """Fig. 7: overhead vs task-type-change rate. Loop length is swept;
    overhead = 1 - thpt(spec)/thpt(nospec); also reports ns per change
    pair."""
    out = []
    for loop_cycles in (28_000_000.0, 5_600_000.0, 2_800_000.0, 1_120_000.0,
                        560_000.0, 280_000.0):
        ocfg = OverheadConfig(loop_cycles=loop_cycles)
        res = {}
        for spec in (False, True):
            scfg = SchedConfig(n_cores=ocfg.n_cores,
                               n_avx_cores=4 if spec else 0,
                               specialization=spec)
            sim = Simulator(scfg)
            for t in overhead_tasks(ocfg):
                sim.add_task(t)
            m = sim.run(sim_us)
            res[spec] = (m.completed, sim.counters())
        thpt_ns, thpt_sp = res[False][0], res[True][0]
        changes_per_s = res[True][1]["type_changes"] / (sim_us / 1e6)
        overhead = 1.0 - thpt_sp / thpt_ns
        pairs_per_s = changes_per_s / 2.0
        ns_per_pair = (overhead * ocfg.n_cores * 1e9 / pairs_per_s
                       if pairs_per_s else 0.0)
        out.append({"loop_cycles": loop_cycles,
                    "type_changes_per_s": changes_per_s,
                    "overhead": overhead,
                    "ns_per_change_pair": ns_per_pair})
    return out
