"""The paper's §3.3 identification workflow, end to end (port of
``examples/identify_hot_code.py``):

 1. static analysis  — segment each function into a region timeline
                       (scalar / vector / tensor classes over the ATen op
                       stream; the x86 tool ranked by 256/512-bit
                       register use) and rank functions by heavy-op
                       density;
 2. perf counters    — run the workload in the simulator and build the
                       CORE_POWER.THROTTLE flame graph;
 3. cross-check      — intersect the two to drop trailing-code false
                       positives;
 4. annotate         — the survivors are the code to wrap in
                       with_avx()/without_avx() (here: tag as heavy phase).

  PYTHONPATH=src python -m repro_torch.examples.identify_hot_code
  PYTHONPATH=src python -m repro_torch.examples.identify_hot_code --device cpu

The application's three functions are torch functions, run on the card
by default (``--device cuda``; it raises without a GPU unless ``--device
cpu`` is given) under the op recorder of ``repro_torch.analysis.segment``.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.analysis import (FunctionProfile, rank_functions, report,
                                  segment, tag_heavy)
from repro_torch.core.muqss import SchedConfig
from repro_torch.core.perfcounters import collect, cross_check
from repro_torch.core.simulator import Simulator
from repro_torch.core.workloads import WebConfig, webserver_tasks
from repro_torch.sched import Topology, make_policy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the application's functions run (cuda, "
                         "or cpu)")
    ap.add_argument("--sim-us", type=float, default=300_000.0,
                    help="simulated microseconds of the webserver run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. static analysis over the application's functions ----------
    d, ff = 256, 1024
    w1 = torch.zeros((d, ff), device=dev)
    w2 = torch.zeros((ff, d), device=dev)
    ints = torch.zeros((64, d), dtype=torch.int32, device=dev)
    floats = torch.zeros((64, d), device=dev)

    def chacha20_avx512(x):        # vectorized crypto: pure ALU stream
        for _ in range(8):
            x = (x << 7) ^ (x >> 3) + x
        return x

    def brotli(x):                 # compression: branchy scalar-ish work
        return torch.cumsum(torch.tanh(x) * 0.5, dim=-1)

    def ffn_block(x):              # tensor-core dense (the heavy class)
        return F.gelu(x @ w1, approximate="tanh") @ w2

    # region timelines: program-order phases with their classes —
    # sub-function granularity the whole-function ranking lacks
    timelines = [
        segment(chacha20_avx512, ints, name="chacha20_avx512"),
        segment(brotli, floats, name="brotli"),
        segment(ffn_block, floats, name="ffn_block"),
    ]
    print("== region timelines (program-order phase segmentation) ==")
    for tl in timelines:
        print(tl.report())
        print()
    print("analyzer heavy tags:", tag_heavy(timelines))

    ranked = rank_functions([
        ("chacha20_avx512", chacha20_avx512, (ints,)),
        ("brotli", brotli, (floats,)),
        ("ffn_block", ffn_block, (floats,)),
    ])
    print("\n== whole-function ranking (sorted by heavy-op ratio) ==")
    print(report(ranked))

    # ---- 2. perf-counter pass in the simulator ------------------------
    print("\n== CORE_POWER.THROTTLE flame graph (folded stacks) ==")
    sim = Simulator(SchedConfig(n_cores=12, n_avx_cores=0,
                                specialization=False),
                    topology=Topology.shared(12),
                    policy=make_policy("shared"))
    for t in webserver_tasks(WebConfig(isa="avx512")):
        sim.add_task(t)
    sim.run(args.sim_us)
    rep = collect(sim)
    print(rep.folded("throttle")[:800])
    print("\nlicense residency:", {k: round(v, 3)
                                   for k, v in rep.license_residency().items()})
    print("top throttle culprits:", rep.culprits(3))

    # ---- 3. cross-check to drop false positives -----------------------
    static_for_sim = [
        FunctionProfile("chacha20_avx512", 9, 10, 1),   # dense heavy
        FunctionProfile("brotli", 0, 10, 1),            # scalar
    ]
    confirmed = cross_check(rep, static_for_sim)
    print("\n== cross-check: annotate these ==")
    print(confirmed)
    assert any("chacha20" in c for c in confirmed)
    assert not any("brotli" in c for c in confirmed)
    print("\n(nginx prototype: 9 annotation lines around SSL_read/SSL_write/"
          "SSL_do_handshake/SSL_shutdown — paper §4)")
    return timelines, ranked, confirmed


if __name__ == "__main__":
    main()
