"""Run one cell of the port's benchmark once, on the machine it starts on:

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up builds the port's CUDA kernels into
the checkout's ``build/`` (the first run there; later ones find them
built), makes the weights on the card from ``--seed``, builds the serving
stack and warms up the cell's own shapes (one prefill at its prompt and
one decode step). The window then serves the cell's traffic for
``--seconds`` of wall time. With ``--trace 1`` the window runs under the
profiler and the per-layer metrics are reported in place of the
end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), then ``checks``, each number compared beside its limit,
which also end standard error. The run exits non-zero and prints no
result without a CUDA device or the program, or if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def caches() -> None:
    """Every kernel cache at a fixed place inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START, log=sys.stderr) -> dict:
    """One run of ``cell``; the result object (without the device)."""
    from portbench import judge
    from portbench.harness import Bench, Serving, report
    bench = Bench(root)
    chips = int(bench.cell(cell)["chips"])
    srv = Serving(bench, cell, device, log)
    w_s = srv.make_weights(seed)
    warm = srv.warm_up()
    import torch
    setup_s = time.perf_counter() - t_start
    print(f"[portbench] set-up {setup_s:.3f} s (weights {w_s:.3f} s, "
          f"warm-up {warm:.3f} s)", file=log)
    run = srv.window(seed, seconds, traced, setup_s=setup_s)
    metrics = report(bench, run, traced)
    chk = judge.check(srv, run, seed)
    limit = float(run.mix["check"]["gap_limit"])
    correct = chk["gap"] is not None and chk["gap"] <= limit
    checks = {"logit_gap": {"value": chk["gap"], "limit": limit},
              "tokens_judged": {"value": chk["tokens"], "limit": 1}}
    dev = {"platform": "gpu" if srv.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(srv.device)
                    if srv.device.type == "cuda" else "cpu"),
           "count": chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": len(run.requests),
           "failed": int(chk["failed"]), "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": run.trace.top(10),
            "idle_gaps": sorted(([k, v] for k, v in
                                 run.trace.idle_by_host.items()),
                                key=lambda x: -x[1])[:10]}
        print(f"[portbench] trace: {run.trace.kernels} kernels, busy "
              f"{run.trace.busy_s:.3f} of {run.trace.window_s:.3f} s, "
              f"{run.trace.aligned:.4f} of the busy spans inside a call",
              file=log)
    print(f"[portbench] window {run.wall_s:.3f} s wall, {run.t_now:.1f} ms "
          f"engine, {len(run.requests)} requests arrived, {run.tokens} "
          f"tokens, {sum(r.done_ms is not None for r in run.requests)} "
          f"finished; judged {chk['requests']} requests", file=log)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 5
    caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: nothing it runs may "
              "import JAX or the JAX package", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"[portbench] check {name}: {c['value']} (limit "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
