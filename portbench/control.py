"""The readings a cell's limit is set from, on the chip: the program's
widest logit gap over many seeds, and the control's (the reference in
fp8 in the program's place) over some of them.

  python3 portbench/control.py --cell <cell> --seeds 12 --control 4 --seconds 30

One process sets the cell up once; for each seed it makes that seed's
weights, serves a window of ``--seconds`` at the cell's own load, and
judges a sample of the finished requests as a run does. On the first
``--control`` seeds it also reads, at every position of the same prompts
and tokens, the gap of the token that the fp8 reference puts first. One
JSON line a seed on standard output and in
``chiprun_out/portbench/control_<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seeds: list, n_control: int, seconds: float,
             device: str = "cuda", root: Path = ROOT, out=None) -> list:
    from portbench import judge
    from portbench.harness import Bench, Serving
    srv = Serving(Bench(root), cell, device)
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        srv.make_weights(seed)
        if i == 0:
            srv.warm_up()
        run = srv.window(seed, seconds)
        chk = judge.check(srv, run, seed, control=i < n_control)
        row = {"cell": cell, "seed": seed, **chk,
               "finished": len(run.served),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    out = ROOT / "chiprun_out" / "portbench" / f"control_{args.cell}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = readings(args.cell, seeds, args.control, args.seconds, out=out)
    gaps = [r["gap"] for r in rows if r["gap"] is not None]
    ctrl = [r["control_gap"] for r in rows if "control_gap" in r]
    print(f"[control] {args.cell}: program's widest gap {max(gaps)} over "
          f"{len(gaps)} seeds; the control's least {min(ctrl)} over "
          f"{len(ctrl)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
