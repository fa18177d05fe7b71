"""Find a cell's knee on the chip: the highest Poisson rate, in engine
time, at which the port serves the cell's prompt and output lengths
without a growing queue. Run once when a cell is defined; its rates, the
knee and the rate chosen are written into the cell's mix file by hand
(and into ``PERF.md``).

  python3 portbench/sweep.py --cells <cell> [<cell> ...] --seconds 30

One process sets up each cell once, then serves it for ``--seconds`` of
wall time at each rate. The rates are multiples of an estimate of the
capacity from a first short window at a low rate: two pools in engine
time, the prefill pool's spare time decoding, so about 2 / (decode ms a
token x mean output + prefill ms) requests a second, and at most one
prefill at a time. A rate is sustained when the work waiting (output
tokens still owed to the requests that have arrived) grows by less than a
tenth of the work arriving over the second half of the window, by a
least-squares slope in engine time. (The queue of requests, also
recorded, is no test: in a cell of long requests it fills for as long as
a request stays, while the work owed grows only above what the port
serves.) ``--rates`` gives the rates themselves, and skips the estimate.
One JSON line a rate goes to standard output and to
``chiprun_out/portbench/sweep_<cell>.json``.

A window of a minute cannot show the knee of a cell whose requests last
tens of seconds. ``--replay PREFILL_MS DECODE_MS`` then runs on the CPU,
with no model: the port's ``Engine`` and ``SpecializedPolicy`` serve the
cell's traffic over ``--horizon`` seconds of engine time, each prefill
call taking ``PREFILL_MS`` and each request's decode step ``DECODE_MS``
(the executor decodes one request a model call), both as the chip
measured them. Over such a horizon the test is tighter: the work owed may
grow by no more than a fiftieth of the work arriving, on every seed (a
tenth admits rates above the two pools' capacity, 2 / (prefill + mean
output x decode) requests a second, where the work owed grows for good).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MULTIPLES = (0.6, 0.8, 0.9, 1.0, 1.1, 1.25)
REPLAY_SHARE = 0.02     # the replay's test: growth under this share


def _mean_out(spec: dict) -> float:
    if spec["kind"] == "uniform":
        return (spec["lo"] + spec["hi"] - 1) / 2
    return float(spec.get("n", spec.get("median", 64)))


def slope(points: list) -> float:
    """Least-squares slope of (engine ms, depth) points, per second."""
    if len(points) < 2:
        return 0.0
    n = len(points)
    mx = sum(t for t, _ in points) / n
    my = sum(d for _, d in points) / n
    sxx = sum((t - mx) ** 2 for t, _ in points)
    sxy = sum((t - mx) * (d - my) for t, d in points)
    return 1e3 * sxy / sxx if sxx else 0.0


def serve_at(srv, rate: float, seconds: float, seed: int) -> dict:
    """One window at a Poisson ``rate``; the queue's growth and the
    latencies it gave."""
    from portbench import stats
    depth, owed = [], []
    state = {"next": 0, "open": []}

    def record(eng, t, reqs):
        while state["next"] < len(reqs) and \
                reqs[state["next"]].arrive_ms <= t:
            state["open"].append(reqs[state["next"]])
            state["next"] += 1
        state["open"] = [r for r in state["open"] if r.done_ms is None]
        depth.append((t, eng.queue_depth()))
        owed.append((t, sum(r.max_new - r.generated
                            for r in state["open"])))

    mix = dict(srv.mix, arrivals={"kind": "poisson", "rate_per_s": rate})
    run = srv.window(seed, seconds, mix=mix, on_event=record)
    grow = slope([p for p in depth if p[0] >= run.t_now / 2])
    grow_owed = slope([p for p in owed if p[0] >= run.t_now / 2])
    n_out = _mean_out(srv.mix["output"])
    prefill = stats.prefill_calls(run)
    decode = stats.decode_calls(run)
    n_dec = sum(len(c.lengths) for c in decode)
    return {"rate_per_s": rate, "wall_s": run.wall_s,
            "engine_s": run.t_now / 1e3, "arrived": len(run.requests),
            "finished": sum(r.done_ms is not None for r in run.requests),
            "depth_end": depth[-1][1] if depth else 0,
            "growth_per_s": grow, "owed_growth_per_s": grow_owed,
            "sustained": grow_owed < 0.1 * rate * n_out,
            "ttft_p90_ms": stats.percentile(stats.ttfts(run), 90),
            "itl_p95_ms": stats.percentile(stats.itls(run), 95),
            "tokens_per_s": run.tokens / run.wall_s,
            "prefill_ms": (sum(c.ms for c in prefill) / len(prefill)
                           if prefill else None),
            "decode_ms_per_token": (sum(c.ms for c in decode) / n_dec
                                    if n_dec else None)}


class _Replay:
    """An executor that takes the measured call times and runs nothing."""

    def __init__(self, prefill_ms: float, decode_ms: float):
        self.prefill_ms, self.decode_ms = prefill_ms, decode_ms

    def prefill(self, req, chunk, pool, ndev):
        return self.prefill_ms

    def decode(self, batch, pool, ndev):
        return self.decode_ms * len(batch)


def replay_at(mix: dict, rate: float, prefill_ms: float, decode_ms: float,
              horizon_s: float, seed: int) -> dict:
    """The work owed over ``horizon_s`` of engine time at a Poisson
    ``rate``, with each call at its measured time."""
    import heapq
    import itertools

    from portbench import traffic
    from repro_torch.sched import SpecializedPolicy, Topology
    from repro_torch.sched.engine import Engine, Request, ServeConfig
    mix = dict(mix, arrivals={"kind": "poisson", "rate_per_s": rate})
    reqs = [Request(rid=i, arrive_ms=t, prompt_len=int(mix["prompt"]),
                    max_new=n)
            for i, (t, n) in enumerate(traffic.requests(mix, seed))]
    eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                 SpecializedPolicy(),
                 cfg=ServeConfig(prefill_chunk=int(mix["prompt"]),
                                 decode_batch_max=int(
                                     mix["decode_batch_max"])),
                 executor=_Replay(prefill_ms, decode_ms))
    heap, seq = [], itertools.count()
    eng.begin_run(reqs, push=lambda _e, t, k, p: heapq.heappush(
        heap, (t, next(seq), k, p)))
    owed, nxt, t_end = [], 0, horizon_s * 1e3
    open_ = []
    while heap and heap[0][0] <= t_end:
        t, _, kind, payload = heapq.heappop(heap)
        eng.handle(t, kind, payload)
        while nxt < len(reqs) and reqs[nxt].arrive_ms <= t:
            open_.append(reqs[nxt])
            nxt += 1
        open_ = [r for r in open_ if r.done_ms is None]
        owed.append((t, sum(r.max_new - r.generated for r in open_)))
    n_out = _mean_out(mix["output"])
    grow = slope([p for p in owed if p[0] >= t_end / 2])
    return {"rate_per_s": rate, "horizon_s": horizon_s,
            "owed_growth_per_s": grow,
            "sustained": grow < REPLAY_SHARE * rate * n_out}


def replay(cell: str, prefill_ms: float, decode_ms: float, rates: list,
           horizon_s: float, seeds=(1, 2, 3, 4), root: Path = ROOT) -> dict:
    """The knee of ``cell`` by ``replay_at``: a rate is sustained where it
    is on every seed."""
    from portbench.harness import Bench
    mix = Bench(root).mix(cell)
    rows = []
    for rate in rates:
        runs = [replay_at(mix, rate, prefill_ms, decode_ms, horizon_s, s)
                for s in seeds]
        rows.append({"rate_per_s": rate,
                     "owed_growth_per_s": [r["owed_growth_per_s"]
                                           for r in runs],
                     "sustained": all(r["sustained"] for r in runs)})
    bad = [r["rate_per_s"] for r in rows if not r["sustained"]]
    knee = max([r["rate_per_s"] for r in rows if r["sustained"]
                and (not bad or r["rate_per_s"] < min(bad))], default=None)
    return {"cell": cell, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "horizon_s": horizon_s, "knee_per_s": knee, "rows": rows}


def sweep(cell: str, seconds: float, seed: int, out_dir: Path,
          device: str = "cuda", root: Path = ROOT, rates=None) -> dict:
    from portbench.harness import Bench, Serving
    srv = Serving(Bench(root), cell, device)
    srv.make_weights(seed)
    srv.warm_up()
    rows, est = [], None
    if not rates:
        n_out = _mean_out(srv.mix["output"])
        first = serve_at(srv, 0.1, min(seconds, 15.0), seed)
        est = min(2.0 / (first["decode_ms_per_token"] * 1e-3 * n_out
                         + first["prefill_ms"] * 1e-3),
                  1e3 / first["prefill_ms"])
        rates = [round(k * est, 4) for k in MULTIPLES]
        print(json.dumps({"cell": cell, "estimate_per_s": est, **first}),
              flush=True)
    for rate in rates:
        r = serve_at(srv, rate, seconds, seed + 1)
        rows.append(r)
        print(json.dumps({"cell": cell, **r}), flush=True)
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    bad = [r["rate_per_s"] for r in rows if not r["sustained"]]
    knee = max([x for x in ok if not bad or x < min(bad)], default=None)
    res = {"cell": cell, "seconds": seconds, "estimate_per_s": est,
           "knee_per_s": knee, "rows": rows}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"sweep_{cell}.json").write_text(json.dumps(res, indent=1))
    del srv
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="*",
                    help="the rates (req/s); default: multiples of the "
                         "estimate")
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--replay", type=float, nargs=2,
                    metavar=("PREFILL_MS", "DECODE_MS"),
                    help="replay the engine on the CPU with these call "
                         "times over --horizon (needs --rates)")
    ap.add_argument("--horizon", type=float, default=900.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "portbench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    t0 = time.perf_counter()
    if args.replay:
        for cell in args.cells:
            res = replay(cell, *args.replay, args.rates, args.horizon)
            print(json.dumps(res), flush=True)
        return 0
    for cell in args.cells:
        res = sweep(cell, args.seconds, args.seed, Path(args.out),
                    rates=args.rates)
        print(f"[sweep] {cell}: knee {res['knee_per_s']} req/s (estimate "
              f"{res['estimate_per_s']}) at {time.perf_counter() - t0:.0f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
