"""Perf-iteration runner over the dry-run (the port of
``repro.launch.perf``): each hillclimb cell's variants are named override
sets, traced by ``repro_torch.launch.dryrun.run_cell``; results
accumulate in ``results/perf_cuda.json``. A variant that cannot be
traced ends as ``status: error``, as the reference's ``run_cell`` records
it. The ``seq_parallel`` variants run the transformer's residual
sequence-sharded over ``model`` between blocks (``models.tp``).

  PYTHONPATH=src python -m repro_torch.launch.perf --cell deepseek_train
  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen_train \
      --variant seqpar
  PYTHONPATH=src python -m repro_torch.launch.perf --all
"""
import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import run_cell

# hillclimb cells (chosen per the baseline table):
#   deepseek train_4k  — most collective-bound (coll/comp ~ 9.5x)
#   rwkv6 train_4k     — worst roofline fraction (mfu 0.006)
#   chameleon decode   — the paper-representative serving (light-phase) cell
CELLS = {
    "deepseek_train": {
        "arch": "deepseek-v3-671b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            # H1: FSDP weight gathers repeat per microbatch; halving
            # grad_accum halves gather traffic (activation memory x2)
            ("ga8", {"grad_accum": 8}),
            # H2: full-mesh EP — experts fully local (no FSDP gathers, no
            # grad reduce-scatter for experts); tokens move instead of
            # weights (deepseek-v3's actual EP design)
            ("ep_full_mesh", {"ep_over_dp": True, "grad_accum": 8}),
            # H3: + sequence-parallel activations between blocks
            ("ep_fm+seqpar", {"ep_over_dp": True, "grad_accum": 8,
                              "seq_parallel": True}),
            # H4: ZeRO-1 for the (small) attention/dense params on top of
            # full-mesh EP — removes the remaining FSDP gathers
            ("ep_fm+zero1", {"ep_over_dp": True, "grad_accum": 8,
                             "zero1": True, "fsdp": False}),
            # H5: fewer microbatches now that weights no longer move
            ("ep_fm+zero1+ga4", {"ep_over_dp": True, "grad_accum": 4,
                                 "zero1": True, "fsdp": False}),
        ],
    },
    "rwkv6_train": {
        "arch": "rwkv6-3b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            # H1: FSDP gathers dominate a 2.9B pure-DP model; ZeRO-1
            # (params replicated, opt sharded) trades them for ONE
            # gradient all-reduce + ONE param all-gather per step
            ("zero1", {"zero1": True, "fsdp": False}),
        ],
    },
    "chameleon_decode": {
        "arch": "chameleon-34b", "shape": "decode_32k",
        "variants": [
            ("baseline", {}),
            # H1: serving must not FSDP-shard weights (34B bf16 / 16
            # model-shards = 4.2 GB/device fits); replication removes the
            # per-step weight all-gathers entirely
            ("serve_replicated", {"fsdp": False}),
        ],
    },
    # breadth: apply the winning levers to the remaining heavy cells
    "grok_train": {
        "arch": "grok-1-314b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("zero1+ga4", {"zero1": True, "fsdp": False, "grad_accum": 4}),
        ],
    },
    "zamba2_train": {
        "arch": "zamba2-2.7b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("zero1", {"zero1": True, "fsdp": False}),
        ],
    },
    "whisper_train": {
        "arch": "whisper-large-v3", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("zero1", {"zero1": True, "fsdp": False}),
        ],
    },
    # bonus dense-train cell for the seq-parallel lever in isolation
    "chameleon_train": {
        "arch": "chameleon-34b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("seqpar", {"seq_parallel": True}),
            ("seqpar+zero1", {"seq_parallel": True, "zero1": True,
                              "fsdp": False}),
            # isolate zero1 from the refuted seq-parallel change
            ("zero1", {"zero1": True, "fsdp": False}),
            ("zero1+ga2", {"zero1": True, "fsdp": False, "grad_accum": 2}),
        ],
    },
    # the seq-parallel lever on the smallest dense train cell (about a
    # seventh of chameleon_train's trace time)
    "qwen_train": {
        "arch": "qwen1.5-0.5b", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("seqpar", {"seq_parallel": True}),
        ],
    },
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="only this variant of the cell")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (no card needed)")
    ap.add_argument("--out", default="results/perf_cuda.json")
    args = ap.parse_args(argv)
    names = list(CELLS) if args.all else [args.cell]
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    for name in names:
        spec = CELLS[name]
        for vname, overrides in spec["variants"]:
            if args.variant not in (None, vname):
                continue
            key = f"{name}|{vname}|{args.mesh}"
            if results.get(key, {}).get("status") == "ok":
                print(f"[skip cached] {key}")
                continue
            print(f"[perf] {key} overrides={overrides}", flush=True)
            res = run_cell(spec["arch"], spec["shape"], args.mesh,
                           overrides=overrides, device=args.device)
            res["variant"] = vname
            res["overrides"] = overrides
            results[key] = res
            out_path.write_text(json.dumps(results, indent=1))
            if res["status"] == "ok":
                r = res["roofline"]
                print(f"  -> comp={r['compute_s']:.3g}s "
                      f"mem_lb={r['memory_floor_s']:.3g}s "
                      f"coll={r['collective_s']:.3g}s "
                      f"step={r['step_s']:.3g}s mfu={r['mfu']:.3f} "
                      f"trace={res['trace_s']}s", flush=True)
            else:
                print("  -> ERROR", res.get("error"), flush=True)


if __name__ == "__main__":
    main()
