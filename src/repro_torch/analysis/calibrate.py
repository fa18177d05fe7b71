"""Calibration backend of the port: run the region pass over the kernel
suite and the model zoo with an H100 machine model, derive per-workload
heavy tags, FrequencyDomain level configs and scenario parameters, and
write the port's artifact ``derived_cuda.json``.

  PYTHONPATH=src python -m repro_torch.analysis.calibrate            # table, on the GPU
  PYTHONPATH=src python -m repro_torch.analysis.calibrate --device cpu --no-differential
  PYTHONPATH=src python -m repro_torch.analysis.calibrate --update   # rewrite derived_cuda.json

Port of ``repro.analysis.calibrate``. It runs on the card by default
(``--device cuda``; it raises without a GPU unless ``--device cpu`` is
given): the kernel timelines and differentials run the port's three
kernels there (``chacha20``, ``flash_attention``, ``flash_decode``). The
model timelines run at each architecture's full published config on the
meta device, where nothing is allocated. Only the families the port builds
are calibrated; the others are listed under ``"skipped"`` with the
ROADMAP item that ports them.

``--update`` writes ``derived_cuda.json`` beside the copied
``derived.json`` and never over it: the port's serving path reads the
reference's ``derived.json`` (``analysis.derived``), so this artifact
changes no serving behaviour.

Derivations (the reference's, unchanged; see its module docstring):

* **Heavy tags** — :func:`repro_torch.analysis.regions.tag_heavy` over
  each workload's prefill/decode timelines (share + density criterion).
* **Frequency levels** — the Xeon Gold 6130 license drops (2.8 -> 2.4 ->
  1.9 GHz) scaled by the prefill's heavy time share (L1) and its
  tensor-class time share against a 0.40 reference density (L2).
* **Scenario parameters** — per-family serving shapes with the Poisson
  rate set to the reference replay cell's prefill-token load, and
  cube-root-compressed simulator cycle scaling against qwen1.5-0.5b.

The shares differ from the reference's because the machine model does:
on the H100 vector work runs at 67/989 of the tensor-core rate, against
1/50 on the TPU, and attention is one kernel op whose bytes are its
operands and result, not the S^2 intermediates of a pure-JAX attention.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.analysis.costs import CostConfig
from repro_torch.analysis.differential import FLOPS_REL_TOL, differential
from repro_torch.analysis.regions import (MachineModel, RegionTimeline,
                                          segment, tag_heavy)

DERIVED_CUDA_PATH = Path(__file__).with_name("derived_cuda.json")

CALIB_PROMPT = 2048          # representative serving prompt (tokens)
REF_ARCH = "qwen1.5-0.5b"

# the kernel suite's shapes, the reference's (its calibrate.py:153-166,
# :288-299), all attention in fp32; chip_smoke.py holds each kernel
# against its plain version at these shapes
TIMELINE_CHACHA20_BLOCKS = 256
TIMELINE_ATTENTION_SHAPE = (1, 8, 512, 64)   # q = k = v [B,H,S,D], causal
TIMELINE_DECODE_SHAPE = (1, 8, 1024, 64)     # cache [B,KVH,S,D], q [B,H,D],
#                                              lengths S
DIFF_CHACHA20_BLOCKS = 64
DIFF_ATTENTION_SHAPE = (1, 4, 256, 64)       # q = k = v [B,H,S,D], causal
DIFF_PROMPT = 64             # the reduced-config model differential's prompt

# the reference replay cell's calibrated operating point (steady):
# 3.2 req/s x U(1024,3072) prompts — every derived scenario matches
# this prefill-token load so the matrix gates stay meaningful
TARGET_PREFILL_TOK_PER_S = 3.2 * 2048.0

# Xeon Gold 6130 license drops (paper tbl: 2.8 -> 2.4 -> 1.9 GHz)
F0_GHZ = 2.8
L1_DROP = 1.0 - 2.4 / 2.8       # 14.3%
L2_EXTRA_DROP = 1.0 - 1.9 / 2.4  # additional 20.8% below f1
FULL_DENSITY = 0.85             # heavy time share for the full L1 drop
MXU_REF_SHARE = 0.40            # MXU time share for the full L2 drop

# trace-replay cycle costs of the reference arch (core/workloads.py)
REF_PREFILL_CYCLES = 205.0
REF_DECODE_CYCLES = 6_000.0

# per-family serving shapes: (prompt dist, output dist) component dicts
# in sched.workload's registry format ({"kind": ..., **params})
FAMILY_PROFILES: Dict[str, Tuple[Dict, Dict]] = {
    # chat/code assistants: mid prompts, zipf-tailed generations
    "dense": ({"kind": "lognormal", "median": 1400.0, "sigma": 0.65,
               "lo": 256, "hi": 6144},
              {"kind": "zipf", "alpha": 1.5, "lo": 32, "hi": 224}),
    # early-fusion VLM: image-token prompts are long and tight
    "vlm": ({"kind": "lognormal", "median": 2400.0, "sigma": 0.45,
             "lo": 512, "hi": 8192},
            {"kind": "fixed", "n": 48}),
    # frontier MoE: long analytic prompts, fixed-ish generations
    "moe": ({"kind": "lognormal", "median": 2800.0, "sigma": 0.6,
             "lo": 512, "hi": 8192},
            {"kind": "fixed", "n": 64}),
    # sub-quadratic backbones serve the long-context tier
    "hybrid": ({"kind": "lognormal", "median": 3200.0, "sigma": 0.8,
                "lo": 512, "hi": 8192},
               {"kind": "uniform", "lo": 32, "hi": 96}),
    "ssm": ({"kind": "lognormal", "median": 3200.0, "sigma": 0.8,
             "lo": 512, "hi": 8192},
            {"kind": "uniform", "lo": 32, "hi": 96}),
    # speech-to-text: fixed encoder frames, uniform transcripts
    "audio": ({"kind": "fixed", "n": 1500},
              {"kind": "uniform", "lo": 48, "hi": 160}),
}

# reduced-config archs the static-vs-counter differential runs; the
# reference's third, rwkv6-3b, waits for its family (ROADMAP queue 1,
# item 7)
DIFFERENTIAL_ARCHS = ("qwen1.5-0.5b", "stablelm-12b")

# documented known divergence: FlopCounterMode counts matrix products,
# and chacha20 is integer add/xor/rotate work it does not count, so the
# counter reports 0 against the static 1,616 ops a block. Recorded with
# agrees=false, reported in the table, but not a calibration failure.
KNOWN_DIVERGENT = {"chacha20"}


def _mean_len(dist: Dict) -> float:
    k = dist["kind"]
    if k == "fixed":
        return float(dist["n"])
    if k == "uniform":
        return (dist["lo"] + dist["hi"]) / 2.0
    if k == "lognormal":
        m = dist["median"] * math.exp(dist["sigma"] ** 2 / 2.0)
        return min(max(m, dist["lo"]), dist["hi"])
    if k == "zipf":
        return dist["lo"] + 12.0          # rough zipf(1.5) tail mean
    raise ValueError(k)


def _clamp(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


# ------------------------------------------------------------ timelines


def kernel_timelines(machine: MachineModel = MachineModel(),
                     device="cuda") -> List[RegionTimeline]:
    """The kernel suite at the reference's shapes, run on ``device``:
    chacha20 is the paper's SSL-library analogue (pure integer vector
    work, no tensor cores), the attention kernels the tensor class."""
    from repro_torch.kernels.ops import (chacha20_keystream, flash_attention,
                                         flash_decode)
    dev = torch.device(device)
    # u32 words made through int32 views: torch has no u32 fill on CUDA
    key = torch.zeros(8, dtype=torch.int32, device=dev).view(torch.uint32)
    nonce = torch.zeros(3, dtype=torch.int32, device=dev).view(torch.uint32)
    q = torch.zeros(TIMELINE_ATTENTION_SHAPE, device=dev)
    B, H, S, D = TIMELINE_DECODE_SHAPE
    kv = torch.zeros((B, H, S, D), device=dev)
    qd = torch.zeros((B, H, D), device=dev)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    return [
        segment(lambda k, n: chacha20_keystream(
            k, n, 1, TIMELINE_CHACHA20_BLOCKS), key, nonce,
                name="chacha20", machine=machine),
        segment(lambda a, b, c: flash_attention(a, b, c), q, q, q,
                name="flash_attention", machine=machine),
        segment(lambda a, b, c, l: flash_decode(a, b, c, l), qd, kv, kv,
                lens, name="flash_decode", machine=machine),
    ]


class _CalibShape:
    """Minimal ShapeConfig stand-in for model.input_specs."""

    def __init__(self, seq_len: int, kind: str, batch: int = 1):
        self.name = f"calib_{kind}"
        self.seq_len = seq_len
        self.global_batch = batch
        self.kind = kind


def model_timelines(arch: str, prompt: int = CALIB_PROMPT,
                    machine: MachineModel = MachineModel(),
                    reduced: bool = False) -> Dict[str, RegionTimeline]:
    """One architecture's prefill and decode entrypoints at full (or
    ``reduced``) config, traced on the meta device, where nothing is
    materialized: parameters from ``abstract_params``, inputs from
    ``input_specs``."""
    from repro_torch.configs import get_arch

    acfg = get_arch(arch)
    if reduced:
        acfg = acfg.reduced()
    return config_timelines(acfg, prompt, machine=machine)


def config_timelines(acfg, prompt: int, *, batch: int = 1,
                     max_seq: Optional[int] = None,
                     machine: MachineModel = MachineModel()
                     ) -> Dict[str, RegionTimeline]:
    """The prefill and decode entrypoints of the model ``acfg`` describes
    (:func:`entrypoints`), each segmented into a timeline."""
    return {name: segment(fn, *args, name=name, machine=machine)
            for name, (fn, args) in entrypoints(
                acfg, prompt, batch=batch, max_seq=max_seq).items()}


def entrypoints(acfg, prompt: int, *, batch: int = 1,
                max_seq: Optional[int] = None
                ) -> Dict[str, Tuple[Callable, tuple]]:
    """``{"prefill": (fn, args), "decode_step": (fn, args)}`` of the model
    ``acfg`` describes, on the meta device: a ``batch`` x ``prompt``
    prefill into a ``max_seq`` cache (default ``prompt + 128``) and one
    decode step at length ``prompt``."""
    from repro_torch.models.api import build_model

    model = build_model(acfg, "meta")
    params = model.abstract_params()
    pre_in = model.input_specs(_CalibShape(prompt, "prefill", batch))
    dec_in = model.input_specs(_CalibShape(prompt, "decode", batch))
    max_seq = max_seq or prompt + 128

    def prefill(p, b):
        cache = model.init_cache(p, b, batch, max_seq)
        return model.prefill(p, b, cache)

    def decode_step(p, c, t, l):
        return model.decode_step(p, c, t, l)

    cache = model.init_cache(params, pre_in, batch, max_seq)
    return {"prefill": (prefill, (params, pre_in)),
            "decode_step": (decode_step, (params, cache, dec_in["tokens"],
                                          dec_in["lengths"]))}


# ------------------------------------------------------------ deriving


def derive_freq_levels(prefill: RegionTimeline) -> List[float]:
    """(f0, f1, f2) GHz from measured wide-vector densities (see module
    docstring). Strictly decreasing by construction."""
    heavy_time_share = prefill.heavy_share
    mxu_time_share = prefill.level_share(2)
    f1 = F0_GHZ * (1.0 - L1_DROP * _clamp(heavy_time_share / FULL_DENSITY,
                                          0.0, 1.0))
    f2 = f1 * (1.0 - L2_EXTRA_DROP * _clamp(mxu_time_share / MXU_REF_SHARE,
                                            0.0, 1.0))
    f1 = min(f1, F0_GHZ - 0.05)
    f2 = min(f2, f1 - 0.05)
    return [round(F0_GHZ, 3), round(f1, 3), round(f2, 3)]


def derive_scenario(family: str, prefill: RegionTimeline,
                    decode: RegionTimeline,
                    ref_prefill_flops_per_tok: float,
                    ref_decode_flops: float,
                    prompt: int = CALIB_PROMPT) -> Dict:
    prompt_dist, output_dist = FAMILY_PROFILES[family]
    rate = TARGET_PREFILL_TOK_PER_S / _mean_len(prompt_dist)
    pre_ratio = (prefill.flops / prompt) / ref_prefill_flops_per_tok \
        if ref_prefill_flops_per_tok else 1.0
    dec_ratio = decode.flops / ref_decode_flops if ref_decode_flops else 1.0
    pre_scale = _clamp(pre_ratio ** (1.0 / 3.0), 0.5, 2.0)
    dec_scale = _clamp(dec_ratio ** (1.0 / 3.0), 0.5, 2.0)
    return {
        "rate_per_s": round(rate, 3),
        "prompt": prompt_dist,
        "output": output_dist,
        "sim_work": {
            "prefill_cycles_per_tok": round(REF_PREFILL_CYCLES * pre_scale,
                                            2),
            "decode_cycles_per_tok": round(REF_DECODE_CYCLES * dec_scale, 2),
        },
        "flops_ratio_prefill": round(pre_ratio, 4),
        "flops_ratio_decode": round(dec_ratio, 4),
    }


def _timeline_summary(tl: RegionTimeline, per_tok: Optional[int] = None
                      ) -> Dict:
    out = {
        "n_regions": len(tl.regions),
        "est_us": round(tl.est_us, 3),
        "flops": tl.flops,
        "mxu_flops": tl.mxu_flops,
        "bytes": tl.bytes,
        "heavy_share": round(tl.heavy_share, 4),
        "vpu_share": round(tl.level_share(1), 4),
        "mxu_share": round(tl.level_share(2), 4),
        "warnings": list(tl.warnings),
    }
    if per_tok:
        out["flops_per_tok"] = tl.flops / per_tok
    return out


# --------------------------------------------------------- full pipeline


def _kernel_differentials(tol: float, device="cuda"
                          ) -> Dict[str, Optional[Dict]]:
    from repro_torch.kernels.ops import chacha20_keystream, flash_attention

    dev = torch.device(device)
    key = torch.arange(8, dtype=torch.int32, device=dev).view(torch.uint32)
    nonce = torch.zeros(3, dtype=torch.int32, device=dev).view(torch.uint32)
    q = torch.zeros(DIFF_ATTENTION_SHAPE, device=dev)
    out = {}
    d = differential(lambda k, n: chacha20_keystream(
        k, n, 1, DIFF_CHACHA20_BLOCKS), key, nonce, name="chacha20", tol=tol)
    out["chacha20"] = d.to_dict()
    d = differential(lambda a, b, c: flash_attention(a, b, c), q, q, q,
                     name="flash_attention", tol=tol)
    out["flash_attention"] = d.to_dict()
    return out


def _model_differential(arch: str, tol: float, device="cuda") -> Dict:
    """Static vs counter on the reduced config at prompt ``DIFF_PROMPT``
    (the shape the reference's differential compiles), run on
    ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    model = build_model(get_arch(arch).reduced(), device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    batch = {"tokens": torch.zeros((1, DIFF_PROMPT), dtype=torch.int32,
                                   device=model.device)}

    def prefill(p, b):
        cache = model.init_cache(p, b, 1, 2 * DIFF_PROMPT)
        return model.prefill(p, b, cache)

    return differential(prefill, params, batch, name=f"{arch}/prefill",
                        tol=tol).to_dict()


def ported_archs() -> Tuple[List[str], Dict[str, str]]:
    """(archs whose family the port builds, {other arch: the ROADMAP item
    that ports it})."""
    from repro_torch.configs import arch_ids, get_arch
    from repro_torch.models.api import FAMILIES, LATER_SLICES

    ported, skipped = [], {}
    for arch in arch_ids():
        family = get_arch(arch).family
        if family in FAMILIES:
            ported.append(arch)
        else:
            skipped[arch] = LATER_SLICES.get(family, "a later slice")
    return ported, skipped


def run_calibration(archs: Optional[List[str]] = None,
                    with_differential: bool = True,
                    tol: float = FLOPS_REL_TOL,
                    device="cuda") -> Dict:
    from repro_torch.configs import get_arch

    dev = resolve_device(str(device))
    machine = MachineModel()
    ported, skipped = ported_archs()
    archs = [a for a in (archs or ported) if a in ported]

    kernels: Dict[str, Dict] = {}
    for tl in kernel_timelines(machine, dev):
        kernels[tl.name] = _timeline_summary(tl)
        kernels[tl.name]["tags"] = tag_heavy([tl])
    if with_differential:
        for name, d in _kernel_differentials(tol, dev).items():
            if name in kernels:
                kernels[name]["differential"] = d

    ref_tls = model_timelines(REF_ARCH, machine=machine)
    ref_pre_flops_tok = ref_tls["prefill"].flops / CALIB_PROMPT
    ref_dec_flops = ref_tls["decode_step"].flops

    workloads: Dict[str, Dict] = {}
    for arch in archs:
        family = get_arch(arch).family
        tls = ref_tls if arch == REF_ARCH \
            else model_timelines(arch, machine=machine)
        pre, dec = tls["prefill"], tls["decode_step"]
        entry = {
            "family": family,
            "prefill": _timeline_summary(pre, per_tok=CALIB_PROMPT),
            "decode_step": _timeline_summary(dec),
            "tags": tag_heavy([pre, dec]),
            "freq": {
                "levels_ghz": derive_freq_levels(pre),
                "grant_delay_ms": 0.5,
                "hysteresis_ms": 2.0,
            },
            "scenario": derive_scenario(family, pre, dec,
                                        ref_pre_flops_tok, ref_dec_flops),
        }
        if with_differential and arch in DIFFERENTIAL_ARCHS:
            entry["differential"] = _model_differential(arch, tol, dev)
        workloads[arch] = entry

    return {
        "version": 1,
        "generated_by": "PYTHONPATH=src python -m "
                        "repro_torch.analysis.calibrate --update",
        "calib_prompt": CALIB_PROMPT,
        "flops_rel_tol": tol,
        "assumed_while_trips": CostConfig().assumed_while_trips,
        "machine": machine.to_dict(),
        "reference": {"arch": REF_ARCH,
                      "prefill_flops_per_tok": ref_pre_flops_tok,
                      "decode_flops": ref_dec_flops},
        "kernels": kernels,
        "workloads": workloads,
        "skipped": {a: f"family {get_arch(a).family!r} is not ported yet; "
                       f"it comes with {item}"
                    for a, item in skipped.items()},
    }


def _table(data: Dict) -> str:
    lines = [f"{'workload':20s} {'fam':>6s} {'MXU%':>5s} {'f1':>5s} "
             f"{'f2':>5s} {'rate':>5s} {'pre_cyc':>8s} {'tags'}"]
    for arch, w in sorted(data["workloads"].items()):
        f = w["freq"]["levels_ghz"]
        sc = w["scenario"]
        lines.append(
            f"{arch:20s} {w['family']:>6s} "
            f"{100 * w['prefill']['mxu_share']:5.1f} {f[1]:5.2f} "
            f"{f[2]:5.2f} {sc['rate_per_s']:5.2f} "
            f"{sc['sim_work']['prefill_cycles_per_tok']:8.1f} "
            f"{','.join(w['tags'])}")
    lines.append("")
    for name, k in sorted(data["kernels"].items()):
        d = k.get("differential")
        dd = (f"diff rel_err={d['rel_err']:.3f} "
              f"{'OK' if d['agrees'] else 'DIVERGED'}") if d else ""
        lines.append(f"{name:20s} {'':>6s} {100 * k['mxu_share']:5.1f} "
                     f"heavy={k['heavy_share']:.2f} est={k['est_us']:.1f}us "
                     f"{dd}")
    for arch, w in sorted(data["workloads"].items()):
        d = w.get("differential")
        if d:
            lines.append(f"{arch:20s} diff(reduced) "
                         f"rel_err={d['rel_err']:.3f} "
                         f"{'OK' if d['agrees'] else 'DIVERGED'}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--update", action="store_true",
                    help=f"rewrite {DERIVED_CUDA_PATH}")
    ap.add_argument("--no-differential", action="store_true",
                    help="skip the static-vs-counter flop checks")
    ap.add_argument("--out", default=None,
                    help="also write the full JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cuda, or cpu for their "
                         "plain versions)")
    args = ap.parse_args(argv)

    data = run_calibration(with_differential=not args.no_differential,
                           device=args.device)
    print(_table(data))
    if data["skipped"]:
        print(f"\nskipped (not ported yet): {', '.join(data['skipped'])}")
    diverged = [
        n for n, k in list(data["kernels"].items())
        + list(data["workloads"].items())
        if k.get("differential") and not k["differential"]["agrees"]
        and n not in KNOWN_DIVERGENT]
    if diverged:
        print(f"\nstatic-vs-counter DIVERGED beyond tol: {diverged}",
              file=sys.stderr)
    text = json.dumps(data, indent=1, sort_keys=True) + "\n"
    if args.update:
        DERIVED_CUDA_PATH.write_text(text)
        print(f"\nwrote {DERIVED_CUDA_PATH}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 1 if diverged else 0


if __name__ == "__main__":
    raise SystemExit(main())
