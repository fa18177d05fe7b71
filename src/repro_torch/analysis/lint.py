"""Intermittency lint over the kernel suite and the model zoo (port of
``repro.analysis.lint``).

  PYTHONPATH=src python -m repro_torch.analysis.lint                  # on the GPU
  PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu
  PYTHONPATH=src python -m repro_torch.analysis.lint --json out.json
  PYTHONPATH=src python -m repro_torch.analysis.lint --check-baseline
  PYTHONPATH=src python -m repro_torch.analysis.lint --update-baseline

It runs on the card by default (``--device cuda``; it raises without a GPU
unless ``--device cpu`` is given): the kernel suite
(``calibrate.kernel_timelines``) runs the port's three kernels there. The
model zoo is all ten archs at their published configs, traced on the
meta device (``calibrate.entrypoints``); ``"skipped"`` lists any arch
whose family the port does not build, as calibration does (none).

Two finding kinds, both ranked by severity, as in the reference:

* ``license-thrash`` — a region that runs at a *higher* level than both
  its neighbours and whose per-trip duration is shorter than the 2 ms
  relicense hysteresis of the core frequency domain. Severity = trips x
  (hysteresis - per_trip_us): a short heavy body inside a layer loop
  thrashes once per trip.

* ``untagged-heavy-entrypoint`` — an entrypoint the analyzer tags heavy
  *today* that is missing from the tag set of the artifact serving reads
  (``derived.json``, through ``analysis.derived``): serve would run it
  untagged (no license pre-grant, detect-then-throttle).

**Layer folding.** The reference walks a model's layer ``scan`` once, so
a per-layer region appears once with ``trips = L``. The port runs its
layers as a Python loop, and the recorded op stream holds L copies of
each layer's ops. Before scoring, :func:`fold_layers` finds the run of L
identical consecutive op subsequences (same op names and costs) in the
stream and segments prologue ops at trips 1, one layer's ops at trips L
and epilogue ops at trips 1, merging leaves only at equal level and
equal trips, as the reference's segmentation does. The hybrid nests its
repeats (:func:`fold_counts`): 9 groups, each 6 Mamba2 layers and the
shared block, and in prefill an SSD chunk loop inside each layer; they
fold level by level (:func:`fold_parts`) to the reference's trips, 9 for
the shared block, 54 for a layer and 54 x chunks for the chunk loop's
body. RWKV6's prefill nests its WKV chunk loop in each layer, at the
port's blocks (``rwkv6.wkv_block_len``: 64 of 32 positions a layer at a
2,048-token prompt, where the reference's 16 chunks of 128 overflow), so
its body folds to 32 x 64 = 2,048 trips where the reference has 512.
The encoder-decoder runs its stacks one after another, each of
``n_layers`` repeats (prefill: the encoder in ``init_cache``, the
cross-K/V of each decoder layer, the encoder again and the decoder;
:func:`fold_runs`), and each folds, at the trips around it. A stream
with no such run (the kernel suite) is segmented as it is. Calibration
does not fold: its artifact, ``derived_cuda.json``,
stays as ``segment`` gives it.

``--check-baseline`` keeps the reference's rules: it fails when the
findings drift from the committed ``lint_baseline_cuda.json`` and on any
untagged-heavy finding. ``--update-baseline`` rewrites that file, never
the reference's ``lint_baseline.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.costs import EqnCost
from repro_torch.analysis.regions import (FOLD_FRAC, MachineModel,
                                          RegionTimeline, _Builder, _fold,
                                          record)

BASELINE_PATH = Path(__file__).with_name("lint_baseline_cuda.json")

# core-domain relicense hysteresis (µs) — sched.freq CORE_FREQ default
HYSTERESIS_US = 2000.0


@dataclass
class Finding:
    kind: str                 # "license-thrash" | "untagged-heavy-entrypoint"
    workload: str             # "zoo/<arch>" | "kernel"
    entrypoint: str
    severity: float
    detail: str
    region: Optional[Dict] = field(default=None)

    def to_dict(self) -> Dict:
        d = {"kind": self.kind, "workload": self.workload,
             "entrypoint": self.entrypoint,
             "severity": round(self.severity, 3), "detail": self.detail}
        if self.region is not None:
            d["region"] = self.region
        return d


# ------------------------------------------------------- layer folding


def layer_run(keys: Sequence, n_layers: int) -> Optional[Tuple[int, int]]:
    """``(start, period)`` of the run of ``n_layers`` identical consecutive
    subsequences of ``keys`` that covers the most of it (earliest start
    on a tie), or None. A period found this way is a whole layer: a
    shorter repeat inside a layer cannot repeat ``n_layers`` times across
    layers unless the layer itself does.

    The keys are numbered once (equal keys, equal numbers) and compared in
    place, a period at a time: a run of period p needs ``span = (n_layers -
    1) p`` consecutive positions i with ``keys[i] == keys[i + p]``. Every
    such window holds one multiple of ``span``, so a period whose sampled
    positions ``0, span, 2 span, ...`` all differ is passed over after
    ``n / span`` compares; the search over a stream with no run costs
    O(n log n), not the cubic time of comparing slices."""
    n = len(keys)
    if n_layers < 2:
        return None
    ids: Dict = {}
    arr = np.fromiter((ids.setdefault(k, len(ids)) for k in keys),
                      dtype=np.int64, count=n)
    for period in range(n // n_layers, 0, -1):
        span = (n_layers - 1) * period
        m = n - period                  # positions i with i + period < n
        if not (arr[0:m:span] == arr[period::span]).any():
            continue
        differ = np.flatnonzero(arr[:m] != arr[period:])
        edges = np.concatenate(([-1], differ, [m]))
        runs = np.flatnonzero(np.diff(edges) - 1 >= span)
        if runs.size:
            return int(edges[runs[0]]) + 1, period
    return None


def fold_parts(ops: Sequence, counts: Sequence[int],
               runs: int = 1) -> List[Tuple[list, int]]:
    """A stream cut into ``(ops, trips)`` parts in stream order, with
    nested repeats folded: the run of ``counts[0]`` repeats is found in the
    stream (``layer_run``; ``runs`` such runs, where stacks run one after
    another, each the longest period left in what lies around the runs
    found so far), the run of ``counts[1]`` inside one repeat of it, and
    so on, each inner body at the product of the counts around it; what
    lies around a run keeps its outer trips. A level whose run is not
    found leaves its stream as it is."""
    def fold(seq, counts, trips, runs):
        if not counts:
            return [(list(seq), trips)]
        n = counts[0]
        segs = [(list(seq), False)]     # (ops, is one folded repeat)
        for _ in range(runs):
            best = None                 # (segment, start, period)
            for i, (seg, body) in enumerate(segs):
                run = None if body else layer_run(seg, n)
                if run and (best is None or run[1] > best[2]):
                    best = (i, *run)
            if best is None:
                break
            i, start, period = best
            seg = segs[i][0]
            segs[i:i + 1] = [(seg[:start], False),
                             (seg[start:start + period], True),
                             (seg[start + n * period:], False)]
        out: List[Tuple[list, int]] = []
        for seg, body in segs:
            out += fold(seg, counts[1:], trips * n, 1) if body \
                else [(seg, trips)]
        return out
    return fold(ops, tuple(counts), 1, runs)


def fold_counts(cfg, entrypoint: str, prompt: int) -> Tuple[int, ...]:
    """The repeats nested in an entrypoint's op stream, outermost first:
    the layer loop (``n_layers``; the encoder-decoder's two stacks, which
    have one depth in every config, fold at it one after the other); for
    the hybrid the groups, the Mamba2 layers of a group and, in prefill,
    the SSD chunk loop of a layer (``prompt`` / the chunk it runs with);
    for RWKV6's prefill the WKV loop of a layer (``prompt`` / the block
    it runs with). These are the reference's nested scans: its lint walks
    them to the same trips, but for RWKV6's blocks (module docstring)."""
    if cfg.enc_dec is not None and cfg.enc_dec.n_encoder_layers \
            != cfg.n_layers:
        raise ValueError(f"{cfg.name}: encoder and decoder depths differ "
                         f"({cfg.enc_dec.n_encoder_layers}, "
                         f"{cfg.n_layers}); the fold takes one count a "
                         "level")
    if cfg.rwkv is not None:
        from repro_torch.models.rwkv6 import wkv_block_len
        if entrypoint == "prefill":
            return (cfg.n_layers,
                    prompt // wkv_block_len(prompt, cfg.rwkv.chunk))
        return (cfg.n_layers,)
    if cfg.hybrid is None:
        return (cfg.n_layers,)
    from repro_torch.models.hybrid import _groups
    from repro_torch.models.mamba2 import _chunk_len
    counts = _groups(cfg)
    if entrypoint == "prefill":
        counts += (prompt // _chunk_len(prompt, cfg.ssm.chunk),)
    return counts


def fold_runs(cfg, entrypoint: str) -> int:
    """How many runs of the outer count an entrypoint's stream holds: the
    encoder-decoder's prefill runs the encoder (in ``init_cache``), the
    cross-K/V of each decoder layer, the encoder again and the decoder,
    one after another; every other stream has one layer loop."""
    return 4 if cfg.enc_dec is not None and entrypoint == "prefill" else 1


def fold_layers(ops: List[Tuple[str, EqnCost]], counts: Sequence[int],
                name: str, machine: MachineModel = MachineModel(),
                fold_frac: float = FOLD_FRAC, runs: int = 1
                ) -> RegionTimeline:
    """Segment a recorded op stream (``regions.record``) with its nested
    repeats folded by ``fold_parts`` (``(n_layers,)``: the layer loop's
    repeats of one layer into one body at ``trips = n_layers``; ``runs``
    such loops one after another): the timeline the reference's scan walk
    gives."""
    builder = _Builder(machine)
    for part, trips in fold_parts(ops, counts, runs):
        for prim, cost in part:
            builder.leaf(prim, cost, trips)
        builder.flush()
    return RegionTimeline(name=name,
                          regions=_fold(builder.regions, fold_frac))


def folded_model_timelines(arch: str,
                           machine: MachineModel = MachineModel()
                           ) -> Dict[str, RegionTimeline]:
    """One architecture's prefill and decode entrypoints at its published
    config, as calibration traces them on the meta device, with the layer
    repeats (and the hybrid's nested repeats) folded."""
    from repro_torch.analysis.calibrate import CALIB_PROMPT, entrypoints
    from repro_torch.configs import get_arch

    acfg = get_arch(arch)
    return {name: fold_layers(record(fn, *args),
                              fold_counts(acfg, name, CALIB_PROMPT), name,
                              machine, runs=fold_runs(acfg, name))
            for name, (fn, args) in entrypoints(acfg, CALIB_PROMPT).items()}


# ------------------------------------------------------------- findings


def lint_timeline(tl: RegionTimeline, workload: str,
                  hysteresis_us: float = HYSTERESIS_US) -> List[Finding]:
    """License-thrash candidates in one region timeline."""
    out: List[Finding] = []
    regions = tl.regions
    for i in range(1, len(regions) - 1):
        r = regions[i]
        lo = max(regions[i - 1].level, regions[i + 1].level)
        if r.level <= lo:
            continue
        per_trip = r.per_trip_us
        if per_trip >= hysteresis_us:
            continue
        sev = r.trips * (hysteresis_us - per_trip)
        out.append(Finding(
            kind="license-thrash", workload=workload, entrypoint=tl.name,
            severity=sev,
            detail=(f"{r.unit}-class region ops {r.start_eqn}-{r.end_eqn} "
                    f"runs {per_trip:.1f}us/trip x{r.trips} between "
                    f"{regions[i - 1].unit}/{regions[i + 1].unit} phases — "
                    f"shorter than the {hysteresis_us / 1000:.0f}ms "
                    f"relicense hysteresis"),
            region={"start_eqn": r.start_eqn, "end_eqn": r.end_eqn,
                    "level": r.level, "trips": r.trips,
                    "per_trip_us": round(per_trip, 4)}))
    return out


def untagged_findings(workload: str, fresh_tags: List[str],
                      committed_tags: List[str],
                      heavy_us: Dict[str, float]) -> List[Finding]:
    out = []
    for name in fresh_tags:
        if name in committed_tags:
            continue
        out.append(Finding(
            kind="untagged-heavy-entrypoint", workload=workload,
            entrypoint=name, severity=heavy_us.get(name, 0.0) or 1.0,
            detail=(f"analyzer tags '{name}' heavy but derived.json, "
                    f"which launch.serve reads, does not — serve would "
                    f"run it untagged (detect-then-throttle)")))
    return out


def run_lint(archs: Optional[List[str]] = None, device="cuda") -> Dict:
    """Segment the kernel suite (on ``device``) and the ported zoo (on
    meta, layers folded) and collect all findings, ranked."""
    from repro_torch import resolve_device
    from repro_torch.analysis import derived
    from repro_torch.analysis.calibrate import kernel_timelines, ported_archs
    from repro_torch.analysis.regions import tag_heavy

    dev = resolve_device(str(device))
    machine = MachineModel()
    committed = derived.load()
    findings: List[Finding] = []

    kernel_tls = kernel_timelines(machine, dev)
    kc = committed.get("kernels", {})
    for tl in kernel_tls:
        findings += lint_timeline(tl, "kernel")
    fresh_k = tag_heavy(kernel_tls)
    committed_k = [n for n, k in kc.items() if n in k.get("tags", [])]
    findings += untagged_findings(
        "kernel", fresh_k, committed_k,
        {tl.name: tl.heavy_us for tl in kernel_tls})

    ported, skipped = ported_archs()
    for arch in [a for a in (archs or ported) if a in ported]:
        tls = folded_model_timelines(arch, machine=machine)
        pre, dec = tls["prefill"], tls["decode_step"]
        wl = f"zoo/{arch}"
        findings += lint_timeline(pre, wl) + lint_timeline(dec, wl)
        fresh = tag_heavy([pre, dec])
        committed_tags = committed.get("workloads", {}).get(
            arch, {}).get("tags", [])
        findings += untagged_findings(
            wl, fresh, committed_tags,
            {t.name: t.heavy_us for t in tls.values()})

    findings.sort(key=lambda f: (-f.severity, f.workload, f.entrypoint,
                                 f.kind))
    return {
        "version": 1,
        "hysteresis_us": HYSTERESIS_US,
        "n_findings": len(findings),
        "n_untagged": sum(1 for f in findings
                          if f.kind == "untagged-heavy-entrypoint"),
        "findings": [f.to_dict() for f in findings],
        "skipped": sorted(skipped),
    }


def render(result: Dict) -> str:
    lines = [f"intermittency lint: {result['n_findings']} finding(s) "
             f"({result['n_untagged']} untagged-heavy)",
             f"{'rank':>4s} {'severity':>10s} {'kind':24s} "
             f"{'workload':22s} {'entrypoint':14s} detail"]
    for i, f in enumerate(result["findings"], 1):
        lines.append(f"{i:4d} {f['severity']:10.1f} {f['kind']:24s} "
                     f"{f['workload']:22s} {f['entrypoint']:14s} "
                     f"{f['detail']}")
    if not result["findings"]:
        lines.append("  (clean)")
    if result.get("skipped"):
        lines.append(f"skipped (not ported yet): "
                     f"{', '.join(result['skipped'])}")
    return "\n".join(lines)


def _canon(result: Dict) -> str:
    return json.dumps(result, indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable result here")
    ap.add_argument("--check-baseline", action="store_true",
                    help="exit 1 on drift from the committed baseline or "
                         "on any untagged-heavy-entrypoint finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help=f"rewrite {BASELINE_PATH.name}")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cuda, or cpu for their "
                         "plain versions)")
    args = ap.parse_args(argv)

    result = run_lint(device=args.device)
    print(render(result))
    text = _canon(result)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    if args.update_baseline:
        BASELINE_PATH.write_text(text)
        print(f"\nwrote {BASELINE_PATH}")
        return 0
    if args.check_baseline:
        rc = 0
        if result["n_untagged"]:
            print("\nFAIL: untagged heavy entrypoint(s): the analyzer tags "
                  "them heavy and derived.json, which serving reads, does "
                  "not", file=sys.stderr)
            rc = 1
        try:
            baseline = BASELINE_PATH.read_text()
        except FileNotFoundError:
            print(f"\nFAIL: no committed baseline at {BASELINE_PATH}",
                  file=sys.stderr)
            return 1
        if baseline != text:
            print("\nFAIL: findings drifted from committed baseline — "
                  "fix the regression or re-baseline with "
                  "--update-baseline", file=sys.stderr)
            rc = 1
        return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
