"""Multi-rank dry-run: trace every (arch x shape x mesh) cell as rank 0 of
a fake world and record its per-rank cost (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for a 256- or
512-device mesh of placeholder devices and reads XLA's memory and cost
analyses. The port runs the step itself, on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no data, no memory) as
rank 0 of a fake world (``launch.mesh.fake_world``: the ``fake`` backend,
whose collectives move nothing), and counts what it runs
(``roofline.op_cost.CostCounter``): flops, bytes, collectives with their
groups, and the live bytes of the storages it makes. Every rank runs the
same program on its own rows and shards (``train.loop``: the transformer
family tensor-parallel over ``model``, the others gathering on use), so
rank 0's counts are every rank's.

  * ``single`` = (16, 16) ("data", "model") over 256 ranks, ``multi`` =
    (2, 16, 16) ("pod", "data", "model") over 512, ``test`` = (2, 4) over
    8: the reference's meshes.
  * ``--device cuda`` (the default) traces the card's program without a
    card: fake CUDA tensors (fake ``meta`` ones on a torch built without
    CUDA, ``trace_device``) reach the port's kernels as their custom ops'
    fake implementations and the bf16 logits through ``_Fp32Logits``, as
    on the H100. ``--device cpu`` traces the CPU's program (the bf16
    logits widened to fp32 first).
  * train cells trace the sharded ``make_train_step`` with the
    reference's ``grad_accum``; above two microbatches the step is traced
    at two and at three, and the costs are extended linearly (every
    microbatch runs the same ops on the same shapes; ``extrapolate``),
    which equals tracing every one. Prefill and decode cells trace
    ``make_serve_steps`` with the cache resting in ``cache_specs``.

Each cell's result has the reference's keys (``status``, ``error``,
``trace``, ``chips``, ``total_s``, ``memory``, ``collectives``,
``roofline``); ``trace_s`` takes the place of ``compile_s`` and
``flop_counter`` of ``xla_cost``: ``FlopCounterMode``'s flops over the
same trace, a second count (``analysis.differential``). ``memory``:
``argument_size_in_bytes`` is this rank's state shards (parameters and
optimizer state, or parameters and cache) and its share of the inputs;
``output_size_in_bytes`` what the step returns; ``temp_size_in_bytes``
the most bytes that storages made during the step held at once.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import differential  # noqa: F401  (flop formulas)
from repro_torch.bridge import flatten, unflatten
from repro_torch.configs import SHAPES, all_cells, get_arch, get_shape
from repro_torch.configs.registry import cell_is_runnable
from repro_torch.dist.context import make_dist, no_dist
from repro_torch.dist.sharding import (Placement, axis_size, map_with_specs,
                                       sanitize_spec)
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models.api import build_model
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_cost import CostCounter, CostTotals
from repro_torch.train.loop import (cache_shardings, make_serve_steps,
                                    make_train_step, param_shardings,
                                    seq_cache_leaves, train_state_shardings)
from repro_torch.train.optimizer import OptConfig, init_opt_state

# tokens-per-device memory pressure -> grad accumulation (the reference's;
# the batch is unchanged, microbatches run one after another)
GRAD_ACCUM = {
    "chameleon-34b": 8,
    "codeqwen1.5-7b": 4,
    "qwen1.5-0.5b": 1,
    "stablelm-12b": 4,
    "starcoder2-15b": 4,
    "zamba2-2.7b": 1,
    "deepseek-v3-671b": 16,
    "grok-1-314b": 8,
    "whisper-large-v3": 2,
    "rwkv6-3b": 1,
}

DIST_KEYS = ("fsdp", "seq_parallel", "ep_over_dp", "zero1")

MESHES = {"single": 256, "multi": 512, "test": 8}


def _mesh(kind: str, device):
    if kind == "single":
        return make_production_mesh(multi_pod=False, device=device)
    if kind == "multi":
        return make_production_mesh(multi_pod=True, device=device)
    return make_test_mesh(device=device)


def _opt_cfg(arch: str) -> OptConfig:
    big = arch in ("deepseek-v3-671b", "grok-1-314b")
    return OptConfig(state_dtype="bfloat16" if big else "float32")


# ------------------------------------------------------------ the device


def trace_device(device) -> torch.device:
    """The device of a trace's fake tensors. A torch built without CUDA
    has no device guard for CUDA, which Python indexing and autograd
    take, so there fake ``meta`` tensors stand in for CUDA ones: every
    device branch of the port asks only whether a tensor lies on the CPU
    (``layers.unembed``), and the kernels' custom ops reach their fake
    implementations on both, so the traced program is the card's."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("meta")
    return device


# ------------------------------------------------------------- the trace


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _local_shape(a, placement) -> tuple:
    shape = list(a.shape)
    for d, axes in placement.dims:
        shape[d] //= axis_size(placement.mesh, axes)
    return tuple(shape)


def _shards(abstract, placements, device):
    """Fake tensors of this rank's shards of ``abstract``'s leaves."""
    return map_with_specs(
        lambda a, pl: _empty(_local_shape(a, pl), a.dtype, device),
        abstract, placements)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


@dataclasses.dataclass
class Trace:
    """What one traced call gave: its costs, ``FlopCounterMode``'s flops,
    the peak of the bytes it allocated, and its result."""
    totals: CostTotals
    counter_flops: float
    peak_bytes: int
    result: object = None


def _run(fn, *args) -> Trace:
    with FlopCounterMode(display=False) as fc, CostCounter() as cc:
        result = fn(*args)
    return Trace(cc.totals, float(fc.get_total_flops()), cc.peak_bytes,
                 result)


def extrapolate(t2: Trace, t3: Trace, n: int) -> Trace:
    """The trace of ``n`` microbatches from those of two and three: the
    rest of the step once, each microbatch's ops n times (every cost is
    linear in the microbatch count). The peak is the three-microbatch
    trace's: each later microbatch holds the same bytes at its peak."""
    totals = CostTotals()
    totals.add(t2.totals, 3 - n)
    totals.add(t3.totals, n - 2)
    return Trace(totals, t2.counter_flops * (3 - n)
                 + t3.counter_flops * (n - 2), t3.peak_bytes, t3.result)


def _train_trace(model, opt_cfg, ga, specs, state, batch) -> Trace:
    def at(n):
        rows = batch["tokens"].shape[0] // ga * n
        cut = {k: v[:rows] for k, v in batch.items()}
        step = make_train_step(model, opt_cfg, grad_accum=n,
                               batch_specs=specs)
        return _run(step, state, cut)
    if ga <= 3:
        return at(ga)
    return extrapolate(at(2), at(3), ga)


def trace_cell(cfg, shape, mesh_kind=None, dist_kw=None, grad_accum=1,
               device="cuda", opt_cfg: OptConfig = OptConfig()):
    """Returns (trace, meta) for ``cfg`` at ``shape``, traced as rank 0 of
    a fake world of the mesh's size, or on one device without a world
    when ``mesh_kind`` is None. ``dist_kw``: ``make_dist``'s knobs."""
    world = MESHES[mesh_kind] if mesh_kind else 1
    with fake_world(world) if mesh_kind else contextlib.nullcontext():
        if mesh_kind:
            mesh = _mesh(mesh_kind, trace_device(device))
            dist, dev = make_dist(mesh, **(dist_kw or {})), mesh.device
        else:
            mesh, dist, dev = None, no_dist(), trace_device(device)
        model = build_model(cfg, dev, dist)
        abstract = model.abstract_params()
        specs = model.batch_specs(shape)
        # fake tensors; tensors made before, meta ones included, taken as fake
        with FakeTensorMode(allow_non_fake_inputs=True):
            inputs = {k: _empty(v.shape, v.dtype, dev)
                      for k, v in model.input_specs(shape).items()}
            t0 = time.time()
            seq_leaves = set()
            if shape.kind == "train":
                state = _shards(
                    {"params": abstract,
                     "opt": init_opt_state(abstract, opt_cfg)},
                    train_state_shardings(model, opt_cfg), dev)
                args = _nbytes(state)
                tr = _train_trace(model, opt_cfg, grad_accum, specs, state,
                                  inputs)
            else:
                full = unflatten({k: _empty(v.shape, v.dtype, dev)
                                  for k, v in flatten(abstract).items()})
                cache_like = model.init_cache(full, inputs,
                                              shape.global_batch,
                                              shape.seq_len)
                del full
                cache = _shards(cache_like,
                                cache_shardings(model, cache_like), dev)
                params = _shards(abstract, param_shardings(model), dev)
                prefill, decode = make_serve_steps(model, cache_like)
                seq_leaves = seq_cache_leaves(model, cache_like)
                args = _nbytes(params) + _nbytes(cache)
                if shape.kind == "prefill":
                    tr = _run(prefill, params, inputs, cache)
                else:
                    tr = _run(decode, params, cache, inputs["tokens"],
                              inputs["lengths"])
            trace_s = time.time() - t0
            # this rank's share of the inputs, as their sanitized specs
            # split them
            split = {k: Placement(mesh, sanitize_spec(
                specs[k], tuple(t.shape), mesh)) for k, t in inputs.items()}
            args += sum(math.prod(_local_shape(t, split[k]))
                        * t.element_size() for k, t in inputs.items())
            # the ranks that compute the same rows: those that split the
            # rows compute distinct work, and so do the ranks of the model
            # axis where a plan splits leaves over it (the transformer
            # family's and whisper's tensor parallelism) or the step
            # attends over a cache sharded over it on its sequence (the
            # hybrid's decode: the attention over a long cache is most of
            # its work, its Mamba2 layers the same on every rank); gather
            # on use computes each share of the rows on every rank of the
            # other axes
            row_axes = {a for _, axes in split["tokens"].dims for a in axes}
            split_ranks = axis_size(mesh, tuple(row_axes))
            plan = model.plan()
            if dist.active and dist.model_axis not in row_axes and (
                    model.per_layer_gathers and plan is not None
                    and plan.splits or seq_leaves):
                split_ranks *= dist.model_size
            replicas = world // split_ranks
            out = sum(t.numel() * t.element_size()
                      for t in tree_leaves(tr.result)
                      if isinstance(t, torch.Tensor))
    return tr, {"mesh_devices": world,
                "trace_s": trace_s, "traced_on": str(dev.type),
                "replicas": replicas,
                "shape": shape, "cfg": cfg,
                "memory": {"argument_size_in_bytes": int(args),
                           "output_size_in_bytes": int(out),
                           "temp_size_in_bytes": int(tr.peak_bytes)}}


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None, device="cuda"):
    """Returns (trace, meta) for one cell of the registry.

    overrides: ArchConfig fields, plus DistContext knobs (fsdp,
    seq_parallel, ep_over_dp, zero1) and 'grad_accum'."""
    overrides = dict(overrides or {})
    dist_kw = {k: overrides.pop(k) for k in DIST_KEYS if k in overrides}
    ga = overrides.pop("grad_accum", GRAD_ACCUM[arch])
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return trace_cell(cfg, get_shape(shape_name), mesh_kind, dist_kw, ga,
                      device, _opt_cfg(arch))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, device="cuda") -> dict:
    t0 = time.time()
    try:
        tr, meta = lower_cell(arch, shape_name, mesh_kind, overrides, device)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    cfg, shape = meta["cfg"], meta["shape"]
    opt_b = 4 if arch in ("deepseek-v3-671b", "grok-1-314b") else 8
    floor = roofline.memory_floor_bytes(cfg, shape, meta["mesh_devices"],
                                        meta["mesh_devices"],
                                        opt_bytes_per_param=opt_b)
    rf = roofline.summarize(arch, shape_name, mesh_kind,
                            meta["mesh_devices"], tr.totals,
                            roofline.model_flops(cfg, shape),
                            floor_bytes=floor)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok",
        "chips": meta["mesh_devices"],
        "device": str(torch.device(device).type),
        "traced_on": meta["traced_on"],
        "replicas": meta["replicas"],
        "trace_s": round(meta["trace_s"], 1),
        "total_s": round(time.time() - t0, 1),
        "memory": meta["memory"],
        "flop_counter": {"flops": tr.counter_flops},
        "collectives": tr.totals.to_dict(),
        "roofline": rf.to_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "test"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (no card needed)")
    ap.add_argument("--out", default="results/dryrun_cuda.json")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s, runnable in all_cells() if runnable]
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s) for s in shapes
                 if cell_is_runnable(get_arch(args.arch), get_shape(s))]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    for mesh_kind in meshes:
        for arch, shape_name in cells:
            key = f"{arch}|{shape_name}|{mesh_kind}"
            if results.get(key, {}).get("status") == "ok":
                print(f"[skip cached] {key}")
                continue
            print(f"[dry-run] {key} ...", flush=True)
            res = run_cell(arch, shape_name, mesh_kind, device=args.device)
            results[key] = res
            out_path.write_text(json.dumps(results, indent=1))
            st = res["status"]
            extra = (f" trace={res['trace_s']}s "
                     f"flops/dev={res['roofline']['hlo_gflops']:.1f}G "
                     f"bottleneck={res['roofline']['bottleneck']}"
                     if st == "ok" else res.get("error", ""))
            print(f"  -> {st}{extra}", flush=True)

    bad = [k for k, v in results.items() if v.get("status") != "ok"]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells ok")
    for k in bad:
        print("FAILED:", k, results[k].get("error"))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
