"""The rank side of the port's multi-rank CPU tests, and their launcher.

``launch(case, world, workdir, timeout, **params)`` starts ``world``
processes of this file, each a rank of one gloo group that meets through
a ``file://`` rendezvous in ``workdir`` (no port, so pytest-xdist
workers cannot collide), runs ``CASES[case]`` with ``params`` and writes
its results to ``workdir/<case>.<rank>.npz``; it returns every rank's
results, rank order, and raises with the ranks' output if one fails or
the whole outlasts ``timeout``. Each rank runs one thread (8 ranks a
test, several tests at once). The reference's side of each case runs
separately (``tests/helpers.py::run_with_devices``) and reaches the
ranks as the npz files named in ``params``.

    python tests/torch_dist_ranks.py CASE RANK WORLD WORKDIR
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def launch(case: str, world: int, workdir, timeout: float = 120,
           **params) -> list:
    workdir = Path(workdir)
    (workdir / f"{case}.json").write_text(json.dumps(params))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1)
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{case}: ranks outlasted {timeout}s")
    if any(p.returncode for p in procs):
        raise AssertionError(f"{case}: a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    results = []
    for r in range(world):
        with np.load(workdir / f"{case}.{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


# ------------------------------------------------------------- the ranks


def _flat_np(tree) -> dict:
    from repro_torch.bridge import flatten
    return {k: v.detach().numpy() for k, v in flatten(tree).items()}


def _case_collectives(params, rank):
    import torch
    from repro_torch.dist.collectives import (compressed_allreduce,
                                              hierarchical_allreduce,
                                              quantize_int8)
    from repro_torch.launch.mesh import make_test_mesh
    ref = np.load(params["ref"])
    out = {}
    mesh = make_test_mesh((8,), ("data",))
    g = torch.from_numpy(ref["g"][rank])
    v = g.float()
    out["q"], _ = quantize_int8(v)
    mean, err = compressed_allreduce(g, torch.zeros_like(g),
                                     mesh.group("data"))
    out["mean"], out["err"] = mean, err
    pods = make_test_mesh((2, 4), ("pod", "data"))
    x = torch.from_numpy(ref["x"][rank])
    out["hier"] = hierarchical_allreduce(x, pods.group("pod"),
                                         pods.group("data"), scatter_dim=0)
    return {k: t.numpy() for k, t in out.items()}


def _case_gpipe(params, rank):
    import torch
    from repro_torch.dist.pipeline import gpipe_apply
    from repro_torch.launch.mesh import make_test_mesh
    ref = np.load(params["ref"])
    mesh = make_test_mesh((4,), ("stage",))
    ws, x = torch.from_numpy(ref["ws"]), torch.from_numpy(ref["xp"])
    got = gpipe_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh=mesh,
                      layers_per_stage=ws.shape[0] // 4)
    return {"pipe": got.numpy()}


def moe_variant_cfg(arch: str, variant: dict):
    """The reduced ``arch`` with the variant's MoE fields (the port's)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **variant["moe"]))


def _case_moe(params, rank):
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.dist.context import make_dist
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    ref = np.load(params["ref"])
    mesh = make_test_mesh((2, 4), ("data", "model"))
    routes = []
    route = moe._route

    def recording(x, w, cfg):
        out = route(x, w, cfg)
        routes.append(out[1])
        return out
    moe._route = recording
    out = {}
    for name, v in params["variants"].items():
        cfg = moe_variant_cfg(v["arch"], v)
        dist = make_dist(mesh, ep_over_dp=v["ep_over_dp"])
        flat = {k[len(name) + 1:]: ref[k] for k in ref.files
                if k.startswith(name + "/") and "/ref/" not in k
                and "/local/" not in k}
        full = params_from_jax(flat, "cpu")
        p = params_from_jax(flat, "cpu", tree_shardings(
            dist, full, moe.moe_param_specs(cfg, dist)))
        x = torch.from_numpy(ref["x/" + v["arch"]])
        d = mesh.coords["data"]
        Bd = x.shape[0] // 2
        routes.clear()
        y, aux = moe.moe_block(p, x[d * Bd:(d + 1) * Bd], cfg, dist,
                               dispatch=v["dispatch"])
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/ids"] = routes[0].numpy()
        for k, a in aux.items():
            out[f"{name}/{k}"] = a.detach().numpy()
    return out


def _case_train(params, rank):
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_arch
    from repro_torch.dist.context import make_dist
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import (gather_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    ref = np.load(params["ref"])
    pre = params["name"] + "/"
    mesh = make_test_mesh(tuple(params.get("mesh", (2, 4))),
                          ("data", "model"))
    dist = make_dist(mesh, zero1=params["zero1"])
    cfg = dataclasses.replace(get_arch(params["arch"]).reduced(),
                              **params["over"])
    model = build_model(cfg, "cpu", dist)
    opt = OptConfig(lr=1e-3)
    full = params_from_jax({k[len(pre + "init/"):]: ref[k] for k in ref.files
                            if k.startswith(pre + "init/")}, "cpu")
    state = shard_train_state({"params": full,
                               "opt": init_opt_state(full, opt)}, model, opt)
    step = make_train_step(
        model, opt, grad_accum=2,
        batch_specs={"tokens": P("data", None), "targets": P("data", None)})
    batch = {k: torch.from_numpy(ref[pre + k][:params.get("rows")]
                                 .astype(np.int64))
             for k in ("tokens", "targets")}
    losses, gnorms = [], []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    final = gather_train_state(state, model, opt)
    return {"losses": np.array(losses), "gnorms": np.array(gnorms),
            **{f"{part}/{k}": v
               for part, tree in (("params", final["params"]),
                                  ("m", final["opt"]["m"]),
                                  ("v", final["opt"]["v"]))
               for k, v in _flat_np(tree).items()}}


def _case_elastic(params, rank):
    """Restore the reference's (2, 4) checkpoint onto each mesh shape in
    ``params["meshes"]``, keep the shards, gather them back."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.context import make_dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.loop import (gather_train_state,
                                        train_state_specs)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    cfg = get_arch(params["arch"]).reduced()
    opt = OptConfig(lr=1e-3)
    out = {}
    for shape in params["meshes"]:
        mesh = make_test_mesh(tuple(shape), ("data", "model"))
        model = build_model(cfg, "cpu", make_dist(mesh))
        abstract = model.abstract_params()
        like = {"params": abstract, "opt": init_opt_state(abstract, opt)}
        state, meta = elastic_restore(CheckpointManager(params["ckpt"]), like,
                                      model.dist, train_state_specs(model))
        tag = "x".join(map(str, shape))
        local = _flat_np(state)
        out[f"{tag}/local_numel"] = np.array(
            sum(v.size for v in local.values()))
        full = gather_train_state(state, model, opt)
        for k, v in _flat_np(full).items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/step"] = np.array(meta["step"])
        if rank == 0:       # a sharded state is saved gathered, in full
            CheckpointManager(f"{params['out']}/{tag}", async_save=False
                              ).save(meta["step"], full, meta)
    return out


CASES = {"collectives": _case_collectives, "gpipe": _case_gpipe,
         "moe": _case_moe, "train": _case_train, "elastic": _case_elastic}


def main(case, rank, world, workdir):
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    workdir = Path(workdir)
    params = json.loads((workdir / f"{case}.json").read_text())
    tdist.init_process_group("gloo", init_method=f"file://{workdir}/"
                             f"{case}.rendezvous", world_size=world,
                             rank=rank)
    try:
        out = CASES[case](params, rank)
        np.savez(workdir / f"{case}.{rank}.npz", **out)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
