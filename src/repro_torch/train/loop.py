"""The train step with microbatched gradient accumulation, on one device
or sharded over a mesh: the port of ``repro.train.loop``.

``init_train_state`` makes the parameters leaves that require grad;
``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, whose gradients come from ``torch.autograd.grad`` over those
leaves and whose update is ``optimizer.adamw_update``. Its parts run in
the profiler ranges ``forward``, ``backward`` and ``optimizer`` (free when
no profiler runs), by which a profile of the step splits its device
time.

On a mesh, ``train_state_specs`` gives the reference's layout of the
state (with ZeRO-1 the dp axes stripped from the parameters and added to
the optimizer state's largest free dim), and the same ``make_train_step``
is the counterpart of the reference's ``jit_train_step``: a step over
this rank's shards of that layout. Where the reference leaves the dense
layers to GSPMD, it places and gathers:

1. each microbatch is split over the batch spec's axes (the dp axes;
   the rows of a rank's share, the same on every rank of the other
   axes), and each rank runs the single-device model on its share;
2. every leaf is all-gathered in full before use (``dist.sharding.gather``,
   whose backward reduce-scatters the gradient to its owners), except
   the leaves the model's own explicit collectives take as shards (the
   sharded MoE's experts); each rank's loss is weighted by its share of
   the global batch over its replicas, so the summed gradients are those
   of the reference's mean over the global batch, and what the gathers'
   backward has not summed is all-reduced over the leaf's replica axes;
3. AdamW runs on the owner's shard with the global gradient norm; under
   ZeRO-1 on the optimizer's shards, followed by one all-gather of the
   parameters.

The semantics are the reference's: the same loss and the same update;
only the traffic differs (the dense layers are not computed
tensor-parallel). Every collective call runs in the profiler range
``collectives`` (``dist.collectives``), inside ``forward`` and
``backward`` where the gathers and the MoE exchanges run.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.bridge import flatten, unflatten
from repro_torch.dist.collectives import psum
from repro_torch.dist.sharding import (P, Placement, entry_axes, axis_index,
                                       axis_size, gather, map_with_specs,
                                       sanitize_spec, shard, tree_shardings)
from repro_torch.models.api import Model
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state


def opt_state_specs(param_specs):
    return {"m": param_specs, "v": param_specs, "step": P()}


def _contains_dp(entry, dp_axes) -> bool:
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return any(e in dp_axes for e in entry)
    return entry in dp_axes


def _pure_dp(entry, dp_axes) -> bool:
    """True only for FSDP entries (every axis is a dp axis) — mixed
    EP/TP entries like ('data','model') must keep their sharding."""
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return len(entry) > 0 and all(e in dp_axes for e in entry)
    return entry in dp_axes


def train_state_specs(model: Model):
    """Params + optimizer specs. With dist.zero1 the dp (FSDP) axes are
    STRIPPED from parameter specs (params replicated over dp, still
    TP/EP-sharded over model) while the optimizer state additionally
    shards its largest unsharded dim of leaves of at least 2^16 elements
    over dp (ZeRO-1): gradient sync is one all-reduce, the update runs on
    optimizer shards, and one parameter all-gather follows a step."""
    dist = model.dist
    ps = model.param_specs()
    if not (dist.active and dist.zero1):
        return {"params": ps, "opt": opt_state_specs(ps)}
    dp = dist.dp_axes
    abstract = model.abstract_params()

    def strip_dp(spec: P) -> P:
        return P(*[None if _pure_dp(e, dp) else e for e in spec])

    def add_dp(a, spec: P) -> P:
        entries = list(spec) + [None] * (a.ndim - len(spec))
        if a.ndim == 0 or a.numel() < 1 << 16 \
                or any(_contains_dp(e, dp) for e in entries):
            return P(*entries)
        free = [i for i, e in enumerate(entries) if e is None]
        if not free:
            return P(*entries)
        big = max(free, key=lambda i: a.shape[i])
        entries[big] = dp if len(dp) > 1 else dp[0]
        return P(*entries)

    params_ps = map_with_specs(strip_dp, ps)
    opt_ps = map_with_specs(add_dp, abstract, params_ps)
    return {"params": params_ps, "opt": opt_state_specs(opt_ps)}


def init_train_state(model: Model, gen: torch.Generator,
                     opt_cfg: OptConfig) -> dict:
    """{"params", "opt"}: random parameters from ``gen`` as leaves that
    require grad, and a zeroed optimizer state. Full tensors, on a mesh
    too (``shard_train_state`` takes this rank's shards)."""
    params = model.init(gen)
    for p in flatten(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


# ---------------------------------------------------------------- sharded


def train_state_shardings(model: Model, opt_cfg: OptConfig):
    """The ``Placement`` of every leaf of the train state on the model's
    mesh (``train_state_specs``, sanitized to the leaves' shapes); without
    one an empty placement, under which ``shard`` and ``gather`` are the
    identity."""
    abstract = model.abstract_params()
    state = {"params": abstract,
             "opt": init_opt_state(abstract, opt_cfg)}
    if not model.dist.active:
        return map_with_specs(lambda a: Placement(None, P()), state)
    return tree_shardings(model.dist, state, train_state_specs(model))


def shard_train_state(state, model: Model, opt_cfg: OptConfig):
    """This rank's shards of a full train state, as tensors of their own."""
    return map_with_specs(lambda t, pl: shard(t.detach(), pl).clone(),
                          state, train_state_shardings(model, opt_cfg))


def gather_train_state(state, model: Model, opt_cfg: OptConfig):
    """The full train state from this rank's shards (every rank gets it);
    what a checkpoint saves."""
    with torch.no_grad():
        return map_with_specs(gather, state,
                              train_state_shardings(model, opt_cfg))


def _split_rows(x, spec, mesh):
    """This rank's rows of ``x`` under ``spec``'s dim-0 axes, as
    ``numpy.array_split`` would give them out: (rows, shares). All of
    ``x`` without a mesh."""
    if mesh is None:
        return x, 1
    axes = entry_axes(spec[0]) if spec is not None and len(spec) else ()
    n, i = axis_size(mesh, axes), axis_index(mesh, axes)
    base, extra = divmod(x.shape[0], n)
    start = i * base + min(i, extra)
    rows = base + (i < extra)
    if rows == 0:
        raise ValueError(f"a microbatch of {x.shape[0]} rows leaves rank "
                         f"{i} of {n} along {axes} without one")
    return x[start:start + rows], n


def make_train_step(model: Model, opt_cfg: OptConfig, grad_accum: int = 1,
                    batch_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    reference's ``make_train_step`` on one device, its ``jit_train_step``
    on the model's mesh. With ``grad_accum`` > 1 the batch is split along
    dim 0 into that many microbatches, whose fp32 grads are summed and
    divided by their count; the loss is the mean of the microbatch losses
    and the other metrics are the last microbatch's, as the reference's
    ``scan`` gives them, with ``grad_norm`` and ``lr``.

    On a mesh the state is this rank's shards (``shard_train_state``) and
    ``batch`` the global batch, the same on every rank, split as
    ``batch_specs`` (the reference's in-shardings; replicated where None)
    says; every rank returns the same metrics. Without one every
    placement is empty, so the gathers, the row split and the sums over
    replicas are the identity and each loss weight is 1."""
    dist = model.dist
    mesh = dist.mesh if dist.active else None
    placed = train_state_shardings(model, opt_cfg)
    pl = flatten(placed["params"])
    opl = flatten(placed["opt"]["m"])
    # a local leaf whose state placement is less sharded than the model's
    # collectives take it (ZeRO-1's dp-replicated experts): sliced on use
    on_use = {}
    if mesh is not None:
        abstract = flatten(model.abstract_params())
        wanted = flatten(model.param_specs())
        for k in model.local_leaves:
            want = sanitize_spec(wanted[k], tuple(abstract[k].shape), mesh)
            on_use[k] = Placement(mesh, P(*[w if s is None else None for s, w
                                            in zip(pl[k].spec, want)]))
    # under ZeRO-1, the dims the optimizer shards beyond the parameters
    extra = {k: Placement(mesh, P(*[o if s is None else None for s, o
                                    in zip(pl[k].spec, opl[k].spec)]))
             for k in pl}
    replicas = {k: math.prod(mesh.shape[a] for a in p.replica_axes)
                for k, p in pl.items()} if mesh is not None else {}
    specs = batch_specs or {}
    world_size = mesh.size if mesh is not None else 1

    def micro_grads(leaves, micro):
        """(weighted loss, metrics, weight, grads) of one microbatch."""
        with record_function("forward"):
            full = {k: shard(v, on_use[k]) if k in on_use
                    else gather(v, pl[k]) for k, v in leaves.items()}
            local = {k: _split_rows(v, specs.get(k), mesh)
                     for k, v in micro.items()}
            first = next(iter(micro))
            rows, shares = local[first][0].shape[0], local[first][1]
            # this rank's share of the global microbatch over its replicas
            weight = rows / micro[first].shape[0] / (world_size / shares)
            loss, metrics = model.loss(
                unflatten(full), {k: v for k, (v, _) in local.items()})
            loss = loss * weight
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, weight, dict(zip(leaves, grads))

    def train_step(state, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten(state["params"]).items()}
        if grad_accum == 1:
            loss_sum, metrics, weight, grads = micro_grads(leaves, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // grad_accum
            grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                     for k, v in leaves.items()}
            loss_sum = 0.0
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, metrics, weight, g = micro_grads(leaves, micro)
                for k, gk in g.items():
                    grads[k].add_(gk.float())
                loss_sum = loss_sum + loss
        with torch.no_grad():
            for k in grads:
                axes = pl[k].replica_axes
                if axes:
                    grads[k] = psum(grads[k], mesh.group(axes))
                if grad_accum > 1:
                    grads[k] = grads[k] / grad_accum
            # squares of each leaf's distinct shard, over its replicas
            sq = sum(torch.sum(torch.square(g.float())) / replicas.get(k, 1)
                     for k, g in grads.items())
            names = sorted(metrics)
            summed = torch.stack(
                [sq, loss_sum / grad_accum]
                + [metrics[n].detach().float() * weight for n in names])
            if mesh is not None:
                summed = psum(summed, mesh.group(mesh.axis_names))
        with record_function("optimizer"):
            params, opt, stats = adamw_update(
                unflatten({k: shard(v.detach(), extra[k])
                           for k, v in leaves.items()}),
                unflatten({k: shard(g, extra[k]) for k, g in grads.items()}),
                state["opt"], opt_cfg, gnorm=torch.sqrt(summed[0]))
        with torch.no_grad():
            params = {k: gather(v, extra[k])
                      for k, v in flatten(params).items()}
        for p in params.values():
            p.requires_grad_(True)
        metrics = {**dict(zip(names, summed[2:])), **stats,
                   "loss": summed[1]}
        return {"params": unflatten(params), "opt": opt}, metrics

    return train_step
