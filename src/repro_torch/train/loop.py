"""The train step with microbatched gradient accumulation, on one device
or sharded over a mesh: the port of ``repro.train.loop``.

``init_train_state`` makes the parameters leaves that require grad;
``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, whose gradients come from ``torch.autograd.grad`` over those
leaves and whose update is ``optimizer.adamw_update``. Its parts run in
the spans ``forward``, ``backward`` and ``optimizer`` (``repro_torch.obs``:
profiler ranges, free when no profiler runs), by which a profile of the
step splits its device time.

On a mesh, ``train_state_specs`` gives the reference's layout of the
state (with ZeRO-1 the dp axes stripped from the parameters and added to
the optimizer state's largest free dim), and the same ``make_train_step``
is the counterpart of the reference's ``jit_train_step``: a step over
this rank's shards of that layout. Where the reference leaves the dense
layers to GSPMD, it places and gathers:

1. each microbatch is split over the batch spec's axes (the dp axes;
   the rows of a rank's share, the same on every rank of the other
   axes), and each rank runs the model on its share;
2. each leaf is relaid on use (``dist.sharding.relayout``: all-gathers,
   whose backward reduce-scatters the gradient to its owners, and
   slices) from where it rests to where the forward takes it: the
   leaves the model computes on as this rank's shards
   (``model.local_leaves``: the sharded MoE's experts, and the
   transformer family's and the encoder-decoder's tensor-parallel
   leaves, which keep their ``model`` split and have their dp dims
   gathered) at their specs, every other leaf whole. Their layer leaves
   are relaid inside the layer loops, one layer at a time
   (``tp.OnUse``), so
   the peak holds one layer's weights and remat "full" gathers them
   again in the backward. Each rank's loss is weighted by its share of
   the global batch over its replicas, so the summed gradients are those
   of the reference's mean over the global batch (every collective's
   backward being its transpose, the model ranks' contributions to a
   tensor-parallel product add up in the gathers' and the regions'
   backward), and what those have not summed is all-reduced over the
   leaf's replica axes;
3. AdamW runs on the owner's shard with the global gradient norm; under
   ZeRO-1 on the optimizer's shards, followed by one all-gather of the
   parameters.

The semantics are the reference's: the same loss and the same update;
only the traffic differs. The transformer family computes the dense
layers tensor-parallel over ``model`` (and sequence-parallel under
``seq_parallel``, ``models.tp``), and so does the encoder-decoder on its
resting columns; the hybrid and RWKV6 (pure DP) compute their rows
whole. Every collective call runs in the
span ``collectives`` (``dist.collectives``), inside ``forward``
and ``backward`` where the gathers, the regions and the MoE exchanges
run.

``make_serve_steps`` applies the same placement to prefill and decode,
with the cache resting in the reference's ``cache_specs``: the
counterpart of the reference's jitted prefill and decode on a mesh,
which the dry-run traces.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.collectives import psum
from repro_torch.dist.sharding import (P, Placement, entry_axes, axis_index,
                                       axis_size, gather, map_with_specs,
                                       relayout, sanitize_spec, shard,
                                       tree_shardings)
from repro_torch.models.api import Model
from repro_torch.models.tp import OnUse
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


def _empty_placements(tree):
    """A placement with no mesh for every leaf: ``shard`` and ``gather``
    are then the identity."""
    return map_with_specs(lambda a: Placement(None, P()), tree)


def train_state_shardings(model: Model, opt_cfg: OptConfig):
    """The ``Placement`` of every leaf of the train state on the model's
    mesh (``train_state_specs``, sanitized to the leaves' shapes); without
    one an empty placement, under which ``shard`` and ``gather`` are the
    identity."""
    abstract = model.abstract_params()
    state = {"params": abstract,
             "opt": init_opt_state(abstract, opt_cfg)}
    if not model.dist.active:
        return _empty_placements(state)
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


def _use_placements(model: Model, pl: dict) -> dict:
    """The placement each leaf is taken at on use: the local leaves at
    their specs (``model.local_leaves``, sanitized), every other leaf
    whole. Without a mesh, the empty placements ``pl``."""
    mesh = model.dist.mesh if model.dist.active else None
    if mesh is None:
        return pl
    abstract = flatten(model.abstract_params())
    return {k: Placement(mesh, sanitize_spec(
        model.local_leaves.get(k, P()), tuple(abstract[k].shape), mesh))
        for k in pl}


def _without_layer(p: Placement) -> Placement:
    """A stacked leaf's placement for one layer's slice."""
    return Placement(p.mesh, P(*p.spec[1:]))


# the stacks of layer leaves (a leading layer axis) the forward loops over
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def _params_on_use(leaves: dict, pl: dict, use: dict, per_layer: bool):
    """(the parameters the forward takes, the ``OnUse`` it takes them
    with): each leaf relaid from where it rests (``pl``) to where the
    forward takes it (``use``); where ``per_layer``, a layer leaf (of a
    stack whose layer axis is not sharded) a layer at a time, by the
    per-layer gather inside the layer loop."""
    def later(k):
        return per_layer and k.split("/", 1)[0] in LAYER_STACKS \
            and pl[k].spec[:1] in ((), (None,))
    now = {k: v if later(k) else relayout(v, pl[k], use[k])
           for k, v in leaves.items()}
    if not per_layer:
        return unflatten(now), OnUse()
    inner = {k: (_without_layer(pl[k]), _without_layer(use[k]))
             for k in leaves if later(k)}

    def layer(p_l, stack="layers"):
        return unflatten({k: relayout(v, *inner[f"{stack}/{k}"])
                          if f"{stack}/{k}" in inner else v
                          for k, v in flatten(p_l).items()})
    return unflatten(now), OnUse(layer=layer)


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
    use = _use_placements(model, pl)
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
        with obs.call("forward"):
            params, on_use = _params_on_use(leaves, pl, use,
                                            model.per_layer_gathers)
            local = {k: _split_rows(v, specs.get(k), mesh)
                     for k, v in micro.items()}
            first = next(iter(micro))
            rows, shares = local[first][0].shape[0], local[first][1]
            # this rank's share of the global microbatch over its replicas
            weight = rows / micro[first].shape[0] / (world_size / shares)
            batch = {k: v for k, (v, _) in local.items()}
            loss, metrics = model.loss(params, batch, on_use) \
                if model.per_layer_gathers else model.loss(params, batch)
            loss = loss * weight
        with obs.call("backward"):
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
        with obs.call("optimizer"):
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


# ------------------------------------------------------------- serving


def param_shardings(model: Model):
    """The ``Placement`` of every parameter under the sanitized
    ``model.param_specs()`` (what serving holds); without a mesh, empty
    placements."""
    abstract = model.abstract_params()
    if not model.dist.active:
        return _empty_placements(abstract)
    return tree_shardings(model.dist, abstract, model.param_specs())


def cache_shardings(model: Model, cache):
    """The ``Placement`` of every leaf of a full cache (or of anything
    with its leaves' shapes) on the model's mesh: ``model.cache_specs()``
    sanitized; without a mesh, empty placements."""
    if not model.dist.active:
        return _empty_placements(cache)
    return tree_shardings(model.dist, cache, model.cache_specs())


def shard_cache(cache, model: Model):
    """This rank's shards of a full cache, as tensors of their own."""
    return map_with_specs(lambda t, pl: shard(t, pl).clone(), cache,
                          cache_shardings(model, cache))


def gather_cache(cache, model: Model, like):
    """The full cache from this rank's shards (every rank gets it);
    ``like``: the full cache or its shapes."""
    with torch.no_grad():
        return map_with_specs(gather, cache, cache_shardings(model, like))


def seq_cache_leaves(model: Model, cache_like) -> set:
    """The cache leaves the model reads in place sharded over ``model`` on
    their sequence (dim 2 of the stacked cache): its attention caches,
    where the sanitized spec splits their sequence over a ``model`` axis
    of more than one rank."""
    if not (model.dist.active and model.dist.model_size > 1):
        return set()
    m = model.dist.model_axis
    return {k for k, p in flatten(cache_shardings(model, cache_like)).items()
            if len(p.spec) > 2 and m in entry_axes(p.spec[2])}


def make_init_cache(model: Model, cache_like):
    """Returns ``init_cache(params, batch, B, max_seq)``: this rank's
    shards of the cache ``model.init_cache`` gives whole, made on the
    rank (the counterpart of the reference's ``model.init_cache`` on its
    mesh); ``model.init_cache`` itself without a mesh. ``params`` are this
    rank's shards of ``param_shardings``, ``batch`` the global inputs, the
    same on every rank, and ``cache_like`` the full cache's shapes. Each
    rank runs ``model.init_cache`` on its rows of ``batch`` (split as the
    decode splits them), for the rows and positions its shards hold (its
    block of ``max_seq`` where the cache rests sequence-sharded). Where
    the cache comes from the parameters (the encoder-decoder's cross
    K/V), they go in as the serving steps take them: the encoder and each
    layer's cross K/V run on this rank's columns, every head gathered
    into the cross cache, which rests whole over ``model``."""
    if not model.dist.active:
        return model.init_cache
    mesh, M = model.dist.mesh, model.dist.model_size
    pl = flatten(param_shardings(model))
    use = _use_placements(model, pl)
    cpl = flatten(cache_shardings(model, cache_like))
    seq = seq_cache_leaves(model, cache_like)
    specs = model.batch_specs(ShapeConfig("decode", 1, 1, "decode"))
    from_params = model.cfg.enc_dec is not None

    def init_cache(params, batch, B, max_seq):
        rows = {k: _split_rows(v, sanitize_spec(
            specs.get(k, P()), tuple(v.shape), mesh), mesh)[0]
            for k, v in batch.items()}
        ways = {axis_size(mesh, entry_axes(p.spec[1])) for p in cpl.values()}
        if len(ways) != 1 or B % min(ways):
            raise ValueError(f"{B} rows do not share out over the cache's "
                             f"row splits {sorted(ways)}")
        local_b = B // ways.pop()
        local_s = max_seq // M if seq else max_seq
        with torch.no_grad():
            if from_params:
                full, on_use = _params_on_use(flatten(params), pl, use,
                                              model.per_layer_gathers)
                return model.init_cache(full, rows, local_b, local_s, on_use)
            return model.init_cache(params, rows, local_b, local_s)
    return init_cache


def make_serve_steps(model: Model, cache_like):
    """Returns ``(prefill, decode_step)`` with the model's own signatures,
    ``prefill(params, batch, cache)`` and ``decode_step(params, cache,
    tokens, lengths)``, each returning ``(logits, cache)``: the
    counterpart of the reference's ``jax.jit(model.prefill /
    model.decode_step, in_shardings=...)`` on the model's mesh, the model's
    own functions without one. ``cache_like`` is the full cache or
    anything with its leaves' shapes.

    On a mesh it applies ``make_train_step``'s rule of placement:

    * ``params`` are this rank's shards of the sanitized
      ``model.param_specs()``, each relaid on use to where the forward
      takes it (the local leaves as shards, every other leaf whole; the
      transformer family's and whisper's layer leaves one layer at a
      time);
    * the inputs are the global batch, the same on every rank; each rank
      runs its rows, split as ``model.batch_specs`` of a prefill or a
      decode (sanitized to the inputs) splits ``tokens``;
    * ``cache`` is this rank's shards of the sanitized
      ``model.cache_specs()`` (``shard_cache``). The attention caches
      whose sequence rests sharded over ``model`` (the transformer
      family's, the hybrid's shared-block ``kv`` and whisper's ``self``)
      are read and written in place: prefill sends its K/V to the ranks
      that hold their positions and the decode is sequence-parallel
      (``models.attention``). Every other leaf is passed in place where
      its shard is this rank's rows of it, and otherwise relaid
      (``dist.sharding.relayout``) to this rank's rows with every other
      dim whole, the updated leaf relaid back into this rank's shard in
      place (the hybrid's Mamba2 states in its prefill, whose rows split
      over ``model`` too). The shards are returned.

    The logits are this rank's rows."""
    mesh = model.dist.mesh if model.dist.active else None
    pl = flatten(param_shardings(model))
    use = _use_placements(model, pl)
    cpl = flatten(cache_shardings(model, cache_like))
    per_layer = model.per_layer_gathers
    seq = seq_cache_leaves(model, cache_like)
    kinds = {kind: model.batch_specs(ShapeConfig(kind, 1, 1, kind))
             for kind in ("prefill", "decode")}

    def rows(batch, specs):
        """(this rank's rows of each input, the placement of a cache
        leaf on use: its rows split as the tokens', every other dim
        whole)."""
        sane = {k: sanitize_spec(specs.get(k, P()), tuple(v.shape), mesh)
                for k, v in batch.items()}
        local = {k: _split_rows(v, sane[k], mesh)[0]
                 for k, v in batch.items()}
        row_axes = sane["tokens"][0] if mesh is not None else None
        return local, Placement(mesh, P(None, row_axes))

    def blocks(p: Placement):
        """The axes of more than one rank that split each dim."""
        out = [tuple(a for a in entry_axes(e) if mesh.shape[a] > 1)
               for e in p.spec]
        while out and not out[-1]:
            out.pop()
        return out

    def call(fn, kind, params, batch, cache):
        local, rows_use = rows(batch, kinds[kind])
        with torch.no_grad():
            full, on_use = _params_on_use(flatten(params), pl, use,
                                          per_layer)
            rest = flatten(cache)
            same = {k for k in rest if k in seq or mesh is None
                    or blocks(cpl[k]) == blocks(rows_use)}
            on = {k: v if k in same else relayout(v, cpl[k], rows_use)
                  for k, v in rest.items()}
            logits, new = fn(full, local, unflatten(on), dataclasses.replace(
                on_use, cache_seq=bool(seq)))
            for k, v in flatten(new).items():
                if k in same and v is rest[k]:  # updated in place
                    continue
                src = cpl[k] if k in same else rows_use
                rest[k].copy_(relayout(v, src, cpl[k]))
        return logits, cache

    def prefill(params, batch, cache):
        return call(model.prefill, "prefill", params, batch, cache)

    def decode_step(params, cache, tokens, lengths):
        return call(lambda p, b, c, on_use: model.decode_step(
            p, c, b["tokens"], b["lengths"], on_use), "decode", params,
            {"tokens": tokens, "lengths": lengths}, cache)

    return prefill, decode_step
