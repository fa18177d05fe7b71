"""The train step with microbatched gradient accumulation, the port of
``repro.train.loop`` without a mesh.

``init_train_state`` makes the parameters leaves that require grad;
``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, whose gradients come from ``torch.autograd.grad`` over those
leaves and whose update is ``optimizer.adamw_update``. Its parts run in
the profiler ranges ``forward``, ``backward`` and ``optimizer`` (free when
no profiler runs), by which a profile of the step splits its device
time. The sharding specs
(``train_state_specs``, ``opt_state_specs``) and the jitted sharded step
come with distribution (ROADMAP).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.bridge import flatten, unflatten
from repro_torch.models.api import Model
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state


def init_train_state(model: Model, gen: torch.Generator,
                     opt_cfg: OptConfig) -> dict:
    """{"params", "opt"}: random parameters from ``gen`` as leaves that
    require grad, and a zeroed optimizer state."""
    params = model.init(gen)
    for p in flatten(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def make_train_step(model: Model, opt_cfg: OptConfig, grad_accum: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``. With
    ``grad_accum`` > 1 the batch is split along dim 0 into that many
    microbatches, whose fp32 grads are summed and divided by their count;
    the loss is the mean of the microbatch losses and the other metrics
    are the last microbatch's, as the reference's ``scan`` gives them."""

    def loss_and_grads(params, batch, leaves):
        with record_function("forward"):
            loss, metrics = model.loss(params, batch)
        with record_function("backward"):
            return loss, metrics, torch.autograd.grad(loss, leaves)

    def compute_grads(params, batch):
        keys, leaves = zip(*flatten(params).items())
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(params, batch, leaves)
            return loss.detach(), metrics, dict(zip(keys, grads))
        B = next(iter(batch.values())).shape[0]
        mb = B // grad_accum
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = 0.0
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(params, micro, leaves)
            for a, g in zip(acc, grads):
                a.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        return loss_sum / grad_accum, metrics, {
            k: a / grad_accum for k, a in zip(keys, acc)}

    def train_step(state, batch):
        loss, metrics, grads = compute_grads(state["params"], batch)
        with record_function("optimizer"):
            params, opt, stats = adamw_update(state["params"],
                                              unflatten(grads), state["opt"],
                                              opt_cfg)
        for p in flatten(params).values():
            p.requires_grad_(True)
        metrics = {k: v.detach() for k, v in {**metrics, **stats}.items()}
        return {"params": params, "opt": opt}, {**metrics, "loss": loss}

    return train_step
