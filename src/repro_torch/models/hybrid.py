"""Zamba2-style hybrid, the port of ``repro.models.hybrid``: a Mamba2
backbone and one weight-tied shared attention + MLP block applied every
``shared_attn_every`` backbone layers.

zamba2-2.7b has 54 Mamba2 layers in 9 groups of 6; after each group the
same (shared) GQA attention + MLP block runs, with a KV cache of its own
for each application. As in the reference, the shared block's input is
the plain residual stream (the published model also concatenates the
embedding stream and alternates two shared blocks with LoRA adapters).

Parameters keep the reference's layout: ``layers/{m,norm}`` stacked on a
leading ``[n_layers]`` axis and one ``shared`` subtree, so the bridge is
one-to-one. Python loops over the groups and their layers replace the
reference's nested ``scan``. The state is ``{"mamba": {"conv", "h"}}``
stacked on ``[n_layers]`` and ``{"kv": {"k", "v"}}`` stacked on one
leading axis of applications; prefill and decode write both in place and
return the same dict. The shared block's attention goes through
``attention.gqa_forward`` / ``gqa_prefill`` / ``gqa_decode``, so through the
``flash_attention`` and ``flash_decode`` kernels on the card.

On a mesh the parameters rest pure FSDP, gathered whole on use, and the
shared block's caches rest with their sequence sharded over ``model``
(the reference's ``cache_specs``). Where the sharded steps say so
(``tp.OnUse.cache_seq``), prefill sends each rank's rows of the new K/V
to the ranks that hold their positions (its rows are split over
``model`` too, the family being pure DP) and the decode attends over
this rank's block of the sequence, merged over the axis
(``attention.gqa_prefill`` / ``gqa_decode`` with the plan of
``models.tp``, which splits nothing here). The Mamba2 states rest over
the dp axes only.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.models import attention as attn
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (
    apply_norm, dt, init_embedding, init_mlp, init_norm, materialize, mlp,
    remat_fn, unembed,
)
from repro_torch.models.mamba2 import (
    mamba2_decode, mamba2_forward, mamba2_init, mamba2_init_state,
    mamba2_prefill,
)
from repro_torch.models.transformer import _embed, _positions, layer_slices


def _groups(cfg: ArchConfig):
    """(groups, backbone layers a group)."""
    k = cfg.hybrid.shared_attn_every
    assert cfg.n_layers % k == 0
    return cfg.n_layers // k, k


def hybrid_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device), each parameter allocated once in its final dtype."""
    dtype = dt(cfg.param_dtype)
    d = cfg.d_model

    def make(spec, layers=0):
        return materialize(spec, gen, dtype, device, layers=layers)

    p = make({"embed": init_embedding(cfg.vocab, d)})
    p["layers"] = make({"m": mamba2_init(cfg),
                        "norm": init_norm(d, cfg.norm)}, cfg.n_layers)
    p.update(make({"shared": {"attn": attn.gqa_init(cfg),
                              "mlp": init_mlp(d, cfg.d_ff, cfg.glu),
                              "norm1": init_norm(d, cfg.norm),
                              "norm2": init_norm(d, cfg.norm)},
                   "final_norm": init_norm(d, cfg.norm),
                   "unembed": init_embedding(cfg.vocab, d)}))
    return p


def hybrid_states(cfg: ArchConfig, batch: int, max_seq: int,
                  device) -> dict:
    """Zeroed decode state: every layer's Mamba2 state stacked on
    ``[n_layers, B, ...]``, and one GQA cache for each application of the
    shared block stacked on ``[groups, B, max_seq, KVH, hd]``."""
    ng, _ = _groups(cfg)
    m = mamba2_init_state(cfg, cfg.n_layers * batch, device)
    kv = attn.gqa_init_cache(cfg, ng * batch, max_seq, dt(cfg.param_dtype),
                             device)
    return {"mamba": {k: v.view(cfg.n_layers, batch, *v.shape[1:])
                      for k, v in m.items()},
            "kv": {k: v.view(ng, batch, *v.shape[1:])
                   for k, v in kv.items()}}


def _mlp_residual(shared, x, cfg: ArchConfig):
    h = apply_norm(shared["norm2"], x, cfg.norm)
    return x + mlp(shared["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype))


def _shared_block_fwd(shared, x, cfg: ArchConfig, positions):
    h = apply_norm(shared["norm1"], x, cfg.norm)
    x = x + attn.gqa_forward(shared["attn"], h, cfg, positions)
    return _mlp_residual(shared, x, cfg)


def _write(state: dict, new: dict) -> None:
    """Copy a layer's new Mamba2 state into its views of the stack."""
    for k, v in new.items():
        state[k].copy_(v)


def hybrid_forward(params, tokens, cfg: ArchConfig, remat: str = "none"):
    """tokens [B,S] -> full logits [B,S,V] fp32. With ``remat`` other than
    "none", each group (its Mamba2 layers and the shared block) runs under
    checkpoint, as the reference checkpoints its group scan's body."""
    ng, k = _groups(cfg)
    x = _embed(params, tokens, cfg)
    positions = _positions(tokens)
    layers = layer_slices(params["layers"], cfg.n_layers)

    def group(x, p_g):
        for p_l in p_g:
            h = apply_norm(p_l["norm"], x, cfg.norm)
            y, _ = mamba2_forward(p_l["m"], h, cfg)
            x = x + y.to(x.dtype)
        return _shared_block_fwd(params["shared"], x, cfg, positions)

    group = remat_fn(group, "none" if remat == "none" else "full")
    for g in range(ng):
        x = group(x, layers[g * k:(g + 1) * k])
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, params["unembed"], dt(cfg.compute_dtype))


def _cache_plan(cfg: ArchConfig, dist: DistContext, on_use: tpm.OnUse):
    """(plan, cache_seq) of the shared block's cache: the plan only where
    the cache rests sharded on its sequence."""
    if not on_use.cache_seq:
        return None, False
    return tpm.plan(cfg, dist), True


def hybrid_prefill(params, tokens, cfg: ArchConfig, states,
                   dist: DistContext = no_dist(),
                   on_use: tpm.OnUse = tpm.OnUse()):
    """Forward + state fill (in place); returns (last-token logits [B,V],
    states). Where ``on_use.cache_seq`` the shared block's cache is this
    rank's block of the sequence of its dp rows."""
    tp, cache_seq = _cache_plan(cfg, dist, on_use)
    ng, k = _groups(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    layers = layer_slices(params["layers"], cfg.n_layers)
    mstates = layer_slices(states["mamba"], cfg.n_layers)
    shared = params["shared"]
    for g, kv_g in enumerate(layer_slices(states["kv"], ng)):
        for p_l, st_l in zip(layers[g * k:(g + 1) * k],
                             mstates[g * k:(g + 1) * k]):
            h = apply_norm(p_l["norm"], x, cfg.norm)
            y, new = mamba2_prefill(p_l["m"], h, cfg, st_l)
            _write(st_l, new)
            x = x + y.to(x.dtype)
        h = apply_norm(shared["norm1"], x, cfg.norm)
        y, _ = attn.gqa_prefill(shared["attn"], h, cfg, kv_g, positions, tp,
                                cache_seq)
        x = _mlp_residual(shared, x + y, cfg)
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    logits = unembed(x, params["unembed"], dt(cfg.compute_dtype))
    return logits[:, 0, :], states


def hybrid_decode_step(params, states, tokens, lengths, cfg: ArchConfig,
                       dist: DistContext = no_dist(),
                       on_use: tpm.OnUse = tpm.OnUse()):
    """tokens [B,1], lengths [B] -> (logits [B,V], states updated in
    place); the shared block's attention sequence-parallel where
    ``on_use.cache_seq``."""
    tp, cache_seq = _cache_plan(cfg, dist, on_use)
    ng, k = _groups(cfg)
    x = _embed(params, tokens, cfg)
    layers = layer_slices(params["layers"], cfg.n_layers)
    mstates = layer_slices(states["mamba"], cfg.n_layers)
    shared = params["shared"]
    for g, kv_g in enumerate(layer_slices(states["kv"], ng)):
        for p_l, st_l in zip(layers[g * k:(g + 1) * k],
                             mstates[g * k:(g + 1) * k]):
            h = apply_norm(p_l["norm"], x, cfg.norm)
            y, new = mamba2_decode(p_l["m"], h, cfg, st_l)
            _write(st_l, new)
            x = x + y.to(x.dtype)
        h = apply_norm(shared["norm1"], x, cfg.norm)
        y, _ = attn.gqa_decode(shared["attn"], h, cfg, kv_g, lengths, tp,
                               cache_seq)
        x = _mlp_residual(shared, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, params["unembed"], dt(cfg.compute_dtype))
    return logits[:, 0, :], states
