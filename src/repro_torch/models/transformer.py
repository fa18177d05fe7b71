"""Decoder-only LM: dense / MoE FFN x GQA / MLA attention, the port of
``repro.models.transformer`` (serving half).

Parameters keep the reference's layout: per-layer params stacked along a
leading layer axis under ``params["layers"]`` (``attn/wq/w``, ``norm1/scale``,
``mlp/gate/w``, ``moe/up``, ...), dense weights ``[d_in, d_out]``. A Python
loop over the layers replaces ``jax.lax.scan``. The cache is stacked the
same way: ``{"k", "v"}`` of shape ``[L, B, Smax, KVH, hd]`` for GQA,
``{"c_kv", "k_rope"}`` of shape ``[L, B, Smax, kv_lora]`` and ``[L, B, Smax,
rope]`` for MLA.

``lm_init`` allocates each stacked tensor once, in the parameter dtype,
and fills it layer by layer (and expert by expert) from the generator, so
a full-width init needs no more memory than the parameters themselves.

``lm_backbone``, ``lm_loss`` and the MTP head (``mtp_init`` /
``mtp_loss``) come with the training slice of the port (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm, dt, init_embedding, init_mlp, init_norm, materialize, mlp,
    unembed,
)
from repro_torch.models.moe import moe_block, moe_init


# ------------------------------------------------------------------ init


def _layer_init(cfg: ArchConfig) -> dict:
    """One layer's parameter spec (``layers.Draw``s)."""
    a = attn.mla_init(cfg) if cfg.attention == "mla" else attn.gqa_init(cfg)
    p = {"attn": a,
         "norm1": init_norm(cfg.d_model, cfg.norm),
         "norm2": init_norm(cfg.d_model, cfg.norm)}
    if cfg.moe is not None:
        p["moe"] = moe_init(cfg)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.glu)
    return p


def layer_slices(layers: dict, n_layers: int) -> list:
    """Stacked layer params (or cache) -> one dict of views per layer."""
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [pick(layers, i) for i in range(n_layers)]


def lm_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device): the stacked layers first, then the embeddings."""
    dtype = dt(cfg.param_dtype)
    p = {"layers": materialize(_layer_init(cfg), gen, dtype, device,
                               layers=cfg.n_layers)}
    rest = {"embed": init_embedding(cfg.vocab, cfg.d_model),
            "final_norm": init_norm(cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        rest["unembed"] = init_embedding(cfg.vocab, cfg.d_model)
    p.update(materialize(rest, gen, dtype, device))
    return p


# --------------------------------------------------------------- forward


def _ffn_residual(p_l, x, cfg: ArchConfig):
    h = apply_norm(p_l["norm2"], x, cfg.norm)
    if cfg.moe is not None:
        y, _ = moe_block(p_l["moe"], h, cfg)
    else:
        y = mlp(p_l["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype))
    return x + y


def _out_weight(params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _embed(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens].to(dt(cfg.compute_dtype))


def lm_forward(params, tokens, cfg: ArchConfig):
    """tokens [B,S] -> full logits [B,S,V] fp32 (small shapes)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    forward = attn.mla_forward if cfg.attention == "mla" \
        else attn.gqa_forward
    for p_l in layer_slices(params["layers"], cfg.n_layers):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = _ffn_residual(p_l, x + forward(p_l["attn"], h, cfg, positions),
                          cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))


# ----------------------------------------------------------------- cache


def lm_init_cache(cfg: ArchConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed per-layer caches, stacked on a leading layer axis."""
    init = attn.mla_init_cache if cfg.attention == "mla" \
        else attn.gqa_init_cache
    c = init(cfg, cfg.n_layers * batch, max_seq, dt(cfg.param_dtype), device)
    return {k: v.view(cfg.n_layers, batch, *v.shape[1:])
            for k, v in c.items()}


def lm_prefill(params, tokens, cfg: ArchConfig, cache):
    """Forward + cache fill (in place); returns (last-token logits [B,V],
    cache)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    prefill = attn.mla_prefill if cfg.attention == "mla" \
        else attn.gqa_prefill
    for p_l, c_l in zip(layer_slices(params["layers"], cfg.n_layers),
                        layer_slices(cache, cfg.n_layers)):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = prefill(p_l["attn"], h, cfg, c_l, positions)
        x = _ffn_residual(p_l, x + y, cfg)
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    logits = unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))
    return logits[:, 0, :], cache


def lm_decode_step(params, cache, tokens, lengths, cfg: ArchConfig):
    """tokens [B,1], lengths [B] -> (logits [B,V], cache updated in place)."""
    x = _embed(params, tokens, cfg)
    decode = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    for p_l, c_l in zip(layer_slices(params["layers"], cfg.n_layers),
                        layer_slices(cache, cfg.n_layers)):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = decode(p_l["attn"], h, cfg, c_l, lengths)
        x = _ffn_residual(p_l, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))
    return logits[:, 0, :], cache
