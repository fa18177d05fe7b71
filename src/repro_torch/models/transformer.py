"""Decoder-only LM with dense FFN and GQA attention: the dense part of
``repro.models.transformer``.

Parameters keep the reference's layout: per-layer params stacked along a
leading layer axis under ``params["layers"]`` (``attn/wq/w``, ``norm1/scale``,
``mlp/gate/w``, ...), dense weights ``[d_in, d_out]``. A Python loop over
the layers replaces ``jax.lax.scan``. The KV cache is stacked the same way:
``{"k", "v"}`` of shape ``[L, B, Smax, KVH, hd]``.

MoE, MLA, MTP and ``lm_loss`` wait for later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm, dt, init_embedding, init_mlp, init_norm, mlp, unembed,
)


# ------------------------------------------------------------------ init


def _layer_init(gen, cfg: ArchConfig, dtype, device) -> dict:
    return {"attn": attn.gqa_init(gen, cfg, dtype, device),
            "norm1": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype,
                            device)}


def _stack(trees: list) -> dict:
    """List of same-structure dicts of tensors -> dict of stacked tensors."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def layer_slices(layers: dict, n_layers: int) -> list:
    """Stacked layer params (or cache) -> one dict of views per layer."""
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [pick(layers, i) for i in range(n_layers)]


def lm_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``)."""
    dtype = dt(cfg.param_dtype)
    layers = _stack([_layer_init(gen, cfg, dtype, device)
                     for _ in range(cfg.n_layers)])
    p = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, device),
         "layers": layers,
         "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_embedding(gen, cfg.vocab, cfg.d_model, dtype,
                                      device)
    return p


# --------------------------------------------------------------- forward


def _mlp_residual(p_l, x, cfg: ArchConfig):
    h = apply_norm(p_l["norm2"], x, cfg.norm)
    return x + mlp(p_l["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype))


def _out_weight(params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _embed(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens].to(dt(cfg.compute_dtype))


def lm_forward(params, tokens, cfg: ArchConfig):
    """tokens [B,S] -> full logits [B,S,V] fp32 (small shapes)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for p_l in layer_slices(params["layers"], cfg.n_layers):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + attn.gqa_forward(p_l["attn"], h, cfg, positions)
        x = _mlp_residual(p_l, x, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))


# ----------------------------------------------------------------- cache


def lm_init_cache(cfg: ArchConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed per-layer GQA caches, stacked: [L, B, Smax, KVH, hd]."""
    c = attn.gqa_init_cache(cfg, cfg.n_layers * batch, max_seq,
                            dt(cfg.param_dtype), device)
    return {k: v.view(cfg.n_layers, batch, *v.shape[1:])
            for k, v in c.items()}


def lm_prefill(params, tokens, cfg: ArchConfig, cache):
    """Forward + cache fill (in place); returns (last-token logits [B,V],
    cache)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for p_l, c_l in zip(layer_slices(params["layers"], cfg.n_layers),
                        layer_slices(cache, cfg.n_layers)):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = attn.gqa_prefill(p_l["attn"], h, cfg, c_l, positions)
        x = _mlp_residual(p_l, x + y, cfg)
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    logits = unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))
    return logits[:, 0, :], cache


def lm_decode_step(params, cache, tokens, lengths, cfg: ArchConfig):
    """tokens [B,1], lengths [B] -> (logits [B,V], cache updated in place)."""
    x = _embed(params, tokens, cfg)
    for p_l, c_l in zip(layer_slices(params["layers"], cfg.n_layers),
                        layer_slices(cache, cfg.n_layers)):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = attn.gqa_decode(p_l["attn"], h, cfg, c_l, lengths)
        x = _mlp_residual(p_l, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))
    return logits[:, 0, :], cache
