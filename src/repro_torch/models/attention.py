"""GQA attention (with optional QK-norm / QKV bias): the GQA half of
``repro.models.attention``.

Each function mirrors its reference counterpart:
  gqa_init(gen, cfg, dtype, device) -> params
  gqa_forward(params, x, cfg, positions) -> y                  (full sequence)
  gqa_init_cache(cfg, batch, max_seq, dtype, device) -> cache
  gqa_prefill(params, x, cfg, cache, positions) -> (y, cache)  (writes cache)
  gqa_decode(params, x, cfg, cache, lengths) -> (y, cache)     (x is [B,1,d])

Prefill and decode attention go through ``kernels.ops``: the hand-written
CUDA kernels for CUDA tensors, their plain versions for CPU tensors. Unlike
the functional reference, prefill and decode write the new K/V into the
cache tensors in place (a copy of a serving cache per step and layer would
cost more than the attention) and return the same cache dict.

MLA waits for a later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, dt, init_dense, rmsnorm


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": init_dense(gen, d, cfg.n_heads * hd, dtype, device,
                         bias=cfg.qkv_bias),
        "wk": init_dense(gen, d, cfg.kv_heads * hd, dtype, device,
                         bias=cfg.qkv_bias),
        "wv": init_dense(gen, d, cfg.kv_heads * hd, dtype, device,
                         bias=cfg.qkv_bias),
        "wo": init_dense(gen, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _qkv(p, x, cfg: ArchConfig, positions):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KVH,hd] (RoPE'd q and k)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = dt(cfg.compute_dtype)
    q = dense(p["wq"], x, cdt).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x, cdt).reshape(B, S, cfg.kv_heads, hd)
    v = dense(p["wv"], x, cdt).reshape(B, S, cfg.kv_heads, hd)
    if "q_scale" in p:
        q = rmsnorm(q, p["q_scale"])
        k = rmsnorm(k, p["k_scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _causal_attention(q, k, v):
    """[B,S,H,hd] q and [B,S,KVH,hd] k/v -> [B,S,H*hd] through the
    ``flash_attention`` dispatcher (transpose views, no copies)."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
    return o.transpose(1, 2).reshape(B, S, -1)


def gqa_forward(p, x, cfg: ArchConfig, positions):
    """Causal self-attention over the sequence, positions ``0..S-1``."""
    q, k, v = _qkv(p, x, cfg, positions)
    return dense(p["wo"], _causal_attention(q, k, v), dt(cfg.compute_dtype))


def gqa_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    shp = (batch, max_seq, cfg.kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def gqa_prefill(p, x, cfg: ArchConfig, cache, positions):
    """Full-sequence forward that also fills cache[:, :S] (in place)."""
    q, k, v = _qkv(p, x, cfg, positions)
    S = x.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    y = dense(p["wo"], _causal_attention(q, k, v), dt(cfg.compute_dtype))
    return y, cache


def gqa_decode(p, x, cfg: ArchConfig, cache, lengths):
    """x: [B,1,d]; lengths[b] = number of tokens BEFORE this one.

    Writes the new K/V at ``lengths`` (in place), then attends over
    ``lengths + 1`` positions of the cache, which goes to the kernel as a
    ``[B,KVH,Smax,hd]`` permute view."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, lengths[:, None])
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, lengths] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, lengths] = v[:, 0].to(cache["v"].dtype)
    o = ops.flash_decode(q[:, 0], cache["k"].permute(0, 2, 1, 3),
                         cache["v"].permute(0, 2, 1, 3), lengths + 1)
    return dense(p["wo"], o.reshape(B, 1, -1), dt(cfg.compute_dtype)), cache
