"""Attention blocks: GQA (with optional QK-norm / QKV bias) and DeepSeek
MLA, the port of ``repro.models.attention``.

Each function mirrors its reference counterpart:
  gqa_init(cfg) / mla_init(cfg) -> parameter spec (``layers.Draw``s)
  *_forward(params, x, cfg, positions) -> y                  (full sequence)
  *_init_cache(cfg, batch, max_seq, dtype, device) -> cache
  *_prefill(params, x, cfg, cache, positions) -> (y, cache)  (writes cache)
  *_decode(params, x, cfg, cache, lengths) -> (y, cache)     (x is [B,1,d])

Prefill attention goes through ``kernels.ops.flash_attention`` for both
blocks (MLA with q/k head dim nope + rope and its own v head dim; the
encoder-decoder's encoder and cross-attention without the causal mask,
``attention``), GQA decode through ``flash_decode``: the hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors. Unlike the functional
reference, prefill and decode write the new K/V (or MLA's latent) into the
cache tensors in place (a copy of a serving cache per step and layer would
cost more than the attention) and return the same cache dict.

MLA caches the compressed latent (c_kv + k_rope) and decodes in the
absorbed form (W_uk folded into q, W_uv applied after attention) as
matrix products, outside any kernel, as the reference does in einsums.
``mla_decode_naive`` keeps the decompressing form as its oracle.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    NEG_INF, Draw, apply_rope, decode_attention, dense, dt, init_dense,
    rmsnorm,
)

# =========================================================== GQA attention


def gqa_init(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": init_dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": init_dense(d, cfg.kv_heads * hd, bias=cfg.qkv_bias),
        "wv": init_dense(d, cfg.kv_heads * hd, bias=cfg.qkv_bias),
        "wo": init_dense(cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_scale"] = Draw((hd,), value=1.0)
        p["k_scale"] = Draw((hd,), value=1.0)
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


def attention(q, k, v, causal: bool = True):
    """[B,Sq,H,Dqk] q, [B,Skv,KVH,Dqk] k and [B,Skv,KVH,Dv] v ->
    [B,Sq,H*Dv] through the ``flash_attention`` dispatcher (transpose
    views, no copies), scores scaled by 1/sqrt(Dqk); ``causal`` where
    Sq == Skv (self-attention), not causal for the encoder and for
    cross-attention."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2).reshape(B, S, -1)


def gqa_forward(p, x, cfg: ArchConfig, positions, causal: bool = True):
    """Self-attention over the sequence, positions ``0..S-1``: causal, or
    over every position (the encoder's)."""
    q, k, v = _qkv(p, x, cfg, positions)
    return dense(p["wo"], attention(q, k, v, causal), dt(cfg.compute_dtype))


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
    y = dense(p["wo"], attention(q, k, v), dt(cfg.compute_dtype))
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


# =========================================================== MLA attention


def mla_init(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": init_dense(d, m.q_lora_rank),
        "q_norm": Draw((m.q_lora_rank,), value=1.0),
        "wq_b": init_dense(m.q_lora_rank, H * qk),
        "wkv_a": init_dense(d, m.kv_lora_rank + m.rope_head_dim),
        "kv_norm": Draw((m.kv_lora_rank,), value=1.0),
        "wkv_b": init_dense(m.kv_lora_rank,
                            H * (m.nope_head_dim + m.v_head_dim)),
        "wo": init_dense(H * m.v_head_dim, d),
    }


def _mla_q(p, x, cfg: ArchConfig, positions):
    """x [B,S,d] -> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (RoPE'd)."""
    m = cfg.mla
    B, S, _ = x.shape
    cdt = dt(cfg.compute_dtype)
    qa = rmsnorm(dense(p["wq_a"], x, cdt), p["q_norm"])
    q = dense(p["wq_b"], qa, cdt).reshape(
        B, S, cfg.n_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg: ArchConfig, positions):
    """x [B,S,d] -> c_kv [B,S,kv_lora] and k_rope [B,S,rope], one RoPE'd
    key part shared by every head."""
    m = cfg.mla
    cdt = dt(cfg.compute_dtype)
    kv_a = dense(p["wkv_a"], x, cdt)
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_attend(p, x, cfg: ArchConfig, positions, c_kv, k_rope):
    """Causal attention over the decompressed latent: q/k head dim nope +
    rope and v head dim ``v_head_dim`` in one ``flash_attention`` call,
    scores scaled by 1/sqrt(nope + rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cdt = dt(cfg.compute_dtype)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    kv = dense(p["wkv_b"], c_kv, cdt).reshape(
        B, S, H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    # the kernel takes a contiguous last dim: the shared k_rope is
    # expanded across heads and joined to each head's k_nope
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return dense(p["wo"], attention(q, k, v), cdt)


def mla_forward(p, x, cfg: ArchConfig, positions):
    """Causal MLA over the sequence, positions ``0..S-1``."""
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    return _mla_attend(p, x, cfg, positions, c_kv, k_rope)


def mla_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, m.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p, x, cfg: ArchConfig, cache, positions):
    """Full-sequence forward that also fills the latent cache[:, :S] (in
    place)."""
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    S = x.shape[1]
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    return _mla_attend(p, x, cfg, positions, c_kv, k_rope), cache


def _mla_wkv_b_split(p, cfg: ArchConfig):
    """W_uk [lora,H,nope] and W_uv [lora,H,v], views of ``wkv_b``."""
    m = cfg.mla
    w = p["wkv_b"]["w"].reshape(m.kv_lora_rank, cfg.n_heads,
                                m.nope_head_dim + m.v_head_dim)
    return w[..., :m.nope_head_dim], w[..., m.nope_head_dim:]


def _mla_write(p, x, cfg: ArchConfig, cache, lengths):
    """The new token's q parts, and its latent written at ``lengths`` (in
    place)."""
    positions = lengths[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["c_kv"][bidx, lengths] = c_kv[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][bidx, lengths] = k_rope[:, 0].to(cache["k_rope"].dtype)
    return q_nope, q_rope


def mla_decode(p, x, cfg: ArchConfig, cache, lengths):
    """Absorbed-form decode: scores and readout in the compressed latent
    space. As the reference's einsums with ``preferred_element_type=
    float32``, each product takes operands rounded to the compute dtype and
    gives fp32: here as fp32 products of the rounded operands, which hold
    the same values (a bf16 product would round its result to bf16)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    cdt = dt(cfg.compute_dtype)

    def rnd(t):                     # round to the compute dtype, then fp32
        return t.to(cdt).float()

    q_nope, q_rope = _mla_write(p, x, cfg, cache, lengths)
    ckv, krp = rnd(cache["c_kv"]), rnd(cache["k_rope"])
    w_uk, w_uv = _mla_wkv_b_split(p, cfg)
    q_lat = torch.einsum("bshn,lhn->bshl", rnd(q_nope), rnd(w_uk))
    s = (torch.einsum("bshl,btl->bhst", rnd(q_lat), ckv)
         + torch.einsum("bshr,btr->bhst", rnd(q_rope), krp))
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] \
        < (lengths + 1)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)                        # [B,H,1,Smax]
    o_lat = torch.einsum("bhst,btl->bshl", rnd(pattn), ckv)  # [B,1,H,lora]
    o = torch.einsum("bshl,lhv->bshv", rnd(o_lat), rnd(w_uv))
    y = dense(p["wo"], o.reshape(B, 1, H * m.v_head_dim).to(cdt), cdt)
    return y, cache


def mla_decode_naive(p, x, cfg: ArchConfig, cache, lengths):
    """Decompress-then-attend decode (the oracle of the absorbed form)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    cdt = dt(cfg.compute_dtype)
    q_nope, q_rope = _mla_write(p, x, cfg, cache, lengths)
    ckv, krp = cache["c_kv"], cache["k_rope"]
    Smax = ckv.shape[1]
    kv = dense(p["wkv_b"], ckv.to(cdt), cdt).reshape(
        B, Smax, H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, krp[:, :, None, :].to(cdt).expand(
        B, Smax, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = decode_attention(q, k, v, lengths + 1,
                         scale=1.0 / math.sqrt(m.nope_head_dim
                                               + m.rope_head_dim),
                         compute_dtype=cdt)
    return dense(p["wo"], o.reshape(B, 1, -1), cdt), cache
