"""Shared layers: norms, RoPE, dense/GLU MLPs, plain attention, embeddings.

Port of ``repro.models.layers``. Everything is a plain function over dict
params (dense weights ``[d_in, d_out]``); stacked layer params carry a
leading layer axis. ``compute_dtype`` casting happens at matmul inputs;
norms, softmax and logits run in fp32.

``chunked_attention`` has no counterpart here: on the port's path the
``flash_attention`` kernel (``repro_torch.kernels``) and its plain version
take its place. ``full_attention`` and ``decode_attention`` stay as the
plain forms of attention in the model's ``[B, S, H, D]`` layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- dtypes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# ----------------------------------------------------------------- norms

def init_norm(d: int, norm: str, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, norm: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding.

    x: [B, S, H, D]; positions: [B, S] or [S].
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [D/2]
    ang = positions[..., None].float() * freqs               # [B, S, D/2]
    cos = torch.cos(ang)[..., None, :]                        # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- MLP / GLU

def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False) -> dict:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    p = {"w": (w * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


ACTS = {"silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh")}


def init_mlp(gen: torch.Generator, d: int, d_ff: int, glu: bool, dtype,
             device) -> dict:
    p = {"up": init_dense(gen, d, d_ff, dtype, device),
         "down": init_dense(gen, d_ff, d, dtype, device)}
    if glu:
        p["gate"] = init_dense(gen, d, d_ff, dtype, device)
    return p


def mlp(p: dict, x: torch.Tensor, act: str, glu: bool,
        compute_dtype) -> torch.Tensor:
    h = dense(p["up"], x, compute_dtype)
    if glu:
        h = ACTS[act](dense(p["gate"], x, compute_dtype)) * h
    else:
        h = ACTS[act](h)
    return dense(p["down"], h, compute_dtype)


# ------------------------------------------------------- plain attention

NEG_INF = -1e30


def _gqa_scores(q, k, compute_dtype):
    """q [B,Sq,KVH,G,D] x k [B,Skv,KVH,D] -> [B,KVH,G,Sq,Skv] fp32.

    Inputs are rounded to ``compute_dtype`` and multiplied in fp32, as
    the reference's ``preferred_element_type=float32`` does."""
    return torch.einsum("bskgd,btkd->bkgst", q.to(compute_dtype).float(),
                        k.to(compute_dtype).float())


def _gqa_readout(p, v, compute_dtype):
    """p [B,KVH,G,Sq,Skv] x v [B,Skv,KVH,D] -> [B,Sq,KVH,G,D] fp32."""
    return torch.einsum("bkgst,btkd->bskgd", p.to(compute_dtype).float(),
                        v.to(compute_dtype).float())


def full_attention(q, k, v, *, causal: bool,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Unchunked attention. q [B,Sq,H,D], k/v [B,Skv,KVH,D*] -> [B,Sq,H,Dv]."""
    B, Sq, H, Dq = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = _gqa_scores(q.reshape(B, Sq, KVH, G, Dq), k, compute_dtype) * scale
    if causal:
        if q_positions is None:
            q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
        if kv_positions is None:
            kv_positions = torch.arange(Skv, device=q.device).expand(B, Skv)
        mask = (q_positions[:, None, None, :, None]
                >= kv_positions[:, None, None, None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _gqa_readout(p, v, compute_dtype)
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: [B, 1, H, D]; k/v_cache: [B, Smax, KVH, D*]; lengths: [B] valid
    length (the new token's position is lengths-1 after cache insert).
    """
    B, _, H, Dq = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = _gqa_scores(q.reshape(B, 1, KVH, G, Dq), k_cache, compute_dtype) * scale
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _gqa_readout(p, v_cache, compute_dtype)
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# ------------------------------------------------------------- embeddings

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   device) -> torch.Tensor:
    e = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (e * 0.02).to(dtype)


def unembed(x: torch.Tensor, emb_or_w: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    """x [B,S,d] @ W [V,d]^T -> fp32 logits.

    The operands are rounded to ``compute_dtype`` and multiplied with fp32
    accumulation into fp32 logits, as the reference's
    ``preferred_element_type=float32`` does. On the card a narrow compute
    dtype goes straight to an fp32-output matmul (``out_dtype``), so the
    [V, d] table is read in its own width and never widened; the CPU has
    no such matmul and widens both operands, which gives the same sums.
    """
    xc, wc = x.to(compute_dtype), emb_or_w.to(compute_dtype)
    if xc.dtype == torch.float32 or xc.device.type == "cpu":
        return xc.float() @ wc.float().T
    y = torch.mm(xc.reshape(-1, xc.shape[-1]), wc.T, out_dtype=torch.float32)
    return y.reshape(*xc.shape[:-1], wc.shape[0])
