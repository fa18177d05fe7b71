"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

Both run in fp32 math and cast the result to ``q.dtype``. The CPU path of
``repro_torch.kernels.ops`` calls them, and the chip checks hold each CUDA
kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool, scale=None) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,KVH,Skv,D] -> [B,H,Sq,D] (fp32 math).

    The causal mask is aligned to the bottom right (query i sees keys
    ``<= i + Skv - Sq``), as in the reference."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, KVH, G, Sq, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, scale=None) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D] (fp32 math)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,bktd->bkgt", qf, k.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)
