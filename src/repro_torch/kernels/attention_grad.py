"""The backward of ``flash_attention``, in plain PyTorch.

The TPU kernel (``repro.kernels.flash_attention``) is forward-only: it has
no ``custom_vjp``, and the reference trains through the pure-JAX
``chunked_attention``, which XLA differentiates. So there is no backward
kernel to port. The port's forward on the card is the hand-written kernel,
and its gradient is this function, registered as the op's autograd
(``kernels.library``), like every other gradient of the model: PyTorch,
not a kernel.

For one (batch, head) with P = softmax(s · Q Kᵀ) (s the score scale, the
causal mask aligned to the bottom right as in ``ref.attention_ref``) and
O = P V, the gradients of a loss with dO = ∂L/∂O are

    dV = Pᵀ dO
    dS = P ∘ (dO Vᵀ − rowsum(dO ∘ O))
    dQ = s · dS K
    dK = s · dSᵀ Q

with GQA's dK and dV summed over the heads of a group. rowsum(dO ∘ O)
equals rowsum(P ∘ dO Vᵀ), and this takes it in that form: a query block
holds whole rows of P, so the forward's output need not be saved.

The math runs in fp32 (fp64 for fp64 inputs, for ``gradcheck``) over
blocks of ``block`` queries, so at most [B, H, block, Skv] scores (and
three tensors like them) live at once; a whole [B, H, S, S] at a 4k
training sequence would be gigabytes. Under the causal mask a block stops
at the last key its last query sees. The grads come back in the inputs'
dtypes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import NEG_INF, math_dtype

BLOCK = 128


def attention_grad(q, k, v, do, *, causal: bool, block: int = BLOCK,
                   scale=None):
    """q [B,H,Sq,D], k [B,KVH,Skv,D], v [B,KVH,Skv,Dv] and the output's
    gradient do [B,H,Sq,Dv] -> (dq, dk, dv) in q's, k's and v's dtypes,
    for the attention of ``ref.attention_ref`` (scores scaled by
    ``scale``, or by 1/sqrt(D) where it is None, as the forward kernel
    scales them). Any strides."""
    B, H, Sq, D = q.shape
    KVH, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    acc = math_dtype(q)
    qf = q.to(acc).reshape(B, KVH, G, Sq, D)
    dof = do.to(acc).reshape(B, KVH, G, Sq, Dv)
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty_like(qf)
    dk = torch.zeros((B, KVH, Skv, D), dtype=acc, device=q.device)
    dv = torch.zeros((B, KVH, Skv, Dv), dtype=acc, device=q.device)
    offset = Skv - Sq              # query i sees keys <= i + offset
    for s0 in range(0, Sq, block):
        s1 = min(s0 + block, Sq)
        # keys past the block's last visible one get P = 0: leave them out
        # (unless a row sees no key at all, where the softmax is uniform)
        end = min(Skv, s1 + offset) if causal and s0 + offset >= 0 else Skv
        qb, dob = qf[:, :, :, s0:s1], dof[:, :, :, s0:s1]
        kb, vb = kf[:, :, :end], vf[:, :, :end]
        s = torch.einsum("bkgsd,bktd->bkgst", qb, kb) * scale
        if causal:
            rows = torch.arange(s0, s1, device=q.device)[:, None]
            cols = torch.arange(end, device=q.device)[None, :]
            s = torch.where(cols <= rows + offset, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bkgsd,bktd->bkgst", dob, vb)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dv[:, :, :end] += torch.einsum("bkgst,bkgsd->bktd", p, dob)
        dq[:, :, :, s0:s1] = torch.einsum("bkgst,bktd->bkgsd", ds,
                                          kb) * scale
        dk[:, :, :end] += torch.einsum("bkgst,bkgsd->bktd", ds, qb) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
