"""Flash-decode — the CUDA kernel's wrapper for one-token attention
against a long KV cache.

Port of ``repro.kernels.decode_attention``, written by hand for Hopper in
``csrc/flash_decode.cu``: one block per (batch, KV head) serves every
query head of the GQA group and visits only the first ``lengths[b]``
cache positions. This is the serving hot path the device-pool scheduler
treats as light and memory-bound (decode), against ``flash_attention``
(prefill, matmul-bound). The wrapper runs only on CUDA tensors; the plain
version is ``repro_torch.kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (see kernels.ops.reset_launch_counts)
launches = 0

MAX_GROUP = 16          # query heads per KV head the kernel instantiates

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D] in ``q.dtype``,
    with the scores scaled by 1/sqrt(D) as in the TPU kernel.

    Positions ``>= lengths[b]`` contribute nothing (a length of 0 gives a
    zero output). k and v may be any strided view with a contiguous last
    dimension, such as the model cache ``[B,S,KVH,D]`` permuted."""
    global launches
    code = build.check_operands("flash_decode", q=q, k=k, v=v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KVH:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if H // KVH > MAX_GROUP:
        raise ValueError(f"flash_decode: group size {H // KVH} above "
                         f"{MAX_GROUP}")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError(f"flash_decode: lengths {tuple(lengths.shape)} on "
                         f"{lengths.device}, expected ({B},) on {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *o.stride()[:2])
    fn = build.bind("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), code, B, H, KVH, S, D, strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_decode", err, "flash_decode")
    launches += 1
    return o
