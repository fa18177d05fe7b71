"""Flash attention (prefill forward) — the CUDA kernel's wrapper.

Port of ``repro.kernels.flash_attention``: blockwise online-softmax
attention with GQA head folding and causal tile skipping, written by hand
for Hopper in ``csrc/flash_attention.cu`` (the source's header says how
it maps the Pallas kernel onto the card). This wrapper validates the
operands, allocates the output, launches on PyTorch's current stream and
counts the launch. It runs only on CUDA tensors; the plain version is
``repro_torch.kernels.ref.attention_ref``, and the custom op in
``kernels.library`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (see kernels.ops.reset_launch_counts)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]


def smem_bytes(dtype: str, D: int, G: int = 1) -> int:
    """Dynamic shared memory a block asks for, for ``dtype`` ("float32" or
    "bfloat16"), head dim D and GQA group G (builds the library if
    needed)."""
    fn = build.bind("flash_attention", "flash_attention_smem_bytes",
                    [ctypes.c_int] * 3)
    return fn(build.DTYPE_CODES[dtype], D, G)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,KVH,S,D] -> [B,H,S,D] in ``q.dtype``, with the
    scores scaled by 1/sqrt(D) as in the TPU kernel.

    Any strides with a contiguous last dimension; the output takes q's
    memory layout (``empty_like``), so a ``transpose(1, 2)`` view of a
    ``[B,S,H,D]`` tensor gives an output whose ``transpose(1, 2)`` is a
    contiguous ``[B,S,H,D]``."""
    global launches
    code = build.check_operands("flash_attention", q=q, k=k, v=v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or H % KVH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Sq must equal Skv, "
                         "H a multiple of KVH)")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    fn = build.bind("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
             B, H, KVH, S, D, strides, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err, "flash_attention")
    launches += 1
    return o
