"""Flash attention (prefill forward) — the CUDA kernel's wrapper.

Port of ``repro.kernels.flash_attention``: blockwise online-softmax
attention with GQA head folding and causal tile skipping, written by hand
for Hopper in ``csrc/flash_attention.cu`` (the source's header says how
it maps the Pallas kernel onto the card), widened to cross-attention:
queries and keys of lengths of their own, ``Sq`` and ``Skv``, without a
mask. Causal attention takes ``Sq == Skv`` only, as the TPU kernel's
mask assumes aligned positions. This wrapper validates the
operands, allocates the output, launches on PyTorch's current stream and
counts the launch. It runs only on CUDA tensors; the plain version is
``repro_torch.kernels.ref.attention_ref``, and the custom op in
``kernels.library`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build

# the counter of this kernel's launches (see kernels.ops.launch_counts)
LAUNCHES = "kernels.flash_attention.launches"

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]


def smem_bytes(dtype: str, D: int, Dv: int, G: int) -> int:
    """Dynamic shared memory a block asks for, for ``dtype`` ("float32" or
    "bfloat16"), q/k head dim D, v head dim Dv and GQA group G (builds
    the library if needed)."""
    fn = build.bind("flash_attention", "flash_attention_smem_bytes",
                    [ctypes.c_int] * 4)
    return fn(build.DTYPE_CODES[dtype], D, Dv, G)


def out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An uninitialised [B,H,S,dv] laid out in q's order of dims: a
    ``transpose(1, 2)`` view of a ``[B,S,H,D]`` q gives an output whose
    ``transpose(1, 2)`` is a contiguous ``[B,S,H,dv]``."""
    order = sorted(range(3), key=lambda i: q.stride(i), reverse=True)
    o = q.new_empty([q.shape[i] for i in order] + [dv])
    return o.permute(*[order.index(i) for i in range(3)], 3)


def check_causal(Sq: int, Skv: int, causal: bool) -> None:
    """Causal attention is defined here for aligned positions only."""
    if causal and Sq != Skv:
        raise ValueError(f"flash_attention: causal attention needs Sq == "
                         f"Skv (got Sq {Sq}, Skv {Skv}); the mask assumes "
                         "aligned positions")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,D], k [B,KVH,Skv,D], v [B,KVH,Skv,Dv] -> [B,H,Sq,Dv] in
    ``q.dtype``, with the scores scaled by 1/sqrt(D) as in the TPU kernel;
    (D, Dv) one of ``build.ATTENTION_DIMS``; ``causal`` only where
    ``Sq == Skv``.

    Any strides with a contiguous last dimension; the output takes q's
    order of dims (``out_like``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KVH, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape != (B, KVH, Skv, D) or v.shape != (B, KVH, Skv, Dv)
            or KVH == 0 or H % KVH or Skv == 0):
        raise ValueError(f"flash_attention: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         "(k and v of one length Skv > 0, H a multiple of "
                         "KVH)")
    check_causal(Sq, Skv, causal)
    if (D, Dv) not in build.ATTENTION_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k {D}, v {Dv}) not "
                         f"in {build.ATTENTION_DIMS}")
    code = build.check_operands("flash_attention", q=q, k=k, v=v)
    o = out_like(q, Dv)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    fn = build.bind("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
             B, H, KVH, Sq, Skv, D, Dv, strides, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err, "flash_attention")
    obs.count(LAUNCHES)
    return o
