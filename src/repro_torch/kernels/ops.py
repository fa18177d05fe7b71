"""Dispatchers for the port's attention kernels.

For CUDA tensors each dispatcher launches the hand-written Hopper kernel
(or raises); for CPU tensors it calls the kernel's plain PyTorch version
in ``kernels.ref``. The choice is made by the device of the tensors the
caller passes, never by catching a failure.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

KERNEL_MODULES = {"flash_attention": _fa, "flash_decode": _fd}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,KVH,S,D] -> [B,H,S,D]."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D]."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    return _fd.flash_decode(q, k, v, lengths)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


__all__ = ["flash_attention", "flash_decode", "launch_counts",
           "reset_launch_counts"]
