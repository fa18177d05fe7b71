"""Dispatchers for the port's kernels (port of ``repro.kernels.ops``).

Each dispatcher calls its kernel's custom op (``kernels.library``): on
CUDA tensors the dispatcher of PyTorch launches the hand-written Hopper
kernel (or raises), on CPU tensors it runs the kernel's plain PyTorch
version in ``kernels.ref``, and on meta tensors it only allocates the
output. The choice is made by the tensors' dispatch keys, never by
catching a failure.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import chacha20 as _cc
from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import library

KERNEL_MODULES = {"flash_attention": _fa, "flash_decode": _fd,
                  "chacha20": _cc}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,D], k [B,KVH,Skv,D], v [B,KVH,Skv,Dv] -> [B,H,Sq,Dv];
    ``causal`` only where Sq == Skv, on every device."""
    _fa.check_causal(q.shape[2], k.shape[2], causal)
    return library.flash_attention(q, k, v, causal)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D]."""
    with obs.span("kernels.flash_decode"):
        return library.flash_decode(q, k, v, lengths)


def flash_decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor):
    """``flash_decode`` and its fp32 [B,H] log-sum-exp: (o, lse), -inf
    where a row has no valid position (whose o is 0)."""
    with obs.span("kernels.flash_decode"):
        return library.flash_decode_lse(q, k, v, lengths)


def chacha20_keystream(key: torch.Tensor, nonce: torch.Tensor, counter0: int,
                       n_blocks: int) -> torch.Tensor:
    """key [8] u32, nonce [3] u32, counter0 (any int, taken mod 2^32) ->
    [n_blocks, 16] u32 keystream."""
    return library.chacha20_keystream(key, nonce, int(counter0) & 0xFFFFFFFF,
                                      int(n_blocks))


def chacha20_encrypt(data_u32: torch.Tensor, key: torch.Tensor,
                     nonce: torch.Tensor, counter0: int = 1) -> torch.Tensor:
    """XOR data [n_blocks, 16] u32 with the keystream from ``counter0``.

    Any block count: the kernel masks its own tail, so the reference's
    search for a tile that divides n_blocks has no counterpart. The XOR
    runs on the int32 views, which hold the same bits (torch has no u32
    arithmetic)."""
    ks = chacha20_keystream(key, nonce, counter0, data_u32.shape[0])
    return (data_u32.view(torch.int32) ^ ks.view(torch.int32)).view(
        torch.uint32)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset: the wrappers'
    counters ``kernels.<name>.launches`` (``repro_torch.obs``)."""
    return {name: obs.counter(mod.LAUNCHES)
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    obs.reset(*(mod.LAUNCHES for mod in KERNEL_MODULES.values()))


__all__ = ["chacha20_encrypt", "chacha20_keystream", "flash_attention",
           "flash_decode", "flash_decode_lse", "launch_counts",
           "reset_launch_counts"]
