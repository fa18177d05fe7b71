"""ChaCha20 keystream — the CUDA kernel's wrapper.

Port of ``repro.kernels.chacha20``: the paper's AVX hot spot (pure 32-bit
integer add / xor / rotate, no matrix unit), written by hand for Hopper in
``csrc/chacha20.cu`` with one thread per 64-byte block and funnel-shift
rotates. The wrapper validates the operands, allocates the output, launches
on PyTorch's current stream and counts the launch. It runs only on CUDA
tensors; the plain version is
``repro_torch.kernels.ref.chacha20_keystream_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (see kernels.ops.reset_launch_counts)
launches = 0

MAX_BLOCKS = 1 << 32        # one counter space: more blocks repeat the stream

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def keystream(key: torch.Tensor, nonce: torch.Tensor, counter0: int,
              n_blocks: int) -> torch.Tensor:
    """key [8] u32, nonce [3] u32 (little-endian words), counter0 in
    [0, 2^32) -> [n_blocks, 16] u32, row i the block for counter
    ``counter0 + i`` (mod 2^32). Any n_blocks up to 2^32: no tile multiple."""
    global launches
    for nm, t, n in (("key", key, 8), ("nonce", nonce, 3)):
        if t.device.type != "cuda":
            raise ValueError(f"chacha20: {nm} is on {t.device}; the kernel "
                             "runs on CUDA tensors only")
        if t.dtype != torch.uint32 or t.shape != (n,) or t.device != key.device:
            raise ValueError(f"chacha20: {nm} must be {n} uint32 words on "
                             f"{key.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if not 0 <= counter0 < 1 << 32 or not 0 <= n_blocks <= MAX_BLOCKS:
        raise ValueError(f"chacha20: counter0 {counter0} or n_blocks "
                         f"{n_blocks} out of range")
    out = torch.empty((n_blocks, 16), dtype=torch.uint32, device=key.device)
    if n_blocks == 0:
        return out
    key, nonce = key.contiguous(), nonce.contiguous()
    fn = build.bind("chacha20", "chacha20_keystream", _ARGTYPES)
    err = fn(key.data_ptr(), nonce.data_ptr(), counter0, n_blocks,
             out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    build.check("chacha20", err, "chacha20")
    launches += 1
    return out
