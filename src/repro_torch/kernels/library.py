"""The port's kernels as ``torch.library`` custom ops.

Each op has three registrations, and PyTorch's dispatcher picks one by the
device of the tensors it is given:

  * ``cuda`` — the hand-written Hopper kernel's wrapper, which launches
    the kernel (or raises) and counts the launch;
  * ``cpu`` — the kernel's plain PyTorch version (``kernels.ref``);
  * fake — allocates the output for ``meta`` and fake tensors, in the
    layout of the kernel that the tensors' device runs, so a model traced
    on the meta device (or on fake tensors, ``launch.dryrun``) reaches
    each kernel as one op.

``flash_attention`` also has an autograd registration, on every device:
its backward is plain PyTorch (``kernels.attention_grad``), as the TPU
kernel has none; training runs the kernel forward on the card and that
backward. ``flash_decode`` (and its sibling ``flash_decode_lse``, the same
launch with each row's log-sum-exp as a second output) and
``chacha20_keystream`` have no training caller and no autograd.

Nothing here catches a failure and falls back. Because each kernel is one
op, a ``TorchDispatchMode`` (``repro_torch.analysis.regions.segment``) sees
it as one leaf; :data:`KERNEL_FLOPS` holds each op's static flop count for
the cost model (``repro_torch.analysis.costs``), written from the kernel's
arithmetic — the counterpart of the reference's ``pallas_call`` = body x
grid.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import attention_grad
from repro_torch.kernels import chacha20 as _cc
from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


# ------------------------------------------------------- flash attention


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """q [B,H,Sq,D], k [B,KVH,Skv,D], v [B,KVH,Skv,Dv] -> [B,H,Sq,Dv]: the
    CUDA kernel."""
    return _fa.flash_attention(q, k, v, causal=causal)


@flash_attention.register_kernel("cpu")
def _(q, k, v, causal):
    return ref.attention_ref(q, k, v, causal=causal)


@flash_attention.register_fake
def _(q, k, v, causal):
    # the layout of the kernel that the device would run: the plain
    # version's contiguous [B,H,Sq,Dv] on the CPU, the CUDA kernel's q
    # layout elsewhere (the meta device stands for the card)
    if q.device.type == "cpu":
        return q.new_empty(q.shape[:3] + (v.shape[-1],))
    return _fa.out_like(q, v.shape[-1])


def _fa_setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal = causal


def _fa_backward(ctx, do):
    q, k, v = ctx.saved_tensors
    # a named span, so that a profile can tell the backward's share
    with obs.call("flash_attention backward"):
        dq, dk, dv = attention_grad.attention_grad(q, k, v, do,
                                                   causal=ctx.causal)
    return dq, dk, dv, None


flash_attention.register_autograd(_fa_backward,
                                  setup_context=_fa_setup_context)


# ---------------------------------------------------------- flash decode


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         device_types="cuda")
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D]: the CUDA kernel."""
    return _fd.flash_decode(q, k, v, lengths)


@flash_decode.register_kernel("cpu")
def _(q, k, v, lengths):
    return ref.decode_attention_ref(q, k, v, lengths)


@flash_decode.register_fake
def _(q, k, v, lengths):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_decode_lse", mutates_args=(),
                         device_types="cuda")
def flash_decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``flash_decode`` that also returns the fp32 [B,H] log-sum-exp of
    each row's scaled scores: the CUDA kernel, in the same launch."""
    return _fd.flash_decode(q, k, v, lengths, with_lse=True)


@flash_decode_lse.register_kernel("cpu")
def _(q, k, v, lengths):
    return ref.decode_attention_lse_ref(q, k, v, lengths)


@flash_decode_lse.register_fake
def _(q, k, v, lengths):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2],
                                             dtype=torch.float32)


# -------------------------------------------------------------- chacha20


@torch.library.custom_op("repro_torch::chacha20_keystream", mutates_args=(),
                         device_types="cuda")
def chacha20_keystream(key: torch.Tensor, nonce: torch.Tensor, counter0: int,
                       n_blocks: int) -> torch.Tensor:
    """key [8] u32, nonce [3] u32 -> [n_blocks, 16] u32: the CUDA kernel."""
    return _cc.keystream(key, nonce, counter0, n_blocks)


@chacha20_keystream.register_kernel("cpu")
def _(key, nonce, counter0, n_blocks):
    return ref.chacha20_keystream_ref(key, nonce, counter0, n_blocks)


@chacha20_keystream.register_fake
def _(key, nonce, counter0, n_blocks):
    return torch.empty((n_blocks, 16), dtype=torch.uint32, device=key.device)


# ------------------------------------------------- static flop counts

# ChaCha20 ops per block as the reference writes them: 10 double rounds x
# 8 quarter rounds x (4 adds, 4 xors, 4 rotates of 3 ops: shl, shr, or),
# plus the 16 final adds. The card issues fewer (a rotate is one SHF: 976
# a block); the cost model counts the reference's ops so the analysis stays
# comparable with the reference's artifact.
CHACHA20_OPS_PER_BLOCK = 10 * 8 * (4 + 4 + 4 * 3) + 16


def _attention_flops(q, k, v, causal):
    """The full QK^T and PV products, 2 B H Sq Skv (D + Dv), causal or
    not: an upper bound, since the kernel skips the tiles above the causal
    diagonal. The reference's static count charges the same (its ``cond``
    over the skipped blocks is costed as the max of its branches)."""
    B, H, Sq, D = q.shape
    f = 2.0 * B * H * Sq * k.shape[2] * (D + v.shape[-1])
    return f, f


def _decode_flops(q, k, v, lengths):
    """4 B H S D over the cache's S: ``lengths`` is a value a static pass
    cannot see, and the reference also costs over S."""
    B, H, D = q.shape
    f = 4.0 * B * H * k.shape[2] * D
    return f, f


def _chacha20_flops(key, nonce, counter0, n_blocks):
    """Integer vector work only: no tensor-core flops."""
    return 0.0, float(CHACHA20_OPS_PER_BLOCK * n_blocks)


# op name -> fn(*op args) -> (tensor-core flops, total flops)
KERNEL_FLOPS = {
    "repro_torch::flash_attention": _attention_flops,
    "repro_torch::flash_decode": _decode_flops,
    "repro_torch::flash_decode_lse": _decode_flops,
    "repro_torch::chacha20_keystream": _chacha20_flops,
}
