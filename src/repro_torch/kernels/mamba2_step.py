"""The Mamba2 decode step — the CUDA kernel's wrapper.

One decode step of a Mamba2 layer between its two projections, written by
hand for Hopper in ``csrc/mamba2_step.cu``: the depthwise conv over the
layer's window, dt, the fp32 state update, ``C . h``, the skip, the gate
and the gated RMSNorm, with the window and the state updated in place. Two
launches a call: the step (a block per slice of a head's rows), then the
norm (a block per batch row), which also shifts the B and C channels'
window once every head has read it. Nothing in the reference is ported
here: it computes the step as plain ops, and so does the plain version,
``repro_torch.kernels.ref.mamba2_step_ref``. The wrapper validates the
operands, allocates the output and the norm's partial sums with
``torch.empty`` (so that a captured CUDA graph replays the call) and
launches on PyTorch's current stream; it runs only on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build

# the counter of this kernel's launches (see kernels.ops.launch_counts)
LAUNCHES = "kernels.mamba2_step.launches"

# CUDA launches one call makes: the step, then the norm
LAUNCHES_PER_CALL = 2
# rows of a head a block of the step takes, a warp each: 4 x 80 blocks a
# batch row at Zamba2-2.7B's 80 heads of 64
ROWS_PER_BLOCK = 16
# what a thread holds in registers: the conv's taps (Mamba2's d_conv), and
# a lane's share of a row of the state (32 lanes x 4)
MAX_CONV_KERNEL = 4
MAX_D_STATE = 128

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 10 + [
    ctypes.c_int] * 9 + [ctypes.c_double, ctypes.c_void_p]


def dims(zx: torch.Tensor, conv: torch.Tensor, h: torch.Tensor,
         conv_w: torch.Tensor) -> tuple:
    """(B, nh, hd, N, G, K) read from the operands' shapes; raises where
    they do not fit one Mamba2 layer."""
    B, nh, hd, N = h.shape
    K, conv_ch = conv_w.shape
    d_in = nh * hd
    G = (conv_ch - d_in) // (2 * N)
    if (G < 1 or nh % G or conv_ch != d_in + 2 * G * N
            or tuple(zx.shape) != (B, 2 * d_in + 2 * G * N + nh)
            or tuple(conv.shape) != (B, K - 1, conv_ch)):
        raise ValueError(
            f"mamba2_step: shapes zx {tuple(zx.shape)}, conv "
            f"{tuple(conv.shape)}, h {tuple(h.shape)}, conv_w "
            f"{tuple(conv_w.shape)} are not one Mamba2 layer's")
    return B, nh, hd, N, G, K


def mamba2_step(zx: torch.Tensor, conv: torch.Tensor, h: torch.Tensor,
                conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                out_norm: torch.Tensor, eps: float) -> torch.Tensor:
    """zx [B, 2 d_in + 2 G N + nh] (the input projection's z, x, B, C, dt
    in the compute dtype), the window ``conv`` [B, K-1, conv_ch] and the
    state ``h`` [B, nh, hd, N] (fp32, contiguous; both updated in place),
    the layer's parameters -> the gated, normalised y [B, d_in] in the
    compute dtype."""
    B, nh, hd, N, G, K = dims(zx, conv, h, conv_w)
    tensors = dict(zx=zx, conv=conv, h=h, conv_w=conv_w, conv_b=conv_b,
                   dt_bias=dt_bias, A_log=A_log, D=D, out_norm=out_norm)
    for nm, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"mamba2_step: {nm} is on {t.device}; the "
                             "kernel runs on CUDA tensors only")
        if t.device != zx.device:
            raise ValueError(f"mamba2_step: {nm} is on {t.device}, zx on "
                             f"{zx.device}")
        if nm != "zx" and not t.is_contiguous():
            raise ValueError(f"mamba2_step: {nm} is not contiguous")
    if zx.stride(-1) != 1:
        raise ValueError("mamba2_step: zx needs a contiguous last dim")
    code, wcode = (build.DTYPE_CODES.get(str(t.dtype).removeprefix("torch."))
                   for t in (zx, conv_w))
    fp32 = (conv, h, dt_bias, A_log, D)
    if (code is None or wcode is None
            or any(t.dtype != conv_w.dtype for t in (conv_b, out_norm))
            or any(t.dtype != torch.float32 for t in fp32)):
        raise TypeError(
            "mamba2_step: zx and the weights conv_w, conv_b, out_norm take "
            "float32 or bfloat16 (the weights one dtype); conv, h, dt_bias, "
            f"A_log and D float32; got zx {zx.dtype}, weights "
            f"{conv_w.dtype} {conv_b.dtype} {out_norm.dtype}, state "
            f"{conv.dtype} {h.dtype}")
    d_in = nh * hd
    for nm, t, n in (("conv_b", conv_b, d_in + 2 * G * N),
                     ("dt_bias", dt_bias, nh), ("A_log", A_log, nh),
                     ("D", D, nh), ("out_norm", out_norm, d_in)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"mamba2_step: {nm} {tuple(t.shape)}, expected "
                             f"({n},)")
    if K > MAX_CONV_KERNEL or N > MAX_D_STATE:
        raise ValueError(f"mamba2_step: conv kernel {K} or d_state {N} above "
                         f"the kernel's {MAX_CONV_KERNEL} / {MAX_D_STATE}")
    y = torch.empty((B, d_in), dtype=zx.dtype, device=zx.device)
    if B == 0:
        return y
    P = min(hd, ROWS_PER_BLOCK)
    # each step block's sum of its rounded y^2, for the norm
    part = torch.empty(B * nh * -(-hd // P), dtype=torch.float32,
                       device=zx.device)
    fn = build.bind("mamba2_step", "mamba2_step_fwd", _ARGTYPES)
    err = fn(zx.data_ptr(), zx.stride(0), conv.data_ptr(), h.data_ptr(),
             conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
             A_log.data_ptr(), D.data_ptr(), out_norm.data_ptr(),
             y.data_ptr(), part.data_ptr(), code, wcode, B, nh, hd, N, G, K,
             P, float(eps), torch.cuda.current_stream(zx.device).cuda_stream)
    build.check("mamba2_step", err, "mamba2_step")
    obs.count(LAUNCHES, LAUNCHES_PER_CALL)
    return y
