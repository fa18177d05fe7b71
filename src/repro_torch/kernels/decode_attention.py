"""Flash-decode — the CUDA kernel's wrapper for one-token attention
against a long KV cache.

Port of ``repro.kernels.decode_attention``, written by hand for Hopper in
``csrc/flash_decode.cu``: split-KV, a block per (chunk of the cache, KV
head, batch row), each serving every query head of the GQA group and
reading only positions below ``lengths[b]``; the last block of a KV head
to finish merges the chunks' partial softmax states, in the same launch.
:func:`plan_splits` cuts the cache from the shapes alone, so the host
never reads ``lengths``. This is the serving hot path the device-pool
scheduler treats as light and memory-bound (decode), against
``flash_attention`` (prefill, matmul-bound). The wrapper runs only on
CUDA tensors; the plain version is
``repro_torch.kernels.ref.decode_attention_ref``, and
``ref.decode_attention_split_ref`` repeats the kernel's split-and-merge
arithmetic. With ``with_lse`` the same launch also writes each row's
log-sum-exp (``ref.decode_attention_lse_ref`` is its plain version), so
that a caller can merge the outputs of several shards of a cache
(``models.attention.merge_partials``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import obs
from repro_torch.kernels import build

# the counter of this kernel's launches (see kernels.ops.launch_counts)
LAUNCHES = "kernels.flash_decode.launches"

MAX_GROUP = 16          # query heads per KV head the kernel instantiates
SPLIT_ALIGN = 32        # a chunk of the cache is a multiple of this ...
MIN_CHUNK = 64          # ... and at least this many positions
# CUDA launches one call makes: the merge runs in the kernel's last block of
# each KV head
LAUNCHES_PER_CALL = 1

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_double, ctypes.c_void_p]

# per device: int32 counters, one per (batch row, KV head), that the kernel
# leaves at 0 after every call (grown, zeroed, when a call needs more)
_COUNTERS: dict = {}
# the buffers a call outgrew: a captured CUDA graph may still point at one
_OUTGROWN: list = []


def plan_splits(B: int, KVH: int, S: int, n_sm: int) -> tuple:
    """(splits, chunk): the cache axis of length S cut into ``splits``
    chunks of ``chunk`` positions (``splits * chunk >= S``), with ``chunk``
    a multiple of 32 and, when cut at all, at least 64. Enough chunks to
    give each of the ``n_sm`` SMs a block: ``B * KVH * splits >= n_sm``
    whenever ``S >= 64 * n_sm / (B * KVH)``. From the shapes only: the
    lengths stay on the card."""
    want = -(-n_sm // max(1, B * KVH))
    if want <= 1 or S <= MIN_CHUNK:
        return 1, max(1, -(-S // SPLIT_ALIGN)) * SPLIT_ALIGN
    chunk = max(MIN_CHUNK, S // want // SPLIT_ALIGN * SPLIT_ALIGN)
    return -(-S // chunk), chunk


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, kept across
    calls: the kernel sets each back to 0 before it returns. An outgrown
    buffer is kept, never freed, for the graphs that captured it."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, with_lse: bool = False,
                 scale: float | None = None):
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D] in ``q.dtype``,
    with the scores scaled by ``scale``, or by 1/sqrt(D) as in the TPU
    kernel where it is None; with
    ``with_lse`` also the fp32 [B,H] log-sum-exp of each row's scaled
    scores over its valid positions (-inf where it has none).

    Positions ``>= lengths[b]`` contribute nothing (a length of 0 gives a
    zero output). k and v may be any strided view with a contiguous last
    dimension, such as the model cache ``[B,S,KVH,D]`` permuted."""
    code = build.check_operands("flash_decode", q=q, k=k, v=v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KVH:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if D not in build.HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in "
                         f"{build.HEAD_DIMS}")
    if H // KVH > MAX_GROUP:
        raise ValueError(f"flash_decode: group size {H // KVH} above "
                         f"{MAX_GROUP}")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError(f"flash_decode: lengths {tuple(lengths.shape)} on "
                         f"{lengths.device}, expected ({B},) on {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    splits, chunk = plan_splits(B, KVH, S, sm_count(q.device.index))
    # the chunks' partial (acc, m, l) in fp32, for the merge
    part = torch.empty(B * H * splits * (D + 2) if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * KVH) if splits > 1 else None
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *o.stride()[:2])
    fn = build.bind("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), lse.data_ptr() if with_lse else None,
             part.data_ptr() if splits > 1 else None,
             counters.data_ptr() if splits > 1 else None, code, B, H, KVH,
             S, D, chunk, splits, strides, build.scale_arg(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_decode", err, "flash_decode")
    obs.count(LAUNCHES)
    return (o, lse) if with_lse else o
