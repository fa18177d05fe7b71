"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

The attention versions run in fp32 math and cast the result to
``q.dtype``; the ChaCha20 version is bit-exact 32-bit integer arithmetic;
the Mamba2 decode step is the op sequence the port's ``mamba2_decode``
ran before it had a kernel.
The ``"cpu"`` registrations of the port's custom ops
(``repro_torch.kernels.library``) call them, and the chip checks hold each
CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# ------------------------------------------------------------- chacha20

_CHACHA_CONSTANTS = (0x61707865, 0x3320646e, 0x79622d32, 0x6b206574)
# quarter-round schedule: four columns, then four diagonals
_QR = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
       (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]
_MASK = 0xFFFFFFFF


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _MASK


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 words (or any integer tensor) as int64 values in [0, 2^32)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _MASK


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as u32 words, through their int32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def chacha20_keystream_ref(key: torch.Tensor, nonce: torch.Tensor,
                           counter0: int, n_blocks: int) -> torch.Tensor:
    """RFC 7539 ChaCha20 keystream: [n_blocks, 16] u32, row i the 64-byte
    block for counter ``counter0 + i`` (mod 2^32).

    key [8] and nonce [3] are little-endian u32 words. torch has no u32
    arithmetic, so the state is int64 masked to 32 bits after every add
    and rotate."""
    dev = key.device
    k, n = u32_to_i64(key), u32_to_i64(nonce)
    counters = (int(counter0) + torch.arange(
        n_blocks, dtype=torch.int64, device=dev)) & _MASK
    init = ([torch.full((n_blocks,), c, dtype=torch.int64, device=dev)
             for c in _CHACHA_CONSTANTS]
            + [k[i].expand(n_blocks) for i in range(8)] + [counters]
            + [n[i].expand(n_blocks) for i in range(3)])
    x = list(init)
    for _ in range(10):
        for a, b, c, d in _QR:
            x[a] = (x[a] + x[b]) & _MASK
            x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK
            x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK
            x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK
            x[b] = _rotl(x[b] ^ x[c], 7)
    out = torch.stack([(xi + si) & _MASK for xi, si in zip(x, init)], dim=1)
    return i64_to_u32(out)


# ------------------------------------------------------- attention


def math_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype attention's plain math runs in: fp32, or fp64 for fp64."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_ref(q, k, v, *, causal: bool, scale=None) -> torch.Tensor:
    """q [B,H,Sq,D], k [B,KVH,Skv,D], v [B,KVH,Skv,Dv] -> [B,H,Sq,Dv]
    (fp32 math; fp64 for fp64 inputs, so that ``gradcheck`` can hold the
    backward to it), scores scaled by 1/sqrt(D) unless ``scale`` is given.

    The causal mask is aligned to the bottom right (query i sees keys
    ``<= i + Skv - Sq``), as in the reference."""
    B, H, Sq, D = q.shape
    KVH, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    acc = math_dtype(q)
    qf = q.to(acc).reshape(B, KVH, G, Sq, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(acc)) * scale
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(acc))
    return o.reshape(B, H, Sq, Dv).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, scale=None) -> torch.Tensor:
    """q [B,H,D], k/v [B,KVH,S,D], lengths [B] -> [B,H,D] (fp32 math)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,bktd->bkgt", qf, k.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def decode_attention_lse_ref(q, k, v, lengths, *, scale=None):
    """(o [B,H,D] in ``q.dtype``, lse [B,H] fp32): the plain version of
    ``flash_decode`` with its log-sum-exp, ln sum exp of each row's scaled
    scores over the positions below ``lengths[b]``. Where a row has none,
    lse is -inf and o is 0, as the kernel gives them. fp32 math (fp64 for
    fp64 inputs)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    acc = math_dtype(q)
    s = torch.einsum("bkgd,bktd->bkgt", q.to(acc).reshape(B, KVH, G, D),
                     k.to(acc)) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0)[..., None])
    o = torch.einsum("bkgt,bktd->bkgd", p, v.to(acc))
    return o.reshape(B, H, D).to(q.dtype), lse.reshape(B, H).float()


def decode_attention_split_ref(q, k, v, lengths, *, chunk: int,
                               scale=None) -> torch.Tensor:
    """The split-KV decode kernel's arithmetic (``csrc/flash_decode.cu``) in
    plain PyTorch, for the tests: the cache cut into chunks of ``chunk``
    positions, each chunk's partial (m, l, acc) over its positions below
    ``lengths[b]`` (m = NEG_INF, l = 0, acc = 0 where it has none), then
    the merge, acc and l rescaled by exp(m - max m). fp32 math; a length
    of 0 gives 0, where the reference's oracle averages V."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    splits = max(1, -(-S // chunk))
    pad = splits * chunk - S
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              .reshape(B, KVH, splits, chunk, D) for t in (k, v))
    qf = q.float().reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,bkncd->bkgnc", qf, kf) * scale
    pos = torch.arange(splits * chunk, device=q.device).reshape(splits, chunk)
    valid = (pos[None] < lengths.clamp(0, S)[:, None, None])[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)                                      # [B,KVH,G,splits]
    p = torch.exp(s - m[..., None]) * valid
    acc = torch.einsum("bkgnc,bkncd->bkgnd", p, vf)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    o = (acc * w[..., None]).sum(-2) / (
        (p.sum(-1) * w).sum(-1)[..., None].clamp_min(1e-30))
    return o.reshape(B, H, D).to(q.dtype)


# ------------------------------------------------------- mamba2 step


def mamba2_step_ref(zx, conv, h, conv_w, conv_b, dt_bias, A_log, D, out_norm,
                    eps: float) -> torch.Tensor:
    """One Mamba2 decode step between the layer's projections, as plain
    ops: zx [B, 2 d_in + 2 G N + nh] (z, x, B, C, dt in the compute dtype)
    -> the gated, normalised y [B, d_in] in that dtype. The conv window
    ``conv`` [B, K-1, conv_ch] and the state ``h`` [B, nh, hd, N] (fp32)
    are written in place. The conv and the SSM run in fp32; y is rounded
    to the compute dtype before the RMSNorm, which runs in fp32."""
    Bsz, nh, hd, N = h.shape
    d_in = nh * hd
    G = (conv_w.shape[1] - d_in) // (2 * N)
    gn = G * N
    gz, xc, Bc, Cc, dtr = torch.split(zx, [d_in, d_in, gn, gn, nh], dim=-1)
    u = torch.cat([xc, Bc, Cc], dim=-1)                    # [B, conv_ch]
    window = torch.cat([conv, u[:, None, :].float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w.float()) \
        + conv_b.float()
    xc1, Bc1, Cc1 = torch.split(F.silu(conv_out), [d_in, gn, gn], dim=-1)
    xh = xc1.reshape(Bsz, nh, hd)
    rep = nh // G
    Bm = Bc1.reshape(Bsz, G, N).repeat_interleave(rep, 1)
    Cm = Cc1.reshape(Bsz, G, N).repeat_interleave(rep, 1)
    dtv = F.softplus(dtr.float() + dt_bias)                # [B, nh]
    dec = torch.exp(dtv * -torch.exp(A_log))
    # the outer product as a matrix product with a contraction of 1, as
    # the reference's einsum is: the cost model counts it, as the
    # reference's does, as tensor-class work
    h_new = dec[:, :, None, None] * h + \
        (xh * dtv[..., None])[..., :, None] @ Bm[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Cm, h_new) + D[None, :, None] * xh
    y = (y.reshape(Bsz, d_in) * F.silu(gz.float())).to(zx.dtype)
    yf = y.float()
    y = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    conv.copy_(window[:, 1:])
    h.copy_(h_new)
    return (y * out_norm.float()).to(zx.dtype)
