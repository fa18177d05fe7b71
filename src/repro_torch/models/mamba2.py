"""Mamba2 (SSD) block, the port of ``repro.models.mamba2``: chunked
parallel forward and recurrent decode.

The SSD formulation (Dao & Gu 2024): a scalar decay A per head, dt through
softplus, a depthwise causal conv over (x, B, C), and a gated output with
RMSNorm. The chunked scan carries the state between chunks,
``h [B, nh, hd, N]``, so the forward holds one chunk's ``Q x Q`` scores at a
time. Decode keeps a conv window and ``h`` per layer, both of constant
size.

As in the reference, the SSD core runs in fp32 whatever the compute dtype
(TF32 stays off on the card), and it is plain PyTorch: the reference
computes it outside any Pallas kernel, so there is no kernel to port. A
Python loop over the chunks replaces ``jax.lax.scan``. Two behaviours of
the reference are held as they are:

* the chunk shrinks until it divides the sequence (``_chunk_len``): a
  prime length runs with one position a chunk;
* ``mamba2_prefill`` starts the conv from zeros, not from
  ``state["conv"]``; it takes only ``state["h"]``.

``mamba2_prefill`` projects its input twice, once for the conv window and
once inside the forward, as the reference does: the op stream, and so
calibration and the lint, then count what the reference counts.

The chunked scan runs in the span ``mamba2.ssd_scan`` (``chunks``,
``chunk_len``). The gated norm's
epsilon is ``SSMConfig.norm_eps``: the reference's 1e-6, or the published
Zamba2's 1e-5.

The decode step between its two projections is one custom op,
``kernels.ops.mamba2_step``: a hand-written kernel on the card (the
reference has no kernel for it), and on the CPU the op sequence the
reference computes (``kernels.ref.mamba2_step_ref``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Draw, dt, rmsnorm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_ch


def _dt_bias(u: torch.Tensor) -> torch.Tensor:
    """softplus^-1 of exp(u): the dt bias for a dt of exp(u)."""
    dt0 = torch.exp(u)
    return dt0 + torch.log(-torch.expm1(-dt0))


def mamba2_init(cfg: ArchConfig) -> dict:
    """One layer's parameter spec (``layers.Draw``s). ``dt_bias``,
    ``A_log`` and ``D`` stay fp32 under any parameter dtype."""
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    f32 = torch.float32
    return {
        "in_proj": Draw((d, proj_out), std=1.0 / math.sqrt(d)),
        "conv_w": Draw((s.conv_kernel, conv_ch), std=0.2),
        "conv_b": Draw((conv_ch,)),
        # dt in [1e-3, 1e-1], uniform in log space
        "dt_bias": Draw((nh,), dtype=f32, then=_dt_bias,
                        uniform=(math.log(1e-3), math.log(1e-1))),
        "A_log": Draw((nh,), dtype=f32, linspace=(1.0, 16.0), then=torch.log),
        "D": Draw((nh,), value=1.0, dtype=f32),
        "out_norm": Draw((d_in,), value=1.0),
        "out_proj": Draw((d_in, d), std=1.0 / math.sqrt(d_in)),
    }


def _split_proj(p, x, cfg: ArchConfig, cdt):
    """x [B,S,d] -> (gate z, x, B, C, dt) of the input projection."""
    s, d_in, nh, _ = _dims(cfg)
    z = x.to(cdt) @ p["in_proj"].to(cdt)
    gn = s.n_groups * s.d_state
    return torch.split(z, [d_in, d_in, gn, gn, nh], dim=-1)


def _conv_full(p, u, cfg: ArchConfig):
    """Depthwise causal conv over [B, S, C], then SiLU, in fp32; the result
    in ``u``'s dtype."""
    K = cfg.ssm.conv_kernel
    uf = u.float()
    pad = F.pad(uf, (0, 0, K - 1, 0))
    w = p["conv_w"].float()                                 # [K, C]
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + p["conv_b"].float()).to(u.dtype)


def _chunk_len(S: int, chunk: int) -> int:
    """The chunk ``_ssd_chunk_scan`` runs with: ``chunk``, or less, shrunk
    until it divides ``S`` (1 for a prime ``S`` above ``chunk``)."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def _ssd_chunk_scan(xh, dtv, A, Bm, Cm, h0, chunk: int):
    """Chunked SSD. xh [B,S,nh,hd]; dtv [B,S,nh] (after softplus); A [nh]
    (negative); Bm/Cm [B,S,G,N]; h0 [B,nh,hd,N]. Returns (y [B,S,nh,hd],
    h_final)."""
    Bsz, S, nh, hd = xh.shape
    G = Bm.shape[2]
    Q = _chunk_len(S, chunk)
    nc = S // Q
    rep = nh // G

    def to_chunks(a):
        return a.reshape(Bsz, nc, Q, *a.shape[2:])

    xc, dtc, Bc, Cc = map(to_chunks, (xh, dtv, Bm, Cm))
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    h, ys = h0, []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dtA = dtq * A                                       # [B,Q,nh] (<=0)
        cums = torch.cumsum(dtA, dim=1)                     # inclusive
        Bh = Bq.repeat_interleave(rep, dim=2)               # [B,Q,nh,N]
        Ch = Cq.repeat_interleave(rep, dim=2)
        xdt = xq * dtq[..., None]                           # [B,Q,nh,hd]
        # intra-chunk
        CB = torch.einsum("bihn,bjhn->bhij", Ch, Bh)        # [B,nh,Q,Q]
        seg = cums[:, :, None, :] - cums[:, None, :, :]     # [B,i,j,nh]
        # above the diagonal seg is positive and its exp may overflow:
        # masked to -inf before the exp, so L is exactly 0 there
        L = seg.masked_fill(above[None, :, :, None], -math.inf).exp()
        att = CB * L.permute(0, 3, 1, 2)                    # [B,nh,i,j]
        y = torch.einsum("bhij,bjhp->bihp", att, xdt)
        # inter-chunk (state from previous chunks)
        y = y + torch.einsum("bihn,bhpn->bihp",
                             Ch * torch.exp(cums)[..., None], h)
        # state update
        dec_end = torch.exp(cums[:, -1:, :] - cums)        # [B,Q,nh]
        h = torch.exp(cums[:, -1])[:, :, None, None] * h + torch.einsum(
            "bjhp,bjhn->bhpn", xdt * dec_end[..., None], Bh)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd)
    return y, h


def mamba2_forward(p, x, cfg: ArchConfig, h0=None):
    """x [B,S,d] -> (y [B,S,d], h_final). fp32 SSD core."""
    s, d_in, nh, conv_ch = _dims(cfg)
    cdt = dt(cfg.compute_dtype)
    Bsz, S, _ = x.shape
    gn = s.n_groups * s.d_state
    gz, xc, Bc, Cc, dtr = _split_proj(p, x, cfg, cdt)
    u = _conv_full(p, torch.cat([xc, Bc, Cc], dim=-1), cfg)
    xc, Bc, Cc = torch.split(u, [d_in, gn, gn], dim=-1)
    xh = xc.reshape(Bsz, S, nh, s.head_dim).float()
    Bm = Bc.reshape(Bsz, S, s.n_groups, s.d_state).float()
    Cm = Cc.reshape(Bsz, S, s.n_groups, s.d_state).float()
    dtv = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if h0 is None:
        h0 = torch.zeros((Bsz, nh, s.head_dim, s.d_state),
                         dtype=torch.float32, device=x.device)
    Q = _chunk_len(S, s.chunk)
    with obs.span("mamba2.ssd_scan", chunks=S // Q, chunk_len=Q):
        y, h_fin = _ssd_chunk_scan(xh, dtv, A, Bm, Cm, h0, s.chunk)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bsz, S, d_in) * F.silu(gz.float())
    y = rmsnorm(y.to(cdt), p["out_norm"], s.norm_eps)
    return y @ p["out_proj"].to(cdt), h_fin


def mamba2_init_state(cfg: ArchConfig, batch: int, device) -> dict:
    """Zeroed decode state: the conv window [B, K-1, C] and ``h``, fp32."""
    s, d_in, nh, conv_ch = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, conv_ch), **f32),
            "h": torch.zeros((batch, nh, s.head_dim, s.d_state), **f32)}


def mamba2_prefill(p, x, cfg: ArchConfig, state):
    """Forward from ``state["h"]`` that also gives the decode state at the
    end of x: the last K-1 conv inputs (zero-padded in front when x is
    shorter) and the final ``h``."""
    K = cfg.ssm.conv_kernel
    gz, xc, Bc, Cc, dtr = _split_proj(p, x, cfg, dt(cfg.compute_dtype))
    u = torch.cat([xc, Bc, Cc], dim=-1)
    S = x.shape[1]
    conv_state = u[:, -(K - 1):, :].float() if S >= K - 1 \
        else F.pad(u.float(), (0, 0, K - 1 - S, 0))
    y, h_fin = mamba2_forward(p, x, cfg, h0=state["h"])
    return y, {"conv": conv_state, "h": h_fin}


def mamba2_decode(p, x, cfg: ArchConfig, state, inplace: bool = False):
    """x [B,1,d]: one step of the recurrence. Returns (y [B,1,d], new
    state). Between the two projections the step is one op,
    ``kernels.ops.mamba2_step``: the hand-written kernel on the card, its
    plain version (``kernels.ref.mamba2_step_ref``) on the CPU. With
    ``inplace`` the new state is ``state``'s own tensors, written in place
    (each must be contiguous on the card); without, copies of them, and
    ``state`` is left as it was."""
    cdt = dt(cfg.compute_dtype)
    zx = x.to(cdt) @ p["in_proj"].to(cdt)                  # [B,1,proj]
    conv, h = state["conv"], state["h"]
    if not inplace:
        conv, h = conv.clone(), h.clone()
    y = ops.mamba2_step(zx[:, 0], conv, h, p, cfg.ssm.norm_eps)
    return y[:, None] @ p["out_proj"].to(cdt), {"conv": conv, "h": h}
