"""RWKV6 "Finch" block, the port of ``repro.models.rwkv6``: time-mix with
a data-dependent per-channel decay and channel-mix, in chunked-parallel
form, with decode as the same function at S = 1.

Recurrence (per head, k/v dims = head_size):
    y_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
with w_t = exp(-exp(w0 + tanh(x_w @ A) @ B)) (the Finch decay LoRA), the
per-step log-decay clamped at -``CLAMP_STEP`` as in the reference.

As in the reference, the WKV runs in fp32 whatever the compute dtype, and
it is plain PyTorch: the reference computes it outside any Pallas kernel,
so there is no kernel to port. A Python loop over the chunks and one over
the layers replace ``jax.lax.scan``; the chunk shrinks until it divides the
sequence (``mamba2._chunk_len``, the same rule), so a prime length runs at
one position a chunk, as in the reference.

**Finiteness.** The chunked form factors a decay product as
exp(ecum_i - c) · exp(c - cum_j), recentred by c, half the chunk's total
log-decay. A factor then reaches exp(Q · CLAMP_STEP / 2) over a chunk of Q
positions, and fp32's ``exp`` overflows above 88.7: the reference's
chunked logits are non-finite at its own ``chunk=128`` for sequences of
about 96 tokens and more, where its stepwise path (S = 1 a call) is
finite. The port holds the recurrence, which both forms compute
(``_block_len``): where Q · CLAMP_STEP / 2 < ``EXP_SAFE`` (Q <= 35) it
runs the reference's chunk, op for op; for a larger Q it runs the same
update over sub-blocks, the largest divisor of Q that is at most
``MAX_BLOCK`` (32 of the published 128), each recentred by its own half
log-decay, with the state carried between them exactly as it is carried
between chunks. A sub-block is a chunk of the same recurrence, so the
result is the recurrence's wherever the reference's chunked form is
finite, and finite where it is not. This form was picked over a per-pair
decay tensor (exp(ecum_i - cum_j) for every i > j, finite for any Q, as
``mamba2._ssd_chunk_scan`` does for its scalar decay) because RWKV6's
decay is per channel: that tensor is [B, H, Q, Q, hs], 168 MB a layer at
the published width and Q = 128, where the sub-blocks add only loop trips.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    Draw, apply_norm, dt, init_embedding, init_norm, materialize, remat_fn,
    rmsnorm, unembed,
)
from repro_torch.models.mamba2 import _chunk_len
from repro_torch.models.transformer import _embed, layer_slices

CLAMP_STEP = 5.0   # per-step log-decay floor (the reference's)
EXP_SAFE = 88.0    # largest exponent kept: fp32's exp overflows above 88.72
MAX_BLOCK = 32     # the largest sub-block of a chunk that is not safe


def _dims(cfg: ArchConfig):
    r = cfg.rwkv
    return r, cfg.d_model // r.head_size, r.head_size


def rwkv6_init(cfg: ArchConfig) -> dict:
    """One layer's parameter spec (``layers.Draw``s). ``w0`` and ``u``
    ([H, hs]) stay fp32 under any parameter dtype."""
    r, H, hs = _dims(cfg)
    d = cfg.d_model
    std = 1.0 / math.sqrt(d)
    f32 = torch.float32

    def w(shape, s=std):
        return Draw(shape, std=s)

    return {
        "tm": {
            "mu": Draw((5, d), value=0.5),          # r, k, v, g, w shifts
            "wr": w((d, d)), "wk": w((d, d)), "wv": w((d, d)),
            "wg": w((d, d)), "wo": w((d, d)),
            # decay init: half-lives spread across the channels
            "w0": Draw((H, hs), dtype=f32, linspace=(-6.0, 1.0)),
            "wA": w((d, r.decay_lora), 0.01),
            "wB": w((r.decay_lora, d), 0.01),
            "u": Draw((H, hs), std=0.1, dtype=f32),
            "ln": Draw((H, hs), value=1.0),         # per-head output norm
        },
        "cm": {
            "mu": Draw((2, d), value=0.5),          # k, r shifts
            "wk": w((d, cfg.d_ff)),
            "wv": w((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff)),
            "wr": w((d, d)),
        },
        "ln1": init_norm(d, "layernorm"),
        "ln2": init_norm(d, "layernorm"),
    }


def _shift(x, x_prev):
    """x [B,S,d]; x_prev [B,1,d] (last token of the previous segment)."""
    return torch.cat([x_prev, x[:, :-1, :]], dim=1)


def _decay(p_tm, xw, cdt):
    """Log-decay of w_t in (0, 1): [B,S,d] -> [B,S,d], in [-5, 0)."""
    lora = (torch.tanh(xw.to(cdt) @ p_tm["wA"].to(cdt))
            @ p_tm["wB"].to(cdt)).float()
    H, hs = p_tm["w0"].shape
    base = p_tm["w0"].reshape(1, 1, H * hs)
    return torch.clamp(-torch.exp(base + lora), min=-CLAMP_STEP)


def _block_len(Q: int) -> int:
    """The positions each step of the chunk loop takes for a chunk of Q:
    Q itself where its recentred factors stay finite (Q * CLAMP_STEP / 2
    < EXP_SAFE), else the largest divisor of Q that is at most
    ``MAX_BLOCK``."""
    if Q * CLAMP_STEP / 2 < EXP_SAFE:
        return Q
    return max(b for b in range(1, MAX_BLOCK + 1) if Q % b == 0)


def wkv_block_len(S: int, chunk: int) -> int:
    """The positions a step of ``_wkv_chunked``'s loop takes for a
    sequence of ``S`` at ``chunk``: S / this is the loop's trips."""
    return _block_len(_chunk_len(S, chunk))


def _wkv_chunked(r, k, v, lw, u, S0, chunk: int):
    """r, k, v [B,S,H,hs]; lw [B,S,H,hs] log-decay; u [H,hs]; S0
    [B,H,hs,hs] (k-dim x v-dim). Returns (y [B,S,H,hs], S_final). The
    loop runs the reference's chunk step over blocks of
    ``wkv_block_len(S, chunk)`` positions (module docstring)."""
    B, S, H, K = r.shape
    Q = wkv_block_len(S, chunk)
    nc = S // Q

    def to_chunks(a):
        return a.reshape(B, nc, Q, H, K)

    rc, kc, vc, lc = map(to_chunks, (r, k, v, lw))
    below = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    Sst, ys = S0, []
    for c in range(nc):
        rq, kq, vq, lq = rc[:, c], kc[:, c], vc[:, c], lc[:, c]  # [B,Q,H,K]
        cum = torch.cumsum(lq, dim=1)                       # inclusive, <= 0
        ecum = cum - lq                                     # exclusive
        # recentred so that exp() stays finite; a * b is exact:
        # exp(ecum_i - cum_j)
        half = cum[:, -1:, :, :] * 0.5                      # [B,1,H,K]
        a = rq * torch.exp(ecum - half)
        b = kq * torch.exp(half - cum)
        att = torch.einsum("bihk,bjhk->bhij", a, b)         # j < i strict
        att = torch.where(below[None, None], att, 0.0)
        bonus = torch.einsum("bihk,bihk->bih", rq * u[None, None], kq)
        # the two products over j are matrix products, as the reference's
        # einsums are, also at Q = 1 (decode), where torch.einsum would
        # multiply elementwise and the cost model would count vector work
        vh = vq.transpose(1, 2)                             # [B,H,Q,K]
        y = (att @ vh).transpose(1, 2) \
            + bonus[..., None] * vq \
            + torch.einsum("bihk,bhkv->bihv", rq * torch.exp(ecum), Sst)
        # state: S_new = diag(exp(cum_Q)) S + sum_j exp(cum_Q - cum_j) k_j v_j
        dend = torch.exp(cum[:, -1:, :, :] - cum)
        Sst = torch.exp(cum[:, -1])[..., None] * Sst \
            + (kq * dend).permute(0, 2, 3, 1) @ vh
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, K), Sst


def rwkv6_time_mix(p_tm, x, cfg: ArchConfig, x_prev, S0):
    """Returns (y [B,S,d], (last_x [B,1,d], S_final))."""
    r_cfg, H, hs = _dims(cfg)
    cdt = dt(cfg.compute_dtype)
    B, S, d = x.shape
    xs = _shift(x, x_prev)
    mu = p_tm["mu"].float()
    xr, xk, xv, xg, xw = (x * mu[i] + xs * (1 - mu[i]) for i in range(5))
    r = (xr.to(cdt) @ p_tm["wr"].to(cdt)).reshape(B, S, H, hs)
    k = (xk.to(cdt) @ p_tm["wk"].to(cdt)).reshape(B, S, H, hs)
    v = (xv.to(cdt) @ p_tm["wv"].to(cdt)).reshape(B, S, H, hs)
    g = F.silu(xg.to(cdt) @ p_tm["wg"].to(cdt))
    lw = _decay(p_tm, xw, cdt).reshape(B, S, H, hs)
    y, S_fin = _wkv_chunked(r.float(), k.float(), v.float(), lw, p_tm["u"],
                            S0, r_cfg.chunk)
    y = rmsnorm(y, p_tm["ln"]).reshape(B, S, d)
    y = y.to(cdt) * g
    return y @ p_tm["wo"].to(cdt), (x[:, -1:, :], S_fin)


def rwkv6_channel_mix(p_cm, x, cfg: ArchConfig, x_prev):
    """Returns (y [B,S,d], last_x [B,1,d])."""
    cdt = dt(cfg.compute_dtype)
    xs = _shift(x, x_prev)
    mu = p_cm["mu"].float()
    xk = x * mu[0] + xs * (1 - mu[0])
    xr = x * mu[1] + xs * (1 - mu[1])
    k = torch.square(torch.relu(xk.to(cdt) @ p_cm["wk"].to(cdt)))
    kv = k @ p_cm["wv"].to(cdt)
    return torch.sigmoid(xr.to(cdt) @ p_cm["wr"].to(cdt)) * kv, x[:, -1:, :]


def rwkv6_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    """Zeroed layer state: the token-shift inputs [B,1,d] of both mixes
    and the WKV state [B,H,hs,hs], fp32."""
    r, H, hs = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"tm_x": torch.zeros((batch, 1, cfg.d_model), **f32),
            "cm_x": torch.zeros((batch, 1, cfg.d_model), **f32),
            "S": torch.zeros((batch, H, hs, hs), **f32)}


def rwkv6_block(p, x, cfg: ArchConfig, state):
    """One layer (time-mix + channel-mix) over a segment. As in the
    reference, the states hold the last token of each mix's input (the
    normed stream), so the token shift sees the same stream in chunked
    and decode modes."""
    h = apply_norm(p["ln1"], x, "layernorm").float()
    y, (tm_x, S_fin) = rwkv6_time_mix(p["tm"], h, cfg, state["tm_x"],
                                      state["S"])
    x = x + y.to(x.dtype)
    h = apply_norm(p["ln2"], x, "layernorm").float()
    y2, cm_x = rwkv6_channel_mix(p["cm"], h, cfg, state["cm_x"])
    x = x + y2.to(x.dtype)
    return x, {"tm_x": tm_x, "cm_x": cm_x, "S": S_fin}


# ------------------------------------------------------------ LM wrapper


def rwkv6_lm_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device), each parameter allocated once in its final dtype."""
    dtype = dt(cfg.param_dtype)
    d = cfg.d_model

    def make(spec, layers=0):
        return materialize(spec, gen, dtype, device, layers=layers)

    p = make({"embed": init_embedding(cfg.vocab, d),
              "ln0": init_norm(d, "layernorm")})
    p["layers"] = make(rwkv6_init(cfg), cfg.n_layers)
    p.update(make({"final_norm": init_norm(d, "layernorm"),
                   "unembed": init_embedding(cfg.vocab, d)}))
    return p


def rwkv6_lm_states(cfg: ArchConfig, batch: int, device) -> dict:
    """Every layer's zeroed state, stacked on a leading ``[n_layers]``
    axis."""
    one = rwkv6_state_init(cfg, cfg.n_layers * batch, device)
    return {k: v.view(cfg.n_layers, batch, *v.shape[1:])
            for k, v in one.items()}


def rwkv6_lm_apply(params, tokens, cfg: ArchConfig, states=None,
                   remat: str = "none"):
    """tokens [B,S] -> (logits [B,S,V] fp32, new stacked states). The
    states passed in are read, not written. With ``remat`` other than
    "none", each layer runs under checkpoint, as in the reference."""
    B, S = tokens.shape
    x = apply_norm(params["ln0"], _embed(params, tokens, cfg), "layernorm")
    if states is None:
        states = rwkv6_lm_states(cfg, B, tokens.device)
    block = remat_fn(rwkv6_block, "none" if remat == "none" else "full")
    new = []
    for p_l, st_l in zip(layer_slices(params["layers"], cfg.n_layers),
                         layer_slices(states, cfg.n_layers)):
        x, st = block(p_l, x, cfg, st_l)
        new.append(st)
    x = apply_norm(params["final_norm"], x, "layernorm")
    return (unembed(x, params["unembed"], dt(cfg.compute_dtype)),
            {k: torch.stack([st[k] for st in new]) for k in new[0]})
