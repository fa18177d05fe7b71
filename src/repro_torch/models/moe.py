"""Mixture-of-Experts FFN with expert parallelism: the port of
``repro.models.moe``.

Three dispatch strategies, all numerically equivalent up to capacity
drops (tested against each other and against the reference):

  * ``local``      — no mesh, or a model axis of 1: ``moe_local``, the
                     reference's capacity-bucketed dispatch. The router
                     runs in fp32 and picks each token's top-k experts;
                     every (token, choice) pair, flattened token-major,
                     takes the next free slot of its expert's buffer of
                     C = max(1, ceil(T k / E x capacity_factor)) rows, and
                     a pair that finds its expert full is dropped (it goes
                     to a dump row C that is sliced off). The experts run
                     as batched matrix products over their buffers in the
                     compute dtype; their rows are weighted and added back
                     per token in fp32, with the shared experts' output.
  * ``a2a``        — expert parallelism over the model axis (or the whole
                     mesh with ``ep_over_dp``): tokens split over the model
                     ranks, bucketed per destination rank at capacity C,
                     exchanged with ``all_to_all`` (rows and their local
                     expert ids), bucketed again onto the local experts at
                     C2, the reverse ``all_to_all``, the weighted combine
                     at the source and an ``all_gather`` over the model
                     axis. Used for train/prefill (many tokens a rank).
  * ``replicated`` — every model rank routes all its tokens and computes
                     only its own experts; the partial outputs are summed
                     over the model axis. For small decode batches.

The sharded bodies run inside the caller's process group: ``x2`` is the
dp-local token block, the same on every model rank, and the expert
weights are this rank's shards (``moe_param_specs``), whose d dim
``_gather_experts`` all-gathers over the dp axes under FSDP (its
backward, the reduce-scatter, is the gradient's). Every shape is static
(no ``nonzero``, no boolean-mask indexing), so the model traces on the
meta device.

Expert-count < model-axis handling (grok: 8 experts on 16 ranks): the
expert hidden dim is split tp_e = M / E ways and each token is
dispatched to all tp_e ranks of its expert group; the partial FFN
outputs add in the source-side combine. Weight layout is therefore
device-major, ``[M, Epg, d, ffl]`` / ``[M, Epg, ffl, d]`` (``expert_layout``),
with M = 1 without a mesh, so the bridge stays one-to-one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_gather, all_to_all, pmean, psum
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.dist.sharding import P, axis_index
from repro_torch.models.layers import ACTS, Draw, dt


@dataclass(frozen=True)
class ExpertLayout:
    M: int          # model-axis size (1 = no mesh)
    ep: int         # expert-parallel degree (= gcd(E, M))
    tp_e: int       # tensor-parallel ways within an expert (= M // ep)
    epg: int        # experts per ep group (= E // ep)
    ffl: int        # local expert hidden dim (= d_ff_e // tp_e)


def expert_layout(cfg: ArchConfig, model_size: int) -> ExpertLayout:
    E = cfg.moe.n_experts
    M = max(model_size, 1)
    ep = math.gcd(E, M)
    tp_e = M // ep
    if E % ep or M % ep:
        raise ValueError(f"cannot lay out {E} experts on model axis {M}")
    ffe = cfg.moe.d_ff or cfg.d_ff
    if ffe % tp_e:
        raise ValueError(f"expert d_ff {ffe} not divisible by tp_e {tp_e}")
    return ExpertLayout(M=M, ep=ep, tp_e=tp_e, epg=E // ep, ffl=ffe // tp_e)


def moe_init(cfg: ArchConfig, model_size: int = 1) -> dict:
    """Device-major expert weights: [M, Epg, d, ffl] / [M, Epg, ffl, d],
    each expert's matrix drawn on its own."""
    lay = expert_layout(cfg, model_size)
    d = cfg.d_model
    E = cfg.moe.n_experts
    std = 1.0 / math.sqrt(d)
    std_ff = 1.0 / math.sqrt(lay.ffl * lay.tp_e)
    p = {
        "router": Draw((d, E), std),
        "up": Draw((lay.M, lay.epg, d, lay.ffl), std),
        "down": Draw((lay.M, lay.epg, lay.ffl, d), std_ff),
    }
    if cfg.glu:
        p["gate"] = Draw((lay.M, lay.epg, d, lay.ffl), std)
    if cfg.moe.n_shared:
        ffe = (cfg.moe.d_ff or cfg.d_ff) * cfg.moe.n_shared
        p["shared"] = {"up": Draw((d, ffe), std),
                       "down": Draw((ffe, d), 1.0 / math.sqrt(ffe))}
        if cfg.glu:
            p["shared"]["gate"] = Draw((d, ffe), std)
    return p


def moe_param_specs(cfg: ArchConfig, dist: DistContext) -> dict:
    """Specs matching moe_init's layout.

    Expert weights shard on the device-major EP dim (the ep axes) AND —
    when FSDP is on — over the dp axes on the d dim; the bodies
    all-gather the d dim on use, whose backward is the gradient's
    reduce-scatter. Router and shared expert are small and replicated."""
    ep = dist.ep_axes if dist.active else None
    if dist.ep_over_dp:
        fs = None          # experts fully sharded by EP itself
    else:
        fs = dist.dp_axes if (dist.fsdp and dist.dp_axes) else None
    specs = {
        "router": P(None, None),
        "up": P(ep, None, fs, None),
        "down": P(ep, None, None, fs),
    }
    if cfg.glu:
        specs["gate"] = P(ep, None, fs, None)
    if cfg.moe.n_shared:
        specs["shared"] = {"up": P(None, None), "down": P(None, None)}
        if cfg.glu:
            specs["shared"]["gate"] = P(None, None)
    return specs


def _gather_experts(p, dist: DistContext):
    """This rank's full [Epg, d, ffl] expert blocks: the FSDP-sharded d
    dim all-gathered over the dp axes. With ep_over_dp the weights are
    already whole on their rank (no FSDP dim)."""
    if dist.ep_over_dp or not (dist.fsdp and dist.dp_axes):
        return {k: (p[k][0] if k in ("up", "down", "gate") else p[k])
                for k in p}
    group = dist.mesh.group(dist.dp_axes)
    out = dict(p)
    for k, dim in (("up", 1), ("gate", 1), ("down", 2)):
        if k in p:
            out[k] = all_gather(p[k][0], group, dim)
    return out


# ------------------------------------------------------------ primitives


def _route(x, router_w, cfg: ArchConfig):
    """x [T,d] -> (weights [T,k] fp32, ids [T,k], aux dict). The top-k
    are sorted in descending order and renormalised."""
    moe = cfg.moe
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, moe.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance loss (Switch-style) + router z-loss, local means
    me = probs.mean(0)                                       # [E]
    ce = torch.zeros(moe.n_experts, dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, ids.reshape(-1), torch.full(
        (ids.numel(),), 1.0 / ids.numel(), device=x.device))
    lb = moe.n_experts * torch.sum(me * ce)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return w, ids, {"lb_loss": lb, "z_loss": z}


def _expert_ffn(hbuf, p_gate, p_up, p_down, act: str, glu: bool, cdt):
    """hbuf [E,C,d] x per-expert weights [E,d,ffl] -> [E,C,d]."""
    h = torch.bmm(hbuf.to(cdt), p_up.to(cdt))
    if glu:
        h = ACTS[act](torch.bmm(hbuf.to(cdt), p_gate.to(cdt))) * h
    else:
        h = ACTS[act](h)
    return torch.bmm(h, p_down.to(cdt))


def _shared_ffn(x, p, cfg: ArchConfig, cdt):
    h = x.to(cdt) @ p["up"].to(cdt)
    if cfg.glu:
        h = ACTS[cfg.act](x.to(cdt) @ p["gate"].to(cdt)) * h
    else:
        h = ACTS[cfg.act](h)
    return h @ p["down"].to(cdt)


# -------------------------------------------------------- local dispatch


def moe_local(p, x2, cfg: ArchConfig):
    """Single-device capacity-bucketed MoE: x2 [T,d] -> (y [T,d], aux with
    ``lb_loss``, ``z_loss`` and ``drop_frac``)."""
    moe = cfg.moe
    cdt = dt(cfg.compute_dtype)
    T, d = x2.shape
    w, ids, aux = _route(x2, p["router"], cfg)
    E = moe.n_experts
    C = max(1, int(math.ceil(T * moe.top_k / E * moe.capacity_factor)))
    f_ids = ids.reshape(-1)                                  # [T*k]
    f_w = w.reshape(-1)
    f_tok = torch.arange(T, device=x2.device).repeat_interleave(moe.top_k)
    pos = F.one_hot(f_ids, E).cumsum(0) - 1                  # token-major
    pos = pos.gather(1, f_ids[:, None])[:, 0]
    valid = pos < C
    aux["drop_frac"] = 1.0 - valid.float().mean()
    # dropped pairs land in the dump row C, sliced off
    buf = x2.new_zeros((E, C + 1, d))
    buf[f_ids, torch.where(valid, pos, C)] = x2[f_tok]
    # weights are stored device-major [M=1, Epg=E, ...]
    gate = p["gate"][0] if cfg.glu else None
    out_buf = _expert_ffn(buf[:, :C], gate, p["up"][0], p["down"][0],
                          cfg.act, cfg.glu, cdt)
    rows = out_buf[f_ids, pos.clamp(0, C - 1)]               # [T*k, d]
    rows = rows.float() * valid[:, None] * f_w[:, None]
    y = torch.zeros((T, d), dtype=torch.float32, device=x2.device)
    y.index_add_(0, f_tok, rows)
    if moe.n_shared:
        y = y + _shared_ffn(x2, p["shared"], cfg, cdt).float()
    return y.to(x2.dtype), aux


# --------------------------------------------------- sharded: replicated


def _moe_replicated_body(p, x2, cfg: ArchConfig, lay: ExpertLayout,
                         dist: DistContext):
    """Every model rank holds all the dp-local tokens, computes its own
    experts, and the partial outputs are summed over the model axis."""
    moe = cfg.moe
    cdt = dt(cfg.compute_dtype)
    T, d = x2.shape
    dev = x2.device
    pe = _gather_experts(p, dist)
    w, ids, aux = _route(x2, p["router"], cfg)
    midx = axis_index(dist.mesh, dist.model_axis) if dist.model_axis else 0
    ep_rank = midx // lay.tp_e
    # global expert id range owned by this rank: [ep_rank*epg, ...)
    f_ids = ids.reshape(-1)
    f_w = w.reshape(-1)
    f_tok = torch.arange(T, device=dev).repeat_interleave(moe.top_k)
    local = f_ids // lay.epg == ep_rank                     # mine?
    l_ids = torch.where(local, f_ids % lay.epg, lay.epg)   # epg = dump
    C = max(1, int(math.ceil(T * moe.top_k / max(lay.ep, 1)
                             * moe.capacity_factor)))
    pos = (F.one_hot(l_ids, lay.epg + 1).cumsum(0) - 1).gather(
        1, l_ids[:, None])[:, 0]
    valid = local & (pos < C)
    buf = x2.new_zeros((lay.epg + 1, C + 1, d))
    buf[torch.where(valid, l_ids, lay.epg), torch.where(valid, pos, C)] = \
        x2[f_tok]
    gate = pe["gate"] if cfg.glu else None
    out_buf = _expert_ffn(buf[:lay.epg, :C], gate, pe["up"], pe["down"],
                          cfg.act, cfg.glu, cdt)
    rows = out_buf[l_ids.clamp(0, lay.epg - 1), pos.clamp(0, C - 1)]
    rows = torch.where(valid[:, None], rows, 0) * f_w[:, None].to(rows.dtype)
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    y = y.index_add(0, f_tok, rows.float())
    if dist.model_axis is not None:
        y = psum(y, dist.mesh.group(dist.model_axis))
    if moe.n_shared:
        y = y + _shared_ffn(x2, p["shared"], cfg, cdt).float()
    aux["drop_frac"] = 1.0 - valid.sum() / local.sum().clamp_min(1)
    return y.to(x2.dtype), aux


# ---------------------------------------------------------- sharded: a2a


def _moe_a2a_body(p, x2, cfg: ArchConfig, lay: ExpertLayout,
                  dist: DistContext):
    """Token split + all_to_all EP. ``x2`` is the dp-local token block,
    the same on every model rank. With ep_over_dp the exchange spans the
    whole mesh (experts also sharded over the dp axes) while the token
    split stays per model rank: dp rows already hold distinct tokens."""
    moe = cfg.moe
    pe = _gather_experts(p, dist)
    cdt = dt(cfg.compute_dtype)
    M, tpe, epg = lay.M, lay.tp_e, lay.epg
    T, d = x2.shape
    dev = x2.device
    midx = axis_index(dist.mesh, dist.model_axis)
    Tm = T // dist.model_size
    x_my = x2[midx * Tm:(midx + 1) * Tm]                    # [Tm, d]
    w, ids, aux = _route(x_my, p["router"], cfg)

    # flat entries: token x top-k x tp_e destinations
    f_ids = ids.reshape(-1).repeat_interleave(tpe)          # [Tm*k*tpe]
    f_w = w.reshape(-1).repeat_interleave(tpe)
    f_tok = torch.arange(Tm, device=dev).repeat_interleave(
        moe.top_k * tpe)
    tp_off = torch.arange(tpe, device=dev).repeat(Tm * moe.top_k)
    dest = (f_ids // epg) * tpe + tp_off                    # destination rank
    l_ids = f_ids % epg                                     # local expert there
    C = max(1, int(math.ceil(Tm * moe.top_k * tpe / M
                             * moe.capacity_factor)))
    pos = (F.one_hot(dest, M).cumsum(0) - 1).gather(1, dest[:, None])[:, 0]
    valid = pos < C
    aux["drop_frac"] = 1.0 - valid.float().mean()
    pos_s = torch.where(valid, pos, C)
    send = x2.new_zeros((M, C + 1, d))
    send[dest, pos_s] = x_my[f_tok]
    meta = torch.full((M, C + 1), epg, dtype=torch.int64, device=dev)
    meta[dest, pos_s] = l_ids                               # epg = empty slot
    group = dist.mesh.group(dist.ep_axes)
    recv = all_to_all(send[:, :C], group)
    rmeta = all_to_all(meta[:, :C], group)
    rows = recv.reshape(M * C, d)
    r_ids = rmeta.reshape(M * C)
    # second bucketing onto the local experts
    C2 = max(1, int(math.ceil(M * C / max(epg, 1) * moe.capacity_factor)))
    pos2 = (F.one_hot(r_ids, epg + 1).cumsum(0) - 1).gather(
        1, r_ids[:, None])[:, 0]
    ok2 = (r_ids < epg) & (pos2 < C2)
    buf = x2.new_zeros((epg + 1, C2 + 1, d))
    buf[torch.where(ok2, r_ids, epg), torch.where(ok2, pos2, C2)] = rows
    gate = pe["gate"] if cfg.glu else None
    out_buf = _expert_ffn(buf[:epg, :C2], gate, pe["up"], pe["down"],
                          cfg.act, cfg.glu, cdt)
    rows_out = out_buf[r_ids.clamp(0, epg - 1), pos2.clamp(0, C2 - 1)]
    rows_out = torch.where(ok2[:, None], rows_out, 0)
    yback = all_to_all(rows_out.reshape(M, C, d), group)
    got = yback[dest, pos.clamp(0, C - 1)]                  # [F, d]
    got = torch.where(valid[:, None], got, 0) * f_w[:, None].to(got.dtype)
    y_my = torch.zeros((Tm, d), dtype=torch.float32, device=dev)
    y_my = y_my.index_add(0, f_tok, got.float())
    if moe.n_shared:
        y_my = y_my + _shared_ffn(x_my, p["shared"], cfg, cdt).float()
    y = all_gather(y_my.to(x2.dtype), dist.mesh.group(dist.model_axis), 0)
    return y, aux                                           # [T, d]


# -------------------------------------------------------------- public


def moe_block(p, x, cfg: ArchConfig, dist: DistContext = no_dist(),
              dispatch: str = "auto"):
    """x [B,S,d] -> (y [B,S,d], aux). Without a mesh, or with a model axis
    of 1, ``moe_local`` over the B*S tokens together. On a mesh ``x`` is
    this rank's dp-local block (the reference's ``P(dp, None)`` slice of
    the global batch, the same on every model rank) and ``p`` holds this
    rank's expert shards: ``a2a`` when a rank's tokens are at least 4 M,
    else ``replicated``, ``a2a`` always under ep_over_dp. The aux losses
    are averaged over the model axis and then over the dp axes."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    if not dist.active or dist.model_size == 1:
        if dist.active:
            x2 = dist.constrain(x2, P(dist.dp_axes, None))
        y, aux = moe_local(p, x2, cfg)
        return y.reshape(B, S, d), aux

    lay = expert_layout(cfg, dist.ep_size)
    tokens_per_dev = B * S                  # x is already the dp-local block
    if dist.ep_over_dp:
        dispatch = "a2a"
    elif dispatch == "auto":
        dispatch = "a2a" if tokens_per_dev >= 4 * lay.M else "replicated"
    body = _moe_a2a_body if dispatch == "a2a" else _moe_replicated_body
    y, aux = body(p, x2, cfg, lay, dist)
    model, dp = dist.mesh.group(dist.model_axis), dist.dp_axes
    aux = {k: pmean(v, model) for k, v in aux.items()}
    if dp:
        aux = {k: pmean(v, dist.mesh.group(dp)) for k, v in aux.items()}
    return y.reshape(B, S, d), aux
