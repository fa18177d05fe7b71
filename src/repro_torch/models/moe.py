"""Mixture-of-Experts FFN on one device: the port of ``repro.models.moe``'s
local path.

``moe_local`` is the reference's capacity-bucketed dispatch: the router
runs in fp32 and picks each token's top-k experts; every (token, choice)
pair, flattened token-major, takes the next free slot of its expert's
buffer of C = max(1, ceil(T k / E x capacity_factor)) rows, and a pair that
finds its expert full is dropped (it goes to a dump row C that is sliced
off). The experts run as batched matrix products over their buffers in the
compute dtype; their rows are weighted and added back per token in fp32,
with the shared experts' output. Every shape is static (no ``nonzero``, no
boolean-mask indexing), so the model traces on the meta device.

Expert weights keep the reference's device-major layout ``[M, Epg, d,
ffl]`` / ``[M, Epg, ffl, d]``, here with M = 1 (no mesh), so the bridge
stays one-to-one.

What waits for distribution (ROADMAP): ``moe_param_specs``,
``_gather_experts`` and the sharded dispatches ``_moe_replicated_body``
(psum over the model axis) and ``_moe_a2a_body`` (all-to-all expert
parallelism), which ``moe_block`` picks on a mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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


def moe_block(p, x, cfg: ArchConfig):
    """x [B,S,d] -> (y [B,S,d], aux): the reference's ``moe_block`` without
    a mesh, which runs ``moe_local`` over the B*S tokens together."""
    B, S, d = x.shape
    y, aux = moe_local(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux
