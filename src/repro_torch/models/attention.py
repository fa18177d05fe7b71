"""Attention blocks: GQA (with optional QK-norm / QKV bias) and DeepSeek
MLA, the port of ``repro.models.attention``.

Each function mirrors its reference counterpart:
  gqa_init(cfg) / mla_init(cfg) -> parameter spec (``layers.Draw``s)
  *_forward(params, x, cfg, positions) -> y                  (full sequence)
  *_init_cache(cfg, batch, max_seq, dtype, device) -> cache
  *_prefill(params, x, cfg, cache, positions) -> (y, cache)  (writes cache)
  *_decode(params, x, cfg, cache, lengths) -> (y, cache)     (x is [B,1,d])

Prefill attention goes through ``kernels.ops.flash_attention`` for both
blocks (MLA with q/k head dim nope + rope and its own v head dim; the
encoder-decoder's encoder and cross-attention without the causal mask,
``attention``), GQA decode through ``flash_decode``: the hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors. Unlike the functional
reference, prefill and decode write the new K/V (or MLA's latent) into the
cache tensors in place (a copy of a serving cache per step and layer would
cost more than the attention) and return the same cache dict.

MLA caches the compressed latent (c_kv + k_rope) and decodes in the
absorbed form (W_uk folded into q, W_uv applied after attention) as
matrix products, outside any kernel, as the reference does in einsums.
``mla_decode_naive`` keeps the decompressing form as its oracle.

On a mesh with a ``model`` axis, each function takes a tensor-parallel
plan ``tp`` (``models.tp``): with ``tp.heads`` it computes this rank's
query and K/V heads (``wq``/``wk``/``wv`` or ``wq_b``/``wkv_b`` as
shards, ``wk``/``wv`` whole and sliced where the spec cuts a K/V head)
and returns the partial sums of its rows of ``wo``, which the caller sums
over the axis. The cache rests sharded over ``model`` on its sequence
where ``cache_seq`` says so (the reference's flash-decode layout):
prefill sends its heads' K/V to the ranks that hold their positions (an
all-to-all from heads to sequence), and the decode is sequence-parallel:
the step's query heads are gathered, the new K/V written on the rank that
holds position ``lengths[b]``, ``flash_decode`` run with its
log-sum-exp over this rank's shard at its local lengths, and the
partials merged over the axis in fp32 (``merge_partials``). MLA's decode
merges its latent shard's partial softmax the same way, in plain math.
"""
from __future__ import annotations

import dataclasses
import math

import torch

import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_gather, all_to_all
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    NEG_INF, Draw, apply_rope, decode_attention, dense, dt, init_dense,
    rmsnorm,
)

# =========================================================== GQA attention


def gqa_init(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": init_dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": init_dense(d, cfg.kv_heads * hd, bias=cfg.qkv_bias),
        "wv": init_dense(d, cfg.kv_heads * hd, bias=cfg.qkv_bias),
        "wo": init_dense(cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_scale"] = Draw((hd,), value=1.0)
        p["k_scale"] = Draw((hd,), value=1.0)
    return p


def _cols(p: dict, lo: int, n: int) -> dict:
    """Columns ``lo .. lo + n`` of a dense layer (and its bias)."""
    return {k: (w[..., lo:lo + n] if k == "w" else w[lo:lo + n])
            for k, w in p.items()}


def _heads(tp) -> bool:
    return tp is not None and tp.heads


def _qkv(p, x, cfg: ArchConfig, positions, tp=None):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KVH,hd] (RoPE'd q and k); this
    rank's heads under ``tp.heads``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = dt(cfg.compute_dtype)
    wk, wv = p["wk"], p["wv"]
    if _heads(tp) and not tp.kv_split:
        wk, wv = (_cols(w, tp.kv_lo * hd, tp.n_kv * hd) for w in (wk, wv))
    q = dense(p["wq"], x, cdt).reshape(B, S, -1, hd)
    k = dense(wk, x, cdt).reshape(B, S, -1, hd)
    v = dense(wv, x, cdt).reshape(B, S, -1, hd)
    return (*norm_rope(p, q, k, cfg, positions), v)


def norm_rope(p, q, k, cfg: ArchConfig, positions):
    """q and k [B,S,n,hd] QK-normed where the block has the scales, then
    RoPE'd at ``positions``."""
    if "q_scale" in p:
        q = rmsnorm(q, p["q_scale"])
        k = rmsnorm(k, p["k_scale"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def attention(q, k, v, causal: bool = True, scale=None):
    """[B,Sq,H,Dqk] q, [B,Skv,KVH,Dqk] k and [B,Skv,KVH,Dv] v ->
    [B,Sq,H*Dv] through the ``flash_attention`` dispatcher (transpose
    views, no copies), scores scaled by ``scale``, or by 1/sqrt(Dqk) where
    it is None; ``causal`` where Sq == Skv (self-attention), not causal
    for the encoder and for cross-attention."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale)
    return o.transpose(1, 2).reshape(B, S, -1)


def gqa_forward(p, x, cfg: ArchConfig, positions, tp=None):
    """Causal self-attention over the sequence, positions ``0..S-1``; this
    rank's partial sums under ``tp.heads``."""
    q, k, v = _qkv(p, x, cfg, positions, tp)
    return dense(p["wo"], attention(q, k, v), dt(cfg.compute_dtype))


def gqa_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    shp = (batch, max_seq, cfg.kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _kv_heads(blocks, tp, kv_heads: int):
    """Every K/V head from the ranks' blocks [M, ..., n_kv, hd] of their
    heads -> [..., KVH, hd]: rank r's n_kv heads in rank order, or where
    the spec cuts a K/V head (one a rank, computed by M / KVH ranks in a
    row) each head from the first of its ranks."""
    if tp.kv_split:
        return blocks.movedim(0, -3).flatten(-3, -2)
    return blocks[::tp.size // kv_heads, ..., 0, :].movedim(0, -2)


def _write_prefill(cache, new: dict, S: int, tp, cache_seq: bool) -> None:
    """Writes each of ``new`` (name -> [B,S,...], this rank's heads under
    ``tp.heads``: [B,S,n_kv,hd]) into positions ``0..S-1`` of the cache,
    in place: whole, or where ``cache_seq`` this rank's block of them, the
    heads sent to the ranks that hold their positions. Rows of ``new``
    fewer than the cache's are this rank's share of the cache's rows,
    split over the ``model`` axis (rank order) as the hybrid's prefill
    splits them; each rank's rows go to the ranks that hold their
    positions too."""
    if tp is None:
        for n, t in new.items():
            cache[n][:, :S] = t
        return
    for n, t in new.items():
        c = cache[n]
        if not cache_seq:
            if _heads(tp):
                t = _kv_heads(all_gather(t[None], tp.group, 0), tp, c.shape[2])
            c[:, :S] = t
            continue
        Sr = c.shape[1]
        valid = max(0, min(S - tp.rank * Sr, Sr))
        if _heads(tp) or t.shape[0] != c.shape[0]:
            # block j of the positions to the rank j, which receives every
            # rank's heads of its block (heads to sequence) or, where the
            # rows are split over the axis too (the hybrid's prefill),
            # every rank's rows of it (rows to sequence)
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, tp.size * Sr - S))
            t = all_to_all(t.unflatten(1, (tp.size, Sr)).movedim(1, 0),
                           tp.group)
            t = _kv_heads(t, tp, c.shape[2]) if _heads(tp) \
                else t.flatten(0, 1)
        else:
            t = t[:, tp.rank * Sr:]
        if valid:
            c[:, :valid] = t[:, :valid]


def gqa_prefill(p, x, cfg: ArchConfig, cache, positions, tp=None,
                cache_seq: bool = False):
    """Full-sequence forward that also fills cache[:, :S] (in place); this
    rank's partial sums under ``tp.heads``."""
    q, k, v = _qkv(p, x, cfg, positions, tp)
    _write_prefill(cache, {"k": k, "v": v}, x.shape[1], tp, cache_seq)
    y = dense(p["wo"], attention(q, k, v), dt(cfg.compute_dtype))
    return y, cache


def merge_partials(o, lse):
    """The attention output over R disjoint parts of the keys from each
    part's own: ``o`` [R, ..., D] (each normalised over its part) and
    ``lse`` [R, ...] (each part's log-sum-exp, -inf for an empty part) ->
    (output [..., D] fp32, its log-sum-exp). The parts weigh exp(lse - max
    lse); where every part is empty the output is 0 and the lse -inf."""
    m = lse.amax(0)
    m = torch.where(torch.isfinite(m), m, 0)
    w = torch.exp(lse - m)
    den = w.sum(0)
    out = (o.float() * w[..., None]).sum(0) / den.clamp_min(1e-30)[..., None]
    return out, m + torch.log(den)


def _write_step(cache, new: dict, lengths, tp, cache_seq: bool):
    """Writes each of ``new`` (name -> [B,...]) at position ``lengths[b]``
    (in place), where ``cache_seq`` only on the rank that holds it.
    Returns the lengths of this rank's cache after the write."""
    B = lengths.shape[0]
    bidx = torch.arange(B, device=lengths.device)
    if not cache_seq:
        for n, t in new.items():
            cache[n][bidx, lengths] = t.to(cache[n].dtype)
        return lengths + 1
    Sr = next(iter(cache.values())).shape[1]
    pos = lengths - tp.rank * Sr        # in this rank's block of Sr
    own = (pos >= 0) & (pos < Sr)
    idx = pos.clamp(0, Sr - 1)
    for n, t in new.items():
        c = cache[n]
        own_b = own.reshape((B,) + (1,) * (t.dim() - 1))
        c[bidx, idx] = torch.where(own_b, t.to(c.dtype), c[bidx, idx])
    return (pos + 1).clamp(0, Sr)


def _merge_over(o, lse, tp):
    """The partials of every rank, ``o`` [B,H,D] and ``lse`` [B,H], merged
    over the axis in fp32 (one all-gather)."""
    parts = all_gather(torch.cat([o.float(), lse[..., None]], -1)[None],
                       tp.group, 0)
    return merge_partials(parts[..., :-1], parts[..., -1])[0]


def decode_attend(q, k, v, cache, lengths, tp=None,
                  cache_seq: bool = False, scale=None):
    """One step's attention over the cache ``{"k", "v"}`` [B,Smax,KVH,hd]:
    every head's q [B,H,hd] and new k/v [B,KVH,hd] -> [B,H,hd]. Writes
    the new K/V at ``lengths`` (in place), then attends over ``lengths +
    1`` positions through ``flash_decode`` on a ``[B,KVH,Smax,hd]``
    permute view; where ``cache_seq`` the cache is this rank's block of
    the sequence, attended through ``flash_decode_lse`` and merged over
    the axis. Scores are scaled by ``scale``, or by 1/sqrt(hd) where it is
    None."""
    local = _write_step(cache, {"k": k, "v": v}, lengths, tp, cache_seq)
    kc, vc = (cache[n].permute(0, 2, 1, 3) for n in ("k", "v"))
    if cache_seq:
        return _merge_over(*ops.flash_decode_lse(q, kc, vc, local,
                                                 scale=scale),
                           tp).to(q.dtype)
    return ops.flash_decode(q, kc, vc, local, scale=scale)


def gqa_decode(p, x, cfg: ArchConfig, cache, lengths, tp=None,
               cache_seq: bool = False):
    """x: [B,1,d]; lengths[b] = number of tokens BEFORE this one.

    Writes the new K/V at ``lengths`` (in place), then attends over
    ``lengths + 1`` positions of the cache, which goes to the kernel as a
    ``[B,KVH,Smax,hd]`` permute view. Under ``tp`` every head's query
    and K/V of the step are gathered first; where ``cache_seq`` the
    attention runs over this rank's block of the sequence and the
    partials are merged over the axis; under ``tp.heads`` the result is
    this rank's partial sums of ``wo``."""
    B = x.shape[0]
    q, k, v = (t[:, 0] for t in _qkv(p, x, cfg, lengths[:, None], tp))
    if _heads(tp):
        step = all_gather(torch.cat([q, k, v], 1)[None], tp.group, 0)
        n_q, n_kv = tp.n_q, tp.n_kv
        q = step[:, :, :n_q].movedim(0, 1).reshape(B, -1, q.shape[-1])
        k, v = (_kv_heads(t, tp, cfg.kv_heads) for t in (
            step[:, :, n_q:n_q + n_kv], step[:, :, n_q + n_kv:]))
    o = decode_attend(q, k, v, cache, lengths, tp, cache_seq)
    if _heads(tp):
        o = o[:, tp.q_lo:tp.q_lo + tp.n_q]
    return dense(p["wo"], o.reshape(B, 1, -1), dt(cfg.compute_dtype)), cache


# =========================================================== MLA attention


def mla_init(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": init_dense(d, m.q_lora_rank),
        "q_norm": Draw((m.q_lora_rank,), value=1.0),
        "wq_b": init_dense(m.q_lora_rank, H * qk),
        "wkv_a": init_dense(d, m.kv_lora_rank + m.rope_head_dim),
        "kv_norm": Draw((m.kv_lora_rank,), value=1.0),
        "wkv_b": init_dense(m.kv_lora_rank,
                            H * (m.nope_head_dim + m.v_head_dim)),
        "wo": init_dense(H * m.v_head_dim, d),
    }


def _mla_q(p, x, cfg: ArchConfig, positions):
    """x [B,S,d] -> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (RoPE'd)."""
    m = cfg.mla
    B, S, _ = x.shape
    cdt = dt(cfg.compute_dtype)
    qa = rmsnorm(dense(p["wq_a"], x, cdt), p["q_norm"])
    q = dense(p["wq_b"], qa, cdt).reshape(
        B, S, -1, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg: ArchConfig, positions):
    """x [B,S,d] -> c_kv [B,S,kv_lora] and k_rope [B,S,rope], one RoPE'd
    key part shared by every head."""
    m = cfg.mla
    cdt = dt(cfg.compute_dtype)
    kv_a = dense(p["wkv_a"], x, cdt)
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_attend(p, x, cfg: ArchConfig, positions, c_kv, k_rope):
    """Causal attention over the decompressed latent: q/k head dim nope +
    rope and v head dim ``v_head_dim`` in one ``flash_attention`` call,
    scores scaled by 1/sqrt(nope + rope); over the heads whose columns
    ``wq_b`` and ``wkv_b`` hold (this rank's, under a head split)."""
    m = cfg.mla
    B, S, _ = x.shape
    cdt = dt(cfg.compute_dtype)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    kv = dense(p["wkv_b"], c_kv, cdt).reshape(
        B, S, -1, m.nope_head_dim + m.v_head_dim)
    H = kv.shape[2]
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    # the kernel takes a contiguous last dim: the shared k_rope is
    # expanded across heads and joined to each head's k_nope
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return dense(p["wo"], attention(q, k, v), cdt)


def mla_forward(p, x, cfg: ArchConfig, positions):
    """Causal MLA over the sequence, positions ``0..S-1``; on shards of
    ``wq_b``, ``wkv_b`` and ``wo`` split by heads, this rank's partial
    sums."""
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    return _mla_attend(p, x, cfg, positions, c_kv, k_rope)


def mla_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, m.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p, x, cfg: ArchConfig, cache, positions, tp=None,
                cache_seq: bool = False):
    """Full-sequence forward that also fills the latent cache[:, :S] (in
    place; where ``cache_seq``, this rank's block of it)."""
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    _write_prefill(cache, {"c_kv": c_kv, "k_rope": k_rope}, x.shape[1],
                   None if tp is None else dataclasses.replace(
                       tp, heads=False), cache_seq)
    return _mla_attend(p, x, cfg, positions, c_kv, k_rope), cache


def _mla_wkv_b_split(p, cfg: ArchConfig):
    """W_uk [lora,H,nope] and W_uv [lora,H,v], views of ``wkv_b`` (over
    the heads whose columns it holds)."""
    m = cfg.mla
    w = p["wkv_b"]["w"].reshape(m.kv_lora_rank, -1,
                                m.nope_head_dim + m.v_head_dim)
    return w[..., :m.nope_head_dim], w[..., m.nope_head_dim:]


def _mla_write(p, x, cfg: ArchConfig, cache, lengths, tp=None,
               cache_seq: bool = False):
    """The new token's q parts, and its latent written at ``lengths`` (in
    place; where ``cache_seq``, on the rank that holds the position);
    with the lengths of this rank's cache after the write."""
    positions = lengths[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    local = _write_step(cache, {"c_kv": c_kv[:, 0], "k_rope": k_rope[:, 0]},
                        lengths, tp, cache_seq)
    return q_nope, q_rope, local


def mla_decode(p, x, cfg: ArchConfig, cache, lengths, tp=None,
               cache_seq: bool = False):
    """Absorbed-form decode: scores and readout in the compressed latent
    space. As the reference's einsums with ``preferred_element_type=
    float32``, each product takes operands rounded to the compute dtype and
    gives fp32: here as fp32 products of the rounded operands, which hold
    the same values (a bf16 product would round its result to bf16).

    Under ``tp.heads`` this rank's heads' latent queries are gathered
    over the axis, and its heads of the readout give partial sums of
    ``wo``; where ``cache_seq`` each rank's block of the latent gives a
    partial softmax, merged over the axis (``merge_partials``)."""
    m = cfg.mla
    B = x.shape[0]
    cdt = dt(cfg.compute_dtype)

    def rnd(t):                     # round to the compute dtype, then fp32
        return t.to(cdt).float()

    q_nope, q_rope, local = _mla_write(p, x, cfg, cache, lengths, tp,
                                       cache_seq)
    ckv, krp = rnd(cache["c_kv"]), rnd(cache["k_rope"])
    w_uk, w_uv = _mla_wkv_b_split(p, cfg)
    q_lat = torch.einsum("bshn,lhn->bshl", rnd(q_nope), rnd(w_uk))
    if _heads(tp):                  # every head's latent query
        lora = q_lat.shape[-1]
        q = all_gather(torch.cat([q_lat, q_rope.float()], -1), tp.group, 2)
        q_lat, q_rope = q[..., :lora], q[..., lora:]
    s = (torch.einsum("bshl,btl->bhst", rnd(q_lat), ckv)
         + torch.einsum("bshr,btr->bhst", rnd(q_rope), krp))
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] \
        < local[:, None]
    if cache_seq:                   # this block's partial softmax, merged
        s = s.masked_fill(~valid[:, None, None, :], -math.inf)
        lse = torch.logsumexp(s, dim=-1)                    # [B,H,1]
        pattn = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                          0)[..., None])
        o_lat = torch.einsum("bhst,btl->bhl", rnd(pattn), ckv)
        o_lat = _merge_over(o_lat, lse[..., 0], tp)[:, None]  # [B,1,H,lora]
    else:
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)                    # [B,H,1,Smax]
        o_lat = torch.einsum("bhst,btl->bshl", rnd(pattn), ckv)
    if _heads(tp):
        o_lat = o_lat[:, :, tp.q_lo:tp.q_lo + tp.n_q]
    o = torch.einsum("bshl,lhv->bshv", rnd(o_lat), rnd(w_uv))
    y = dense(p["wo"], o.reshape(B, 1, -1).to(cdt), cdt)
    return y, cache


def mla_decode_naive(p, x, cfg: ArchConfig, cache, lengths):
    """Decompress-then-attend decode (the oracle of the absorbed form)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    cdt = dt(cfg.compute_dtype)
    q_nope, q_rope, _ = _mla_write(p, x, cfg, cache, lengths)
    ckv, krp = cache["c_kv"], cache["k_rope"]
    Smax = ckv.shape[1]
    kv = dense(p["wkv_b"], ckv.to(cdt), cdt).reshape(
        B, Smax, H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, krp[:, :, None, :].to(cdt).expand(
        B, Smax, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = decode_attention(q, k, v, lengths + 1,
                         scale=1.0 / math.sqrt(m.nope_head_dim
                                               + m.rope_head_dim),
                         compute_dtype=cdt)
    return dense(p["wo"], o.reshape(B, 1, -1), cdt), cache
