"""Whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``.

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings [B, n_frames, d_model] (``Model.input_specs`` supplies them).
As in the reference, the backbone uses RoPE where the published model has
bounded absolute positions.

Parameters keep the reference's layout: ``enc_layers`` and ``dec_layers``
stacked on a leading layer axis, the head tied to ``embed``. Python loops
over the layers replace ``jax.lax.scan``. Attention runs in the port's
kernels: the encoder's self-attention is ``flash_attention`` without the
causal mask over every frame, the decoder's is causal, and its
cross-attention is ``flash_attention`` with queries and keys of their own
lengths (Sq = the tokens, Skv = the frames), not causal. Decode attends
over the self-attention cache with ``flash_decode`` (``gqa_decode``) and
over all T frames' cross-K/V with ``flash_decode`` at lengths T.

The cache is ``{"cross": {"xk", "xv"}}`` [L, B, T, KVH, hd], computed once
from the encoder's output, and ``{"self": {"k", "v"}}`` [L, B, Smax, KVH,
hd], which decode writes in place and returns. ``encdec_loss`` is the
teacher-forced decoder's mean cross-entropy; ``encode`` and
``decode_forward`` take a ``remat`` policy, applied per layer as the
reference does.

On a mesh, every large dense kernel rests split over ``model`` on its
output dim (``encdec_param_specs``, the reference's layout), and the
forward takes each such leaf as this rank's columns (``encdec_local_leaves``;
the plan ``tp`` of ``models.tp`` names them, from the sanitized specs:
``split_cols``): no weight crosses the ``model`` axis on use, the
activations do. One body serves one device and the mesh: without a plan
(``tp`` None) nothing is split and every gather is the identity. Where ``wq``/``wk``/``wv`` split in whole
heads (``tp.heads``), attention runs on this rank's heads and their
outputs are gathered into ``wo``; where the spec cuts a head, the
columns of q, k and v are gathered and every rank attends over every
head. ``wo``, ``up`` and ``down`` run column-parallel and their columns
are gathered (``up``'s after the activation). The tied ``embed`` is
gathered whole. The layer leaves come one layer at a time through the
per-layer gather (``tp.OnUse.layer``). The decode gathers the step's
q/k/v columns in one call and, where the self-attention cache rests
sharded over ``model`` on its sequence (``OnUse.cache_seq``), attends over
this rank's block, merged over the axis (``attention.decode_attend``);
the cross cache rests whole over ``model`` and is read whole.
"""
from __future__ import annotations

import torch

from typing import FrozenSet, Optional

from repro_torch.bridge import flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import P, entry_axes, map_with_specs
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (
    ACTS, apply_norm, dense, dt, init_dense, init_embedding, init_mlp,
    init_norm, materialize, remat_fn, token_ce, unembed,
)
from repro_torch.models.transformer import _embed, _positions, layer_slices


def _xattn_init(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": init_dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias),
            "wk": init_dense(d, cfg.kv_heads * hd),
            "wv": init_dense(d, cfg.kv_heads * hd),
            "wo": init_dense(cfg.n_heads * hd, d)}


def encdec_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device), each parameter allocated once in its final dtype."""
    dtype = dt(cfg.param_dtype)
    d = cfg.d_model

    def make(spec, layers=0):
        return materialize(spec, gen, dtype, device, layers=layers)

    p = {"enc_layers": make({"attn": attn.gqa_init(cfg),
                             "mlp": init_mlp(d, cfg.d_ff, cfg.glu),
                             "norm1": init_norm(d, cfg.norm),
                             "norm2": init_norm(d, cfg.norm)},
                            cfg.enc_dec.n_encoder_layers)}
    p.update(make({"enc_norm": init_norm(d, cfg.norm),
                   "embed": init_embedding(cfg.vocab, d)}))
    p["dec_layers"] = make({"self": attn.gqa_init(cfg),
                            "cross": _xattn_init(cfg),
                            "mlp": init_mlp(d, cfg.d_ff, cfg.glu),
                            "norm1": init_norm(d, cfg.norm),
                            "norm2": init_norm(d, cfg.norm),
                            "norm3": init_norm(d, cfg.norm)}, cfg.n_layers)
    p.update(make({"final_norm": init_norm(d, cfg.norm)}))
    return p


def encdec_param_specs(cfg: ArchConfig, fs, m) -> dict:
    """The reference's layout: every dense kernel ``[.., d_in, d_out]`` of
    at least 2^16 elements split over ``m`` on its last dim and over the
    FSDP axis ``fs`` on the second-last; small leaves and vectors
    replicated."""
    def one(a):
        if a.ndim <= 1 or a.numel() < 1 << 16:
            return P()
        spec = [None] * a.ndim
        spec[-1], spec[-2] = m, fs
        return P(*spec)
    return map_with_specs(one, encdec_init(None, cfg, "meta"))


def split_cols(specs: dict, m: str) -> FrozenSet[str]:
    """The dense layers (``dec_layers/self/wq`` ...) whose sanitized spec
    in ``specs`` splits the output dim over ``m``: the plan's ``cols``."""
    return frozenset(k[:-2] for k, s in flatten(specs).items()
                     if k.endswith("/w") and m in entry_axes(s[-1]))


def encdec_local_leaves(cols: FrozenSet[str], m: str) -> dict:
    """The leaves the forward takes as this rank's ``m`` columns, each at
    its ``m`` entry alone (its FSDP dim gathered on use): the kernels
    ``[L, d_in, d_out]`` of ``cols``. A bias comes whole and ``_proj``
    slices it."""
    return {c + "/w": P(None, None, m) for c in sorted(cols)}


# ------------------------------------------------- tensor-parallel parts


def _split(tp, name: str) -> bool:
    return tp is not None and name in tp.cols


def _proj(p, x, cdt, tp, name: str):
    """x through the dense layer ``name``: this rank's columns of it where
    the plan splits it (a whole bias sliced to them), else all of it."""
    if _split(tp, name) and "b" in p and p["b"].shape[-1] != p["w"].shape[-1]:
        n = p["w"].shape[-1]
        p = {"w": p["w"], "b": p["b"][..., tp.rank * n:(tp.rank + 1) * n]}
    return dense(p, x, cdt)


def _whole(tp, names, ys) -> list:
    """Each of ``ys`` (the outputs of ``_proj`` over ``names``) whole: the
    split ones gathered over the axis in one all-gather, each one's
    columns in rank order."""
    split = [i for i, n in enumerate(names) if _split(tp, n)]
    ys = list(ys)
    if not split:
        return ys
    parts = all_gather(torch.cat([ys[i] for i in split], -1)[None],
                       tp.group, 0)
    for i, part in zip(split, parts.split([ys[i].shape[-1] for i in split],
                                          -1)):
        ys[i] = part.movedim(0, -2).flatten(-2)
    return ys


def _heads(p, inputs, cfg: ArchConfig, tp, blk: str,
           whole: bool = False) -> list:
    """[B,S,n,hd] through ``blk``'s dense layers of ``inputs`` (weight name
    -> its input): this rank's heads under ``tp.heads`` unless ``whole``,
    every head otherwise (the split columns gathered in one call)."""
    cdt, hd = dt(cfg.compute_dtype), cfg.resolved_head_dim
    names = [f"{blk}/{w}" for w in inputs]
    ys = [_proj(p[w], x, cdt, tp, n)
          for (w, x), n in zip(inputs.items(), names)]
    if whole or not attn._heads(tp):
        ys = _whole(tp, names, ys)
    return [y.unflatten(-1, (-1, hd)) for y in ys]


def _qkv(p, x, cfg: ArchConfig, tp, blk: str, positions,
         whole: bool = False):
    """Self-attention's q, k, v of x [B,S,n,hd] (as ``_heads``), QK-normed
    where the block has the scales, q and k RoPE'd at ``positions``."""
    q, k, v = _heads(p, {"wq": x, "wk": x, "wv": x}, cfg, tp, blk, whole)
    return (*attn.norm_rope(p, q, k, cfg, positions), v)


def _out(p, o, cfg: ArchConfig, tp, name: str, own_heads: bool):
    """``wo`` over the attention output o [B,S,n*hd] (this rank's heads
    where ``own_heads``, gathered first), its columns gathered."""
    if own_heads:
        o = all_gather(o, tp.group, o.dim() - 1)
    return _whole(tp, [name], [_proj(p, o, dt(cfg.compute_dtype), tp,
                                     name)])[0]


def _self_attn(p, x, cfg: ArchConfig, positions, tp, blk: str,
               causal: bool):
    """Self-attention over the sequence (the encoder's, or the decoder's
    causal one)."""
    q, k, v = _qkv(p, x, cfg, tp, blk, positions)
    return _out(p["wo"], attn.attention(q, k, v, causal), cfg, tp,
                f"{blk}/wo", attn._heads(tp))


def _ffn(p, h, cfg: ArchConfig, tp, blk: str):
    """The MLP; under a plan ``up`` (and ``gate``) on this rank's columns,
    the activation gathered into ``down``, ``down``'s columns gathered."""
    cdt = dt(cfg.compute_dtype)
    u = _proj(p["up"], h, cdt, tp, f"{blk}/up")
    if cfg.glu:
        u = ACTS[cfg.act](_proj(p["gate"], h, cdt, tp, f"{blk}/gate")) * u
    else:
        u = ACTS[cfg.act](u)
    u = _whole(tp, [f"{blk}/up"], [u])[0]
    return _whole(tp, [f"{blk}/down"],
                  [_proj(p["down"], u, cdt, tp, f"{blk}/down")])[0]


def _mlp_residual(p_l, x, norm: str, cfg: ArchConfig, tp, blk: str):
    h = apply_norm(p_l[norm], x, cfg.norm)
    return x + _ffn(p_l["mlp"], h, cfg, tp, blk)


# --------------------------------------------------------------- forward


def encode(params, frames, cfg: ArchConfig, remat: str = "none",
           tp: Optional[tpm.TPPlan] = None,
           on_use: tpm.OnUse = tpm.OnUse()):
    """frames [B, T, d] (the stubbed frontend's output) -> [B, T, d]: non-
    causal self-attention over every frame, layer by layer."""
    B, T, _ = frames.shape
    x = frames.to(dt(cfg.compute_dtype))
    positions = torch.arange(T, device=frames.device).expand(B, T)

    def layer(x, p_l):
        p_l = on_use.layer(p_l, "enc_layers")
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + _self_attn(p_l["attn"], h, cfg, positions, tp,
                           "enc_layers/attn", causal=False)
        return _mlp_residual(p_l, x, "norm2", cfg, tp, "enc_layers/mlp")

    layer = remat_fn(layer, "none" if remat == "none" else "full")
    for p_l in layer_slices(params["enc_layers"],
                            cfg.enc_dec.n_encoder_layers):
        x = layer(x, p_l)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _cross_fwd(p, x, enc_kv, cfg: ArchConfig, tp=None):
    """x [B,S,d] attends over the precomputed encoder k/v [B,T,KVH,hd]
    (this rank's heads under ``tp.heads``): ``flash_attention`` at Sq = S,
    Skv = T, not causal."""
    k, v = enc_kv
    q, = _heads(p, {"wq": x}, cfg, tp, "dec_layers/cross")
    o = attn.attention(q, k, v, causal=False)
    return _out(p["wo"], o, cfg, tp, "dec_layers/cross/wo", attn._heads(tp))


def _enc_kv(p, enc_out, cfg: ArchConfig, tp=None, whole: bool = False):
    """One decoder layer's cross k and v [B,T,KVH,hd] of the encoder's
    output: under ``tp.heads`` this rank's heads unless ``whole``."""
    return _heads(p, {"wk": enc_out, "wv": enc_out}, cfg, tp,
                  "dec_layers/cross", whole)


def decode_forward(params, tokens, enc_out, cfg: ArchConfig,
                   remat: str = "none", tp: Optional[tpm.TPPlan] = None,
                   on_use: tpm.OnUse = tpm.OnUse()):
    """Teacher-forced decoder: tokens [B,S] + enc_out -> logits [B,S,V]
    fp32."""
    x = _embed(params, tokens, cfg)
    positions = _positions(tokens)

    def layer(x, p_l):
        p_l = on_use.layer(p_l, "dec_layers")
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + _self_attn(p_l["self"], h, cfg, positions, tp,
                           "dec_layers/self", causal=True)
        h = apply_norm(p_l["norm2"], x, cfg.norm)
        x = x + _cross_fwd(p_l["cross"], h,
                           _enc_kv(p_l["cross"], enc_out, cfg, tp), cfg, tp)
        return _mlp_residual(p_l, x, "norm3", cfg, tp, "dec_layers/mlp")

    layer = remat_fn(layer, "none" if remat == "none" else "full")
    for p_l in layer_slices(params["dec_layers"], cfg.n_layers):
        x = layer(x, p_l)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, params["embed"], dt(cfg.compute_dtype))   # tied head


def encdec_loss(params, frames, tokens, targets, cfg: ArchConfig,
                remat: str = "none", tp: Optional[tpm.TPPlan] = None,
                on_use: tpm.OnUse = tpm.OnUse()):
    """Mean cross-entropy of the teacher-forced decoder over the encoded
    frames: (loss, {"ce": loss})."""
    enc_out = encode(params, frames, cfg, remat, tp, on_use)
    logits = decode_forward(params, tokens, enc_out, cfg, remat, tp, on_use)
    ce = token_ce(logits, targets).mean()
    return ce, {"ce": ce}


def encdec_init_cache(params, frames, cfg: ArchConfig, batch: int,
                      max_seq: int, tp: Optional[tpm.TPPlan] = None,
                      on_use=None) -> dict:
    """Runs the encoder; returns the decode cache: every layer's cross-K/V
    in the parameter dtype, stacked on ``[n_layers]``, and zeroed self-KV
    caches of ``max_seq`` positions. ``params`` are whole unless
    ``on_use`` is given (by a sharded step: the parameters as they rest),
    and then the encoder and each layer's cross K/V run on this rank's
    columns of the plan ``tp``, every head gathered into the cross
    cache."""
    dtype = dt(cfg.param_dtype)
    if on_use is None:               # whole parameters: no plan
        tp, on_use = None, tpm.OnUse()
    enc_out = encode(params, frames, cfg, tp=tp, on_use=on_use)
    L = cfg.n_layers
    xk = torch.empty((L, *enc_out.shape[:2], cfg.kv_heads,
                      cfg.resolved_head_dim), dtype=dtype,
                     device=frames.device)
    xv = torch.empty_like(xk)
    for p_l, k_l, v_l in zip(layer_slices(params["dec_layers"], L), xk, xv):
        p_l = on_use.layer(p_l, "dec_layers")
        k, v = _enc_kv(p_l["cross"], enc_out, cfg, tp, whole=True)
        k_l.copy_(k)
        v_l.copy_(v)
    kv_self = attn.gqa_init_cache(cfg, L * batch, max_seq, dtype,
                                  frames.device)
    return {"cross": {"xk": xk, "xv": xv},
            "self": {k: v.view(L, batch, *v.shape[1:])
                     for k, v in kv_self.items()}}


def _self_decode(p, x, cfg: ArchConfig, cache, lengths, tp,
                 cache_seq: bool):
    """The decoder's self-attention of one step: every head's q/k/v of
    the step (their columns gathered in one call under a plan), the cache
    written and attended (over this rank's block of the sequence where
    ``cache_seq``), ``wo`` column-parallel."""
    B = x.shape[0]
    q, k, v = (t[:, 0] for t in _qkv(p, x, cfg, tp, "dec_layers/self",
                                     lengths[:, None], whole=True))
    o = attn.decode_attend(q, k, v, cache, lengths, tp, cache_seq)
    return _out(p["wo"], o.reshape(B, 1, -1), cfg, tp, "dec_layers/self/wo",
                False)


def encdec_decode_step(params, cache, tokens, lengths, cfg: ArchConfig,
                       tp: Optional[tpm.TPPlan] = None,
                       on_use: tpm.OnUse = tpm.OnUse()):
    """tokens [B,1], lengths [B] (tokens before this one) -> (logits [B,V],
    cache with the self-KV written in place)."""
    B = tokens.shape[0]
    cdt = dt(cfg.compute_dtype)
    x = _embed(params, tokens, cfg)
    T = cache["cross"]["xk"].shape[2]
    n_frames = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    for p_l, self_l, cross_l in zip(
            layer_slices(params["dec_layers"], cfg.n_layers),
            layer_slices(cache["self"], cfg.n_layers),
            layer_slices(cache["cross"], cfg.n_layers)):
        p_l = on_use.layer(p_l, "dec_layers")
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + _self_decode(p_l["self"], h, cfg, self_l, lengths, tp,
                             on_use.cache_seq)
        h = apply_norm(p_l["norm2"], x, cfg.norm)
        name = "dec_layers/cross/wq"
        q = _whole(tp, [name], [_proj(p_l["cross"]["wq"], h, cdt, tp,
                                      name)])[0]
        o = ops.flash_decode(q.reshape(B, cfg.n_heads, cfg.resolved_head_dim),
                             cross_l["xk"].permute(0, 2, 1, 3),
                             cross_l["xv"].permute(0, 2, 1, 3), n_frames)
        x = x + _out(p_l["cross"]["wo"], o.reshape(B, 1, -1), cfg, tp,
                     "dec_layers/cross/wo", False)
        x = _mlp_residual(p_l, x, "norm3", cfg, tp, "dec_layers/mlp")
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, params["embed"], cdt)
    return logits[:, 0], cache
