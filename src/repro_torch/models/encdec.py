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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm, dense, dt, init_dense, init_embedding, init_mlp, init_norm,
    materialize, mlp, remat_fn, token_ce, unembed,
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


def _mlp_residual(p_l, x, norm: str, cfg: ArchConfig):
    h = apply_norm(p_l[norm], x, cfg.norm)
    return x + mlp(p_l["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype))


def encode(params, frames, cfg: ArchConfig, remat: str = "none"):
    """frames [B, T, d] (the stubbed frontend's output) -> [B, T, d]: non-
    causal self-attention over every frame, layer by layer."""
    B, T, _ = frames.shape
    x = frames.to(dt(cfg.compute_dtype))
    positions = torch.arange(T, device=frames.device).expand(B, T)

    def layer(x, p_l):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + attn.gqa_forward(p_l["attn"], h, cfg, positions,
                                 causal=False)
        return _mlp_residual(p_l, x, "norm2", cfg)

    layer = remat_fn(layer, "none" if remat == "none" else "full")
    for p_l in layer_slices(params["enc_layers"],
                            cfg.enc_dec.n_encoder_layers):
        x = layer(x, p_l)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _cross_fwd(p, x, enc_kv, cfg: ArchConfig):
    """x [B,S,d] attends over the precomputed encoder k/v [B,T,KVH,hd]:
    ``flash_attention`` at Sq = S, Skv = T, not causal."""
    B, S, _ = x.shape
    cdt = dt(cfg.compute_dtype)
    q = dense(p["wq"], x, cdt).reshape(B, S, cfg.n_heads,
                                       cfg.resolved_head_dim)
    k, v = enc_kv
    return dense(p["wo"], attn.attention(q, k, v, causal=False), cdt)


def _enc_kv(p, enc_out, cfg: ArchConfig):
    """One decoder layer's cross k and v [B,T,KVH,hd] of the encoder's
    output."""
    B, T, _ = enc_out.shape
    cdt = dt(cfg.compute_dtype)
    shape = (B, T, cfg.kv_heads, cfg.resolved_head_dim)
    return (dense(p["wk"], enc_out, cdt).reshape(shape),
            dense(p["wv"], enc_out, cdt).reshape(shape))


def decode_forward(params, tokens, enc_out, cfg: ArchConfig,
                   remat: str = "none"):
    """Teacher-forced decoder: tokens [B,S] + enc_out -> logits [B,S,V]
    fp32."""
    x = _embed(params, tokens, cfg)
    positions = _positions(tokens)

    def layer(x, p_l):
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        x = x + attn.gqa_forward(p_l["self"], h, cfg, positions)
        h = apply_norm(p_l["norm2"], x, cfg.norm)
        x = x + _cross_fwd(p_l["cross"], h,
                           _enc_kv(p_l["cross"], enc_out, cfg), cfg)
        return _mlp_residual(p_l, x, "norm3", cfg)

    layer = remat_fn(layer, "none" if remat == "none" else "full")
    for p_l in layer_slices(params["dec_layers"], cfg.n_layers):
        x = layer(x, p_l)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, params["embed"], dt(cfg.compute_dtype))   # tied head


def encdec_loss(params, frames, tokens, targets, cfg: ArchConfig,
                remat: str = "none"):
    """Mean cross-entropy of the teacher-forced decoder over the encoded
    frames: (loss, {"ce": loss})."""
    enc_out = encode(params, frames, cfg, remat)
    logits = decode_forward(params, tokens, enc_out, cfg, remat)
    ce = token_ce(logits, targets).mean()
    return ce, {"ce": ce}


def encdec_init_cache(params, frames, cfg: ArchConfig, batch: int,
                      max_seq: int) -> dict:
    """Runs the encoder; returns the decode cache: every layer's cross-K/V
    in the parameter dtype, stacked on ``[n_layers]``, and zeroed self-KV
    caches of ``max_seq`` positions."""
    dtype = dt(cfg.param_dtype)
    enc_out = encode(params, frames, cfg)
    L = cfg.n_layers
    xk = torch.empty((L, *enc_out.shape[:2], cfg.kv_heads,
                      cfg.resolved_head_dim), dtype=dtype,
                     device=frames.device)
    xv = torch.empty_like(xk)
    for p_l, k_l, v_l in zip(layer_slices(params["dec_layers"], L), xk, xv):
        k, v = _enc_kv(p_l["cross"], enc_out, cfg)
        k_l.copy_(k)
        v_l.copy_(v)
    kv_self = attn.gqa_init_cache(cfg, L * batch, max_seq, dtype,
                                  frames.device)
    return {"cross": {"xk": xk, "xv": xv},
            "self": {k: v.view(L, batch, *v.shape[1:])
                     for k, v in kv_self.items()}}


def encdec_decode_step(params, cache, tokens, lengths, cfg: ArchConfig):
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
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = attn.gqa_decode(p_l["self"], h, cfg, self_l, lengths)
        x = x + y
        h = apply_norm(p_l["norm2"], x, cfg.norm)
        q = dense(p_l["cross"]["wq"], h, cdt).reshape(
            B, cfg.n_heads, cfg.resolved_head_dim)
        o = ops.flash_decode(q, cross_l["xk"].permute(0, 2, 1, 3),
                             cross_l["xv"].permute(0, 2, 1, 3), n_frames)
        x = x + dense(p_l["cross"]["wo"], o.reshape(B, 1, -1), cdt)
        x = _mlp_residual(p_l, x, "norm3", cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, params["embed"], cdt)
    return logits[:, 0], cache
