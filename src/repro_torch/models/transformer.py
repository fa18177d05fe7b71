"""Decoder-only LM: dense / MoE FFN x GQA / MLA attention, the port of
``repro.models.transformer`` (serving half).

Parameters keep the reference's layout: per-layer params stacked along a
leading layer axis under ``params["layers"]`` (``attn/wq/w``, ``norm1/scale``,
``mlp/gate/w``, ``moe/up``, ...), dense weights ``[d_in, d_out]``. A Python
loop over the layers replaces ``jax.lax.scan``. The cache is stacked the
same way: ``{"k", "v"}`` of shape ``[L, B, Smax, KVH, hd]`` for GQA,
``{"c_kv", "k_rope"}`` of shape ``[L, B, Smax, kv_lora]`` and ``[L, B, Smax,
rope]`` for MLA.

``lm_init`` allocates each stacked tensor once, in the parameter dtype,
and fills it layer by layer (and expert by expert) from the generator, so
a full-width init needs no more memory than the parameters themselves.

The training half: ``lm_backbone`` runs the layers under a remat policy
(``layers.remat_fn``: per-layer ``torch.utils.checkpoint``), summing the MoE
aux losses over the layers; ``lm_loss`` takes the cross-entropy in
sequence chunks of ``loss_chunk``, each under checkpoint, so [B, S, V]
logits never live at once (at a 152k vocab they would dominate memory);
and deepseek-v3's multi-token-prediction head, ``mtp_init`` /
``mtp_loss``. Attention goes through ``flash_attention`` forward and its
registered backward (``kernels.library``).

On a mesh (``dist``): ``lm_param_specs`` gives the reference's layout of
every leaf (TP over ``model`` on head/ff dims, FSDP over the first dp
axis on d_model dims), ``lm_init`` lays the experts out for
``dist.ep_size``, and the MoE FFN runs its explicit dispatch
(``moe.moe_block``). With a ``model`` axis of more than one rank the
layers compute that layout (``models.tp``): attention on this rank's
heads, the dense MLP on its columns, the embedding, the cross-entropy
and the logits on its rows of the vocabulary, each row-parallel product
summed over the axis where the reference constrains the residual; under
``seq_parallel`` the residual between blocks (and after the embedding)
is this rank's block of the sequence. ``lm_local_leaves`` names the
leaves the forward takes as this rank's shards, with the spec of each;
the sharded steps (``train.loop``) hand every other leaf over whole, a
layer's leaves inside the layer loop (``tp.OnUse.layer``: one layer's
weights gathered at a time, again in the backward under ``remat``
"full"), and say whether the cache rests sharded over ``model`` on its
sequence (``tp.OnUse.cache_seq``), which prefill fills and the decode
reads in place (``models.attention``).
"""
from __future__ import annotations

import torch

from repro_torch.bridge import flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.dist.sharding import P, keep_axes, map_with_specs
from repro_torch.models import attention as attn
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (
    apply_norm, dt, init_embedding, init_mlp, init_norm, materialize, mlp,
    remat_fn, token_ce, unembed, vocab_ce_sum, vocab_embed, vocab_logits,
)
from repro_torch.models.moe import moe_block, moe_init, moe_param_specs


# ------------------------------------------------------------------ init


def _layer_init(cfg: ArchConfig, model_size: int = 1) -> dict:
    """One layer's parameter spec (``layers.Draw``s); the experts laid
    out for an expert-parallel degree of ``model_size``."""
    a = attn.mla_init(cfg) if cfg.attention == "mla" else attn.gqa_init(cfg)
    p = {"attn": a,
         "norm1": init_norm(cfg.d_model, cfg.norm),
         "norm2": init_norm(cfg.d_model, cfg.norm)}
    if cfg.moe is not None:
        p["moe"] = moe_init(cfg, model_size)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.glu)
    return p


def layer_slices(layers: dict, n_layers: int) -> list:
    """Stacked layer params (or cache) -> one dict of views per layer,
    through one ``unbind`` a tensor: in training its backward stacks the L
    grads once, where L ``select``s would each write a zero-filled grad of
    the whole stack. A cache's views take in-place writes (nothing there
    requires grad), and views cost nothing in the analysis's op stream."""
    def unbind(tree):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    parts = unbind(layers)
    return [pick(parts, i) for i in range(n_layers)]


def lm_init(gen: torch.Generator, cfg: ArchConfig, device,
            dist: DistContext = no_dist()) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device): the stacked layers first, then the embeddings. Full
    tensors on every rank; the experts in ``dist.ep_size``'s layout."""
    dtype = dt(cfg.param_dtype)
    p = {"layers": materialize(_layer_init(cfg, dist.ep_size), gen, dtype,
                               device, layers=cfg.n_layers)}
    rest = {"embed": init_embedding(cfg.vocab, cfg.d_model),
            "final_norm": init_norm(cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        rest["unembed"] = init_embedding(cfg.vocab, cfg.d_model)
    p.update(materialize(rest, gen, dtype, device))
    return p


# ------------------------------------------------------------- sharding


def lm_param_specs(cfg: ArchConfig, dist: DistContext) -> dict:
    """Specs mirroring lm_init. TP over 'model' on head/ff dims, FSDP over
    the first dp axis on d_model dims. Leading layer axis never sharded."""
    if not dist.active:
        return map_with_specs(lambda _: P(), lm_init(None, cfg, "meta", dist))
    m = dist.model_axis
    fs = dist.dp_axes[0] if (dist.fsdp and dist.dp_axes) else None
    L = None  # layer-stack axis

    def stack(spec: P) -> P:
        return P(L, *spec)

    if cfg.attention == "mla":
        a = {"wq_a": stack(P(fs, None)), "q_norm": stack(P(None)),
             "wq_b": stack(P(None, m)),
             "wkv_a": stack(P(fs, None)), "kv_norm": stack(P(None)),
             "wkv_b": stack(P(None, m)),
             "wo": stack(P(m, fs))}
        a = {k: ({"w": v} if k.startswith("w") else v) for k, v in a.items()}
    else:
        a = {"wq": {"w": stack(P(fs, m))},
             "wk": {"w": stack(P(fs, m))},
             "wv": {"w": stack(P(fs, m))},
             "wo": {"w": stack(P(m, fs))}}
        if cfg.qkv_bias:
            for k in ("wq", "wk", "wv"):
                a[k]["b"] = stack(P(m))
        if cfg.qk_norm:
            a["q_scale"] = stack(P(None))
            a["k_scale"] = stack(P(None))
    specs = {"attn": a,
             "norm1": _norm_spec(cfg, stack),
             "norm2": _norm_spec(cfg, stack)}
    if cfg.moe is not None:
        specs["moe"] = map_with_specs(stack, moe_param_specs(cfg, dist))
    else:
        mp = {"up": {"w": stack(P(fs, m))}, "down": {"w": stack(P(m, fs))}}
        if cfg.glu:
            mp["gate"] = {"w": stack(P(fs, m))}
        specs["mlp"] = mp
    out = {"embed": P(m, fs),
           "layers": specs,
           "final_norm": _norm_spec(cfg, lambda s: s)}
    if not cfg.tie_embeddings:
        out["unembed"] = P(m, fs)
    return out


def _norm_spec(cfg, stack):
    s = {"scale": stack(P(None))}
    if cfg.norm == "layernorm":
        s["bias"] = stack(P(None))
    return s


def lm_local_leaves(cfg: ArchConfig, dist: DistContext) -> dict:
    """The leaves the forward takes as this rank's shards (with a model
    axis of more than 1), each with the spec it takes it at: the experts
    at theirs (the MoE dispatch gathers their dp dims itself), and the
    leaves of the tensor-parallel plan (``tp.local_leaves``) at their
    ``model`` split alone (their dp dims gathered on use)."""
    if not dist.active or dist.model_size == 1:
        return {}
    specs = flatten(lm_param_specs(cfg, dist))
    out = {f"layers/moe/{k}": specs[f"layers/moe/{k}"]
           for k in ("up", "down", "gate")
           if cfg.moe is not None and (k != "gate" or cfg.glu)}
    for k in tpm.local_leaves(cfg, dist):
        out[k] = keep_axes(specs[k], (dist.model_axis,))
    return out


# --------------------------------------------------------------- forward


def _ffn(p_l, h, cfg: ArchConfig, dist: DistContext = no_dist(),
         dispatch: str = "auto"):
    """The FFN of one layer on its normed input: (y, MoE aux or None)."""
    if cfg.moe is not None:
        return moe_block(p_l["moe"], h, cfg, dist, dispatch=dispatch)
    return mlp(p_l["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype)), None


def _leave(tp, y, split: bool, seq: bool = False):
    """A block's output on the residual: the sum of this rank's partial
    sums where the block is ``split`` over the axis, else (computed whole
    on every rank) this rank's block of it under ``seq``."""
    if tp is None:
        return y
    return tp.exit(y, seq) if split else tp.block(y, seq)


def _ffn_residual(p_l, x, cfg: ArchConfig, dist: DistContext = no_dist(),
                  dispatch: str = "auto", tp=None):
    y, _ = _ffn(p_l, apply_norm(p_l["norm2"], x, cfg.norm), cfg, dist,
                dispatch)
    return x + _leave(tp, y, tp is not None and tp.ffn)


def _out_weight(params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _embed(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens].to(dt(cfg.compute_dtype))


def _embed_tp(params, tokens, cfg: ArchConfig, tp, seq: bool = False):
    """The embedding of ``tokens``: under ``tp.vocab`` this rank's rows of
    the table, summed over the axis (this rank's block of the sequence
    under ``seq``)."""
    if tp is None or not tp.vocab:
        return _leave(tp, _embed(params, tokens, cfg), False, seq)
    return tp.exit(vocab_embed(params["embed"], tokens, tp.rank,
                               dt(cfg.compute_dtype)), seq)


def _logits(params, x, cfg: ArchConfig, tp):
    """fp32 logits [B,S,V] of x: gathered from the vocabulary's shards
    under ``tp.vocab``."""
    w, cdt = _out_weight(params, cfg), dt(cfg.compute_dtype)
    if tp is not None and tp.vocab:
        return vocab_logits(x, w, cdt, tp.group)
    return unembed(x, w, cdt)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def _layer_fwd(p_l, x, positions, cfg: ArchConfig,
               dist: DistContext = no_dist(), tp=None, seq: bool = False,
               layer=None):
    """One layer over the whole sequence: (x, MoE aux or None). ``layer``
    turns the layer's parameters as they rest into what it takes (the
    per-layer gather); under ``tp`` its blocks run tensor-parallel, and
    under ``seq`` x is this rank's block of the sequence."""
    if layer is not None:
        p_l = layer(p_l)
    h = apply_norm(p_l["norm1"], x, cfg.norm)
    h = h if tp is None else tp.enter(h, seq)
    if cfg.attention == "mla":
        y = attn.mla_forward(p_l["attn"], h, cfg, positions)
    else:
        y = attn.gqa_forward(p_l["attn"], h, cfg, positions, tp=tp)
    x = x + _leave(tp, y, tp is not None and tp.heads, seq)
    h = apply_norm(p_l["norm2"], x, cfg.norm)
    y, aux = _ffn(p_l, h if tp is None else tp.enter(h, seq), cfg, dist)
    return x + _leave(tp, y, tp is not None and tp.ffn, seq), aux


def _zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss", "drop_frac")}


def lm_backbone(params, tokens, cfg: ArchConfig, remat: str = "none",
                positions=None, dist: DistContext = no_dist(),
                on_use: tpm.OnUse = tpm.OnUse()):
    """tokens [B,S] -> (hidden [B,S,d] after the final norm, aux: the MoE
    losses and drop fraction summed over the layers, zeros without MoE).
    ``remat`` ("none", "dots" or "full") applies per layer, and the
    per-layer gather (``on_use.layer``) inside it. Under ``seq_parallel``
    (where the sequence divides the model axis) the layers run on this
    rank's block of the sequence, gathered whole after the final norm."""
    tp = tpm.plan(cfg, dist)
    seq = tp is not None and tp.seq and tokens.shape[1] % tp.size == 0
    x = _embed_tp(params, tokens, cfg, tp, seq)
    if positions is None:
        positions = _positions(tokens)
    aux = _zero_aux(tokens.device)
    layer = remat_fn(_layer_fwd, remat)
    for p_l in layer_slices(params["layers"], cfg.n_layers):
        x, aux_l = layer(p_l, x, positions, cfg, dist, tp, seq,
                         on_use.layer)
        if aux_l is not None:
            aux = {k: aux[k] + aux_l[k] for k in aux}
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return (tp.enter(x, True) if seq else x), aux


def lm_forward(params, tokens, cfg: ArchConfig, remat: str = "none"):
    """tokens [B,S] -> full logits [B,S,V] fp32 (small shapes). The
    reference also returns the aux; ``lm_backbone`` gives it here."""
    x, _ = lm_backbone(params, tokens, cfg, remat)
    return unembed(x, _out_weight(params, cfg), dt(cfg.compute_dtype))


def _ce_sum(x, w, targets, cdt):
    """Summed cross-entropy of the logits of x [B,c,d] against targets."""
    return token_ce(unembed(x, w, cdt), targets).sum()


def lm_loss(params, tokens, targets, cfg: ArchConfig, remat: str = "full",
            loss_chunk: int = 512, lb_coef: float = 0.01,
            z_coef: float = 1e-4, dist: DistContext = no_dist(),
            on_use: tpm.OnUse = tpm.OnUse()):
    """Sequence-chunked cross-entropy: chunks of ``min(loss_chunk, S)``
    positions (which must divide S, as the reference's reshape needs),
    each under checkpoint, so logits never live at [B,S,V] (under a
    vocabulary split, at [B,c,V/M]: ``layers.vocab_ce_sum``). The MoE aux
    losses are added with ``lb_coef`` and ``z_coef`` over the layers.
    Returns (loss, metrics)."""
    B, S = tokens.shape
    x, aux = lm_backbone(params, tokens, cfg, remat, dist=dist,
                         on_use=on_use)
    w = _out_weight(params, cfg)
    c = min(loss_chunk, S)
    if S % c:
        raise ValueError(f"lm_loss: loss_chunk {c} does not divide the "
                         f"sequence length {S}")
    cdt = dt(cfg.compute_dtype)
    tp = tpm.plan(cfg, dist)
    extra = (tp.group, tp.rank) if tp is not None and tp.vocab else ()
    ce_sum = remat_fn(vocab_ce_sum if extra else _ce_sum, "full")
    tot = sum(ce_sum(x[:, i:i + c], w, targets[:, i:i + c], cdt, *extra)
              for i in range(0, S, c))
    ce = tot / (B * S)
    L = cfg.n_layers
    loss = ce
    if cfg.moe is not None:
        loss = loss + lb_coef * aux["lb_loss"] / L \
            + z_coef * aux["z_loss"] / L
    return loss, {"ce": ce, **{k: v / L for k, v in aux.items()}}


# ----------------------------------------------------------------- cache


def lm_init_cache(cfg: ArchConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed per-layer caches, stacked on a leading layer axis."""
    init = attn.mla_init_cache if cfg.attention == "mla" \
        else attn.gqa_init_cache
    c = init(cfg, cfg.n_layers * batch, max_seq, dt(cfg.param_dtype), device)
    return {k: v.view(cfg.n_layers, batch, *v.shape[1:])
            for k, v in c.items()}


def lm_cache_specs(cfg: ArchConfig, dist: DistContext) -> dict:
    """KV cache: batch over dp, sequence over model (the reference's
    flash-decode SP layout)."""
    if not dist.active:
        return map_with_specs(lambda _: P(),
                              lm_init_cache(cfg, 1, 8, "meta"))
    m, dp = dist.model_axis, dist.dp_axes
    if cfg.attention == "mla":
        return {"c_kv": P(None, dp, m, None), "k_rope": P(None, dp, m, None)}
    return {"k": P(None, dp, m, None, None), "v": P(None, dp, m, None, None)}


def _serve_layers(params, x, cfg: ArchConfig, cache, dist, on_use, attend,
                  dispatch: str):
    """The layers of a prefill or a decode step: ``attend(p, h, c_l, tp,
    cache_seq) -> (y, cache)`` per layer, then the FFN; the final norm
    and the logits of the last position, [B,V] fp32."""
    tp = tpm.plan(cfg, dist)
    for p_l, c_l in zip(layer_slices(params["layers"], cfg.n_layers),
                        layer_slices(cache, cfg.n_layers)):
        p_l = on_use.layer(p_l)
        h = apply_norm(p_l["norm1"], x, cfg.norm)
        y, _ = attend(p_l["attn"], h, c_l, tp, on_use.cache_seq)
        x = x + _leave(tp, y, tp is not None and tp.heads)
        x = _ffn_residual(p_l, x, cfg, dist, dispatch, tp)
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    return _logits(params, x, cfg, tp)[:, 0, :]


def lm_prefill(params, tokens, cfg: ArchConfig, cache,
               dist: DistContext = no_dist(),
               on_use: tpm.OnUse = tpm.OnUse()):
    """Forward + cache fill (in place); returns (last-token logits [B,V],
    cache). On a mesh the MoE FFN runs its sharded dispatch, and the
    layers run tensor-parallel (``models.tp``)."""
    B, S = tokens.shape
    x = _embed_tp(params, tokens, cfg, tpm.plan(cfg, dist))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    prefill = attn.mla_prefill if cfg.attention == "mla" \
        else attn.gqa_prefill
    logits = _serve_layers(
        params, x, cfg, cache, dist, on_use,
        lambda p, h, c_l, tp, cs: prefill(p, h, cfg, c_l, positions, tp, cs),
        "auto")
    return logits, cache


def lm_decode_step(params, cache, tokens, lengths, cfg: ArchConfig,
                   dist: DistContext = no_dist(),
                   on_use: tpm.OnUse = tpm.OnUse()):
    """tokens [B,1], lengths [B] -> (logits [B,V], cache updated in place).
    On a mesh the MoE FFN runs the ``replicated`` dispatch, as the
    reference's decode does, and attention the sequence-parallel decode
    where the cache rests sharded on its sequence (``on_use.cache_seq``)."""
    x = _embed_tp(params, tokens, cfg, tpm.plan(cfg, dist))
    decode = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    logits = _serve_layers(
        params, x, cfg, cache, dist, on_use,
        lambda p, h, c_l, tp, cs: decode(p, h, cfg, c_l, lengths, tp, cs),
        "replicated")
    return logits, cache


# ------------------------------------------------- optional: MTP head
# deepseek-v3 trains with a multi-token-prediction module: one extra
# transformer layer predicting token t+2 from [h_t ; emb(t+1)].


def mtp_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The MTP head's parameters: ``proj`` [2d, d] and one layer."""
    return materialize({"proj": init_embedding(2 * cfg.d_model, cfg.d_model),
                        "layer": _layer_init(cfg)}, gen,
                       dt(cfg.param_dtype), device)


def mtp_loss(params, mtp_params, tokens, targets2, cfg: ArchConfig,
             remat: str = "none"):
    """targets2 = tokens shifted by 2. Returns the MTP head's mean CE."""
    cdt = dt(cfg.compute_dtype)
    h, _ = lm_backbone(params, tokens, cfg, remat)
    nxt = _embed(params, torch.roll(tokens, -1, dims=1), cfg)
    z = torch.cat([h.to(cdt), nxt], dim=-1)
    x = z @ mtp_params["proj"].to(cdt)
    x, _ = _layer_fwd(mtp_params["layer"], x, _positions(tokens), cfg)
    return token_ce(unembed(x, _out_weight(params, cfg), cdt),
                    targets2).mean()
