"""Zamba2-style hybrid, the port of ``repro.models.hybrid``: a Mamba2
backbone and one weight-tied shared attention + MLP block applied every
``shared_attn_every`` backbone layers.

zamba2-2.7b has 54 Mamba2 layers in 9 groups of 6; after each group the
same (shared) GQA attention + MLP block runs, with a KV cache of its own
for each application. As in the reference, the shared block's input is
the plain residual stream (the published model also concatenates the
embedding stream and alternates two shared blocks with LoRA adapters).

``HybridConfig.published`` selects the published Zamba2 block instead
(Zyphra's Zamba2, as ``transformers``' ``modeling_zamba2`` computes it).
With ``e`` the embedding and k counting the applications, a backbone
layer i is ``x += Mamba2(norm_i(x))``, and a hybrid layer i (one of
``layer_ids``) is

    a = norm1([x; e]);  o = W_o attn(W_q a, W_k a, W_v a)
    [g; u] = W_gu norm2(o) + B_k A_k norm2(o);  f = W_down(act(g) * u)
    x += Mamba2(norm_i(x + L_k f))

with the block ``k mod n_blocks`` giving W_q .. W_down and both norms,
and ``A_k``, ``B_k`` (the MLP adapter) and ``L_k`` the application's own:
no residual inside the block, no RoPE, scores scaled by
(head_dim / 2)^-1/2. Its parameters are ``blocks`` (stacked on
``[n_blocks]``, ``mlp/gate_up`` one ``[d, 2 d_ff]`` product) and
``apps`` (stacked on the applications); with ``tie_embeddings`` the
logits read ``embed``. It serves on one device; on a mesh it raises.
Its prefill starts each request's recurrence from zero, whatever the
cache it is given holds, so the executor may reuse a cache and replay a
captured CUDA graph of its decode step (``Model.graph_decode``).

Each Mamba2 layer of a prefill or decode step runs in the span
``model.mamba`` (``layer``, ``phase``), each application of the shared
block in ``model.shared`` (``application``, ``block``, ``phase``; for the
published block from the concatenation through ``L_k``).

Parameters keep the reference's layout: ``layers/{m,norm}`` stacked on a
leading ``[n_layers]`` axis and one ``shared`` subtree, so the bridge is
one-to-one. Python loops over the groups and their layers replace the
reference's nested ``scan``. The state is ``{"mamba": {"conv", "h"}}``
stacked on ``[n_layers]`` and ``{"kv": {"k", "v"}}`` stacked on one
leading axis of applications; prefill and decode write both in place and
return the same dict (the decode step's Mamba2 kernel writes each layer's
state where it lies). The shared block's attention goes through
``attention.gqa_forward`` / ``gqa_prefill`` / ``gqa_decode``, so through the
``flash_attention`` and ``flash_decode`` kernels on the card.

On a mesh the parameters rest pure FSDP, gathered whole on use, and the
shared block's caches rest with their sequence sharded over ``model``
(the reference's ``cache_specs``). Where the sharded steps say so
(``tp.OnUse.cache_seq``), prefill sends each rank's rows of the new K/V
to the ranks that hold their positions (its rows are split over
``model`` too, the family being pure DP) and the decode attends over
this rank's block of the sequence, merged over the axis
(``attention.gqa_prefill`` / ``gqa_decode`` with the plan of
``models.tp``, which splits nothing here). The Mamba2 states rest over
the dp axes only.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.models import attention as attn
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (
    ACTS, apply_norm, dense, dt, init_dense, init_embedding, init_mlp,
    init_norm, materialize, mlp, remat_fn, unembed,
)
from repro_torch.models.mamba2 import (
    mamba2_decode, mamba2_forward, mamba2_init, mamba2_init_state,
    mamba2_prefill,
)
from repro_torch.models.transformer import _embed, _positions, layer_slices


def _groups(cfg: ArchConfig):
    """(groups, backbone layers a group)."""
    k = cfg.hybrid.shared_attn_every
    assert cfg.n_layers % k == 0
    return cfg.n_layers // k, k


def _apps(cfg: ArchConfig) -> int:
    """Applications of the shared block, each with a KV cache of its own."""
    h = cfg.hybrid
    return len(h.layer_ids) if h.published else _groups(cfg)[0]


def hybrid_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random init from ``gen`` (a generator on ``device``; None on the
    meta device), each parameter allocated once in its final dtype."""
    if cfg.hybrid.published:
        return _published_init(gen, cfg, device)
    dtype = dt(cfg.param_dtype)
    d = cfg.d_model

    def make(spec, layers=0):
        return materialize(spec, gen, dtype, device, layers=layers)

    p = make({"embed": init_embedding(cfg.vocab, d)})
    p["layers"] = make({"m": mamba2_init(cfg),
                        "norm": init_norm(d, cfg.norm)}, cfg.n_layers)
    p.update(make({"shared": {"attn": attn.gqa_init(cfg),
                              "mlp": init_mlp(d, cfg.d_ff, cfg.glu),
                              "norm1": init_norm(d, cfg.norm),
                              "norm2": init_norm(d, cfg.norm)},
                   "final_norm": init_norm(d, cfg.norm),
                   "unembed": init_embedding(cfg.vocab, d)}))
    return p


def hybrid_states(cfg: ArchConfig, batch: int, max_seq: int,
                  device) -> dict:
    """Zeroed decode state: every layer's Mamba2 state stacked on
    ``[n_layers, B, ...]``, and one GQA cache for each application of the
    shared block stacked on ``[groups, B, max_seq, KVH, hd]``."""
    ng = _apps(cfg)
    m = mamba2_init_state(cfg, cfg.n_layers * batch, device)
    kv = attn.gqa_init_cache(cfg, ng * batch, max_seq, dt(cfg.param_dtype),
                             device)
    return {"mamba": {k: v.view(cfg.n_layers, batch, *v.shape[1:])
                      for k, v in m.items()},
            "kv": {k: v.view(ng, batch, *v.shape[1:])
                   for k, v in kv.items()}}


def _mlp_residual(shared, x, cfg: ArchConfig):
    h = apply_norm(shared["norm2"], x, cfg.norm)
    return x + mlp(shared["mlp"], h, cfg.act, cfg.glu, dt(cfg.compute_dtype))


def _shared_block_fwd(shared, x, cfg: ArchConfig, positions):
    h = apply_norm(shared["norm1"], x, cfg.norm)
    x = x + attn.gqa_forward(shared["attn"], h, cfg, positions)
    return _mlp_residual(shared, x, cfg)


def _write(state: dict, new: dict) -> None:
    """Copy a layer's new Mamba2 state into its views of the stack."""
    for k, v in new.items():
        state[k].copy_(v)


def hybrid_forward(params, tokens, cfg: ArchConfig, remat: str = "none"):
    """tokens [B,S] -> full logits [B,S,V] fp32. With ``remat`` other than
    "none", each group (its Mamba2 layers and the shared block) runs under
    checkpoint, as the reference checkpoints its group scan's body (the
    published block: each backbone layer with its application)."""
    if cfg.hybrid.published:
        return _published_run(params, tokens, cfg, remat=remat)
    ng, k = _groups(cfg)
    x = _embed(params, tokens, cfg)
    positions = _positions(tokens)
    layers = layer_slices(params["layers"], cfg.n_layers)

    def group(x, p_g):
        for p_l in p_g:
            h = apply_norm(p_l["norm"], x, cfg.norm)
            y, _ = mamba2_forward(p_l["m"], h, cfg)
            x = x + y.to(x.dtype)
        return _shared_block_fwd(params["shared"], x, cfg, positions)

    group = remat_fn(group, "none" if remat == "none" else "full")
    for g in range(ng):
        x = group(x, layers[g * k:(g + 1) * k])
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(x, params["unembed"], dt(cfg.compute_dtype))


def _cache_plan(cfg: ArchConfig, dist: DistContext, on_use: tpm.OnUse):
    """(plan, cache_seq) of the shared block's cache: the plan only where
    the cache rests sharded on its sequence."""
    if not on_use.cache_seq:
        return None, False
    return tpm.plan(cfg, dist), True


def hybrid_prefill(params, tokens, cfg: ArchConfig, states,
                   dist: DistContext = no_dist(),
                   on_use: tpm.OnUse = tpm.OnUse()):
    """Forward + state fill (in place); returns (last-token logits [B,V],
    states). Where ``on_use.cache_seq`` the shared block's cache is this
    rank's block of the sequence of its dp rows."""
    if cfg.hybrid.published:
        _one_device(dist, on_use)
        return _published_run(params, tokens, cfg, states, "prefill")
    tp, cache_seq = _cache_plan(cfg, dist, on_use)
    ng, k = _groups(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    layers = layer_slices(params["layers"], cfg.n_layers)
    mstates = layer_slices(states["mamba"], cfg.n_layers)
    shared = params["shared"]
    for g, kv_g in enumerate(layer_slices(states["kv"], ng)):
        for i in range(g * k, (g + 1) * k):
            with obs.span("model.mamba", layer=i, phase="prefill"):
                h = apply_norm(layers[i]["norm"], x, cfg.norm)
                y, new = mamba2_prefill(layers[i]["m"], h, cfg, mstates[i])
                _write(mstates[i], new)
                x = x + y.to(x.dtype)
        with obs.span("model.shared", application=g, block=0,
                      phase="prefill"):
            h = apply_norm(shared["norm1"], x, cfg.norm)
            y, _ = attn.gqa_prefill(shared["attn"], h, cfg, kv_g, positions,
                                    tp, cache_seq)
            x = _mlp_residual(shared, x + y, cfg)
    x = apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm)
    logits = unembed(x, params["unembed"], dt(cfg.compute_dtype))
    return logits[:, 0, :], states


def hybrid_decode_step(params, states, tokens, lengths, cfg: ArchConfig,
                       dist: DistContext = no_dist(),
                       on_use: tpm.OnUse = tpm.OnUse()):
    """tokens [B,1], lengths [B] -> (logits [B,V], states updated in
    place); the shared block's attention sequence-parallel where
    ``on_use.cache_seq``."""
    if cfg.hybrid.published:
        _one_device(dist, on_use)
        return _published_run(params, tokens, cfg, states, "decode", lengths)
    tp, cache_seq = _cache_plan(cfg, dist, on_use)
    ng, k = _groups(cfg)
    x = _embed(params, tokens, cfg)
    layers = layer_slices(params["layers"], cfg.n_layers)
    mstates = layer_slices(states["mamba"], cfg.n_layers)
    shared = params["shared"]
    for g, kv_g in enumerate(layer_slices(states["kv"], ng)):
        for i in range(g * k, (g + 1) * k):
            with obs.span("model.mamba", layer=i, phase="decode"):
                h = apply_norm(layers[i]["norm"], x, cfg.norm)
                y, _ = mamba2_decode(layers[i]["m"], h, cfg, mstates[i],
                                     inplace=True)
                x = x + y.to(x.dtype)
        with obs.span("model.shared", application=g, block=0,
                      phase="decode"):
            h = apply_norm(shared["norm1"], x, cfg.norm)
            y, _ = attn.gqa_decode(shared["attn"], h, cfg, kv_g, lengths, tp,
                                   cache_seq)
            x = _mlp_residual(shared, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, params["unembed"], dt(cfg.compute_dtype))
    return logits[:, 0, :], states


# ------------------------------------------------ the published block


def _published_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    h = cfg.hybrid
    dtype = dt(cfg.param_dtype)
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    d_in = 2 * d                       # the blocks read [x; embedding]

    def make(spec, layers=0):
        return materialize(spec, gen, dtype, device, layers=layers)

    p = make({"embed": init_embedding(cfg.vocab, d)})
    p["layers"] = make({"m": mamba2_init(cfg),
                        "norm": init_norm(d, cfg.norm)}, cfg.n_layers)
    p["blocks"] = make({
        "attn": {"wq": init_dense(d_in, cfg.n_heads * hd),
                 "wk": init_dense(d_in, cfg.kv_heads * hd),
                 "wv": init_dense(d_in, cfg.kv_heads * hd),
                 "wo": init_dense(cfg.n_heads * hd, d)},
        "mlp": {"gate_up": init_dense(d, 2 * ff), "down": init_dense(ff, d)},
        "norm1": init_norm(d_in, cfg.norm),
        "norm2": init_norm(d, cfg.norm)}, h.n_blocks)
    apps = {"linear": init_dense(d, d)}
    if h.adapter_rank:
        apps["adapter_a"] = init_dense(d, h.adapter_rank)
        apps["adapter_b"] = init_dense(h.adapter_rank, 2 * ff)
    p["apps"] = make(apps, len(h.layer_ids))
    p.update(make({"final_norm": init_norm(d, cfg.norm)}))
    if not cfg.tie_embeddings:
        p.update(make({"unembed": init_embedding(cfg.vocab, d)}))
    return p


def _one_device(dist: DistContext, on_use: tpm.OnUse) -> None:
    if dist.active or on_use.cache_seq:
        raise ValueError("the published Zamba2 block serves on one device; "
                         "its sharded prefill and decode are not written")


def _published_attention(p, a, cfg: ArchConfig, kv, lengths):
    """The block's causal attention of ``a`` [B,S,d_in] -> [B,S,H*hd],
    before ``wo``; with ``kv`` (prefill) the new K/V filled into it, with
    ``lengths`` too (decode, S = 1) written at ``lengths`` and attended
    over ``lengths + 1`` positions of it."""
    B, S, _ = a.shape
    hd, cdt = cfg.resolved_head_dim, dt(cfg.compute_dtype)
    q, k, v = (dense(p[n], a, cdt).reshape(B, S, -1, hd)
               for n in ("wq", "wk", "wv"))
    scale = (hd / 2) ** -0.5
    if lengths is not None:
        o = attn.decode_attend(q[:, 0], k[:, 0], v[:, 0], kv, lengths,
                               scale=scale)
        return o.reshape(B, 1, -1)
    if kv is not None:
        kv["k"][:, :S] = k
        kv["v"][:, :S] = v
    return attn.attention(q, k, v, scale=scale)


def _published_block(blk, app, x, e, cfg: ArchConfig, kv=None,
                     lengths=None):
    """One application of the shared block ``blk`` with the application's
    own leaves ``app``: L_k f [B,S,d], which the next Mamba2 layer's norm
    reads added to x."""
    h, cdt = cfg.hybrid, dt(cfg.compute_dtype)
    a = apply_norm(blk["norm1"], torch.cat([x, e], -1), cfg.norm)
    o = dense(blk["attn"]["wo"], _published_attention(blk["attn"], a, cfg,
                                                      kv, lengths), cdt)
    m = apply_norm(blk["norm2"], o, cfg.norm)
    gu = dense(blk["mlp"]["gate_up"], m, cdt)
    if h.adapter_rank:
        gu = gu + dense(app["adapter_b"], dense(app["adapter_a"], m, cdt),
                        cdt)
    g, u = gu.chunk(2, dim=-1)
    f = dense(blk["mlp"]["down"], ACTS[cfg.act](g) * u, cdt)
    return dense(app["linear"], f, cdt)


def _published_run(params, tokens, cfg: ArchConfig, states=None,
                   phase: str = "forward", lengths=None, remat: str = "none"):
    """The published block's forward (full logits [B,S,V]), prefill (the
    states filled in place; last-token logits [B,V]) or decode step
    (tokens [B,1] at ``lengths``; logits [B,V]), by ``phase``."""
    h = cfg.hybrid
    x = e = _embed(params, tokens, cfg)
    layers = layer_slices(params["layers"], cfg.n_layers)
    blocks = layer_slices(params["blocks"], h.n_blocks)
    apps = layer_slices(params["apps"], len(h.layer_ids))
    app_of = {i: k for k, i in enumerate(h.layer_ids)}
    if states is not None:
        mstates = layer_slices(states["mamba"], cfg.n_layers)
        kvs = layer_slices(states["kv"], len(h.layer_ids))

    def layer(x, i):
        inp, k = x, app_of.get(i)
        if k is not None:
            with obs.span("model.shared", application=k,
                          block=k % h.n_blocks, phase=phase):
                t = _published_block(blocks[k % h.n_blocks], apps[k], x, e,
                                     cfg, None if states is None else kvs[k],
                                     lengths)
            inp = x + t
        with obs.span("model.mamba", layer=i, phase=phase):
            hn = apply_norm(layers[i]["norm"], inp, cfg.norm)
            if phase == "forward":
                y, _ = mamba2_forward(layers[i]["m"], hn, cfg)
            elif phase == "prefill":
                # a request's recurrence starts from zero, whatever a
                # former request left in a reused cache
                y, new = mamba2_prefill(layers[i]["m"], hn, cfg, {"h": None})
                _write(mstates[i], new)
            else:
                y, _ = mamba2_decode(layers[i]["m"], hn, cfg, mstates[i],
                                     inplace=True)
            return x + y.to(x.dtype)

    layer = remat_fn(layer, "none" if remat == "none" else "full")
    for i in range(cfg.n_layers):
        x = layer(x, i)
    if phase == "prefill":
        x = x[:, -1:, :]
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(x, params.get("unembed", params["embed"]),
                     dt(cfg.compute_dtype))
    if phase == "forward":
        return logits
    return logits[:, 0, :], states
