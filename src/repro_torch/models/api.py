"""Model API of the port: the LM family behind the reference's ``Model``
interface (``repro.models.api``).

``build_model(cfg, device)`` returns a ``Model`` whose ``init``, ``loss``,
``init_cache``, ``prefill`` and ``decode_step`` take the same arguments as
the reference's, with a ``torch.Generator`` in place of a JAX key and
tensors in place of arrays. ``abstract_params()`` and ``input_specs(shape)``
give parameters and inputs on the ``meta`` device, where nothing is
allocated: the counterpart of the reference's ``jax.eval_shape`` and
``ShapeDtypeStruct``s, which the static analysis traces at full width.
It builds all six families of the reference: ``dense``, ``vlm``
(early-fusion, token-stream), ``moe`` (MoE FFN, GQA or MLA attention),
``hybrid`` (Mamba2 with a shared attention block), ``ssm`` (RWKV6) and
``audio`` (the whisper encoder-decoder, whose inputs add ``frames``).
``loss(params, batch)`` gives ``(loss, metrics)`` from ``tokens`` and
``targets`` (and ``frames``), with the reference's ``remat="full"``:
``transformer.lm_loss`` for the LM families, ``_plain_ce`` of the full
logits for the hybrid and RWKV6, ``encdec.encdec_loss`` for the audio
family.

``build_model(cfg, device, dist)`` takes the reference's ``DistContext``
(``no_dist()`` by default): ``param_specs()`` gives every leaf's
partition spec on its mesh (unsanitized, as the reference's), and
``batch_specs(shape)`` the inputs' (the batch over the dp axes, and over
``model`` too for the families with no tensor-parallel dim,
``pure_dp``), and ``cache_specs()`` the cache's, spec for spec the
reference's (batch over dp, an attention cache's sequence over
``model``). ``local_leaves`` maps the leaves the forward takes as this
rank's shards to the spec it takes each at: the experts of a sharded MoE
dispatch, and for the transformer family on a ``model`` axis of more
than one rank the leaves it computes tensor-parallel (``models.tp``:
q/k/v and ``wo`` by heads, the MLP by columns, the embeddings by
vocabulary rows), and for the encoder-decoder its dense layers split on
their output dim (``encdec.encdec_local_leaves``); the sharded steps
gather every other leaf on use. The transformer family's and the
encoder-decoder's ``loss`` also takes ``on_use`` (``tp.OnUse``: the
per-layer gather), which the sharded step passes (``per_layer_gathers``);
every family's ``prefill`` and ``decode_step`` take it, with whether the
attention caches rest sharded over ``model`` on their sequence (RWKV6
has none). ``plan()`` is this rank's plan of ``models.tp`` that the
forward computes on (None off a ``model`` axis and for RWKV6).

``graph_decode`` says whether a family's decode step is shown safe to
capture as a CUDA graph and replay (``launch.serve.RealModelExecutor``
does so on the card, off a mesh): the GQA decoders without MoE served
through ``transformer.lm_decode_step``, whose every op runs on the card
from shapes alone, and the published Zamba2 block (``HybridConfig.
layer_ids``), whose decode step writes its states in place and whose
prefill starts each request's Mamba2 recurrence from zero, so that a
reused cache carries nothing of a former request. MLA, MoE routing, the
repo's hybrid block (its prefill starts from the state it is given),
RWKV6 and the encoder-decoder are not, and decode eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.dist.sharding import P, map_with_specs, sanitize_specs
from repro_torch.models import encdec, hybrid, rwkv6, transformer
from repro_torch.models import tp as tpm
from repro_torch.models.tp import OnUse
from repro_torch.models.layers import dt, token_ce


@dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    family: str
    init_on: Callable                # (gen, device) -> params
    loss: Callable                   # (params, batch) -> (loss, metrics)
    init_cache: Callable             # (params, batch, B, max_seq) -> cache
    prefill: Callable                # (params, batch, cache) -> (logits, cache)
    decode_step: Callable            # (params, cache, tokens, lengths) -> ...
    param_specs: Callable            # () -> dict of P (unsanitized)
    cache_specs: Callable            # () -> dict of P (unsanitized)
    dist: DistContext = no_dist()
    pure_dp: bool = False            # no TP dim: batch shards over model too
    local_leaves: dict = field(default_factory=dict)  # leaf -> spec on use
    per_layer_gathers: bool = False  # a layer at a time; loss takes on_use
    plan: Callable = lambda: None    # () -> this rank's tp plan
    graph_decode: bool = False       # decode_step capture-safe (see above)

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters on the model's device, from ``gen``."""
        return self.init_on(gen, self.device)

    def abstract_params(self) -> dict:
        """The parameter dict on the meta device: shapes and dtypes only."""
        return self.init_on(None, torch.device("meta"))

    def input_specs(self, shape) -> dict:
        """Meta input tensors for a train, prefill or decode
        ``ShapeConfig``-like ``shape`` (``seq_len``, ``global_batch``,
        ``kind``): ``tokens`` [B,S] for prefill, and ``targets`` for
        train; ``tokens`` [B,1] and ``lengths`` [B] for decode, one new
        token against a ``seq_len`` cache; for the audio family also
        ``frames`` [B, n_frames, d] in the compute dtype."""
        return _token_inputs(self, shape)[0]

    def batch_specs(self, shape) -> dict:
        """The partition spec of each of ``input_specs(shape)``."""
        return _token_inputs(self, shape)[1]


def _token_inputs(model: Model, shape):
    """(meta inputs, their specs): the reference's ``_token_inputs``."""
    cfg, dist = model.cfg, model.dist
    B, S = shape.global_batch, shape.seq_len
    bspec = dist.dp_axes + ((dist.model_axis,) if (
        model.pure_dp and dist.model_axis) else ()) if dist.active else ()
    meta = dict(dtype=torch.int32, device="meta")
    if shape.kind == "decode":
        dspec = dist.dp_axes if dist.active else ()
        st = {"tokens": torch.empty((B, 1), **meta),
              "lengths": torch.empty((B,), **meta)}
        sp = {"tokens": P(dspec, None), "lengths": P(dspec)}
    else:
        st = {"tokens": torch.empty((B, S), **meta)}
        sp = {"tokens": P(bspec, None)}
        if shape.kind == "train":
            st["targets"] = torch.empty((B, S), **meta)
            sp["targets"] = P(bspec, None)
    if cfg.enc_dec is not None:    # the audio frontend's frames
        st["frames"] = torch.empty((B, cfg.enc_dec.n_frames, cfg.d_model),
                                   dtype=dt(cfg.compute_dtype),
                                   device="meta")
        sp["frames"] = P(dist.dp_axes if dist.active else (), None, None)
    return st, sp


def _fsdp_axis(dist: DistContext):
    return dist.dp_axes[0] if (dist.active and dist.fsdp and dist.dp_axes) \
        else None


def _fs_specs(abstract, fs):
    """Pure-DP template: FSDP-shard the largest dim of big leaves."""
    def one(a):
        if a.ndim == 0 or a.numel() < 1 << 16:
            return P()
        dims = list(a.shape)
        # skip the leading stack axis of stacked params
        start = 1 if a.ndim >= 2 else 0
        big = max(range(start, a.ndim), key=lambda i: dims[i])
        spec = [None] * a.ndim
        spec[big] = fs
        return P(*spec)
    return map_with_specs(one, abstract)


def _cache_axes(dist: DistContext):
    """(dp axes, model axis) of the caches' specs: ((), None) off a mesh."""
    return (dist.dp_axes, dist.model_axis) if dist.active else ((), None)


def _plain_ce(logits, targets):
    ce = token_ce(logits, targets).mean()
    return ce, {"ce": ce}


def _build_lm(cfg: ArchConfig, device: torch.device,
              dist: DistContext) -> Model:
    def loss(params, batch, on_use=OnUse()):
        return transformer.lm_loss(params, batch["tokens"], batch["targets"],
                                   cfg, remat="full", dist=dist,
                                   on_use=on_use)

    def init_cache(params, batch, B, max_seq):
        return transformer.lm_init_cache(cfg, B, max_seq, device)

    def prefill(params, batch, cache, on_use=OnUse()):
        return transformer.lm_prefill(params, batch["tokens"], cfg, cache,
                                      dist, on_use)

    def decode_step(params, cache, tokens, lengths, on_use=OnUse()):
        return transformer.lm_decode_step(params, cache, tokens, lengths, cfg,
                                          dist, on_use)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: transformer.lm_init(gen, cfg, dev,
                                                              dist),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: transformer.lm_param_specs(cfg, dist),
                 cache_specs=lambda: transformer.lm_cache_specs(cfg, dist),
                 dist=dist,
                 local_leaves=transformer.lm_local_leaves(cfg, dist),
                 per_layer_gathers=True, plan=lambda: tpm.plan(cfg, dist),
                 graph_decode=cfg.attention == "gqa" and cfg.moe is None)


def _build_hybrid(cfg: ArchConfig, device: torch.device,
                  dist: DistContext) -> Model:
    def loss(params, batch):
        return _plain_ce(hybrid.hybrid_forward(params, batch["tokens"], cfg,
                                               remat="full"),
                         batch["targets"])

    def init_cache(params, batch, B, max_seq):
        return hybrid.hybrid_states(cfg, B, max_seq, device)

    def prefill(params, batch, cache, on_use=OnUse()):
        return hybrid.hybrid_prefill(params, batch["tokens"], cfg, cache,
                                     dist, on_use)

    def decode_step(params, cache, tokens, lengths, on_use=OnUse()):
        return hybrid.hybrid_decode_step(params, cache, tokens, lengths, cfg,
                                         dist, on_use)

    def cache_specs():
        dp, m = _cache_axes(dist)
        return {"mamba": {"conv": P(None, dp, None, None),
                          "h": P(None, dp, None, None, None)},
                "kv": {"k": P(None, dp, m, None, None),
                       "v": P(None, dp, m, None, None)}}

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: hybrid.hybrid_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: _fs_specs(
                     hybrid.hybrid_init(None, cfg, "meta"), _fsdp_axis(dist)),
                 cache_specs=cache_specs, dist=dist, pure_dp=True,
                 plan=lambda: tpm.plan(cfg, dist),
                 graph_decode=cfg.hybrid.published)


def _build_rwkv(cfg: ArchConfig, device: torch.device,
                dist: DistContext) -> Model:
    """RWKV6: the cache is the stacked layer states, which prefill and
    decode return anew."""
    def loss(params, batch):
        logits, _ = rwkv6.rwkv6_lm_apply(params, batch["tokens"], cfg,
                                         remat="full")
        return _plain_ce(logits, batch["targets"])

    def init_cache(params, batch, B, max_seq):
        return rwkv6.rwkv6_lm_states(cfg, B, device)

    def prefill(params, batch, cache, on_use=OnUse()):
        logits, st = rwkv6.rwkv6_lm_apply(params, batch["tokens"], cfg,
                                          cache)
        return logits[:, -1, :], st

    def decode_step(params, cache, tokens, lengths, on_use=OnUse()):
        logits, st = rwkv6.rwkv6_lm_apply(params, tokens, cfg, cache)
        return logits[:, 0, :], st

    def cache_specs():
        dp, _ = _cache_axes(dist)
        return {"tm_x": P(None, dp, None, None),
                "cm_x": P(None, dp, None, None),
                "S": P(None, dp, None, None, None)}

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: rwkv6.rwkv6_lm_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: _fs_specs(
                     rwkv6.rwkv6_lm_init(None, cfg, "meta"),
                     _fsdp_axis(dist)),
                 cache_specs=cache_specs, dist=dist, pure_dp=True)


def _build_encdec(cfg: ArchConfig, device: torch.device,
                  dist: DistContext) -> Model:
    """The encoder-decoder. As in the reference, ``init_cache`` runs the
    encoder over ``batch["frames"]``, and ``prefill`` runs it again and
    the teacher-forced decoder, returning the last position's logits and
    the cache unfilled: the self-KV fills step by step through
    ``decode_step``. ``init_cache`` takes the whole parameters, or with
    ``on_use`` the parameters as they rest on a mesh. The plan's ``cols``
    are the dense layers that the sanitized ``param_specs`` split over
    ``model``, read once here."""
    def param_specs():
        return encdec.encdec_param_specs(cfg, _fsdp_axis(dist),
                                         dist.model_axis)
    cols = encdec.split_cols(sanitize_specs(
        encdec.encdec_init(None, cfg, "meta"), param_specs(), dist.mesh),
        dist.model_axis) if dist.active and dist.model_size > 1 \
        else frozenset()

    def plan():
        return tpm.plan(cfg, dist, cols)

    def loss(params, batch, on_use=OnUse()):
        return encdec.encdec_loss(params, batch["frames"], batch["tokens"],
                                  batch["targets"], cfg, "full", plan(),
                                  on_use)

    def init_cache(params, batch, B, max_seq, on_use=None):
        return encdec.encdec_init_cache(params, batch["frames"], cfg, B,
                                        max_seq, plan(), on_use)

    def prefill(params, batch, cache, on_use=OnUse()):
        tp = plan()
        enc_out = encdec.encode(params, batch["frames"], cfg, "none", tp,
                                on_use)
        logits = encdec.decode_forward(params, batch["tokens"], enc_out, cfg,
                                       "none", tp, on_use)
        return logits[:, -1, :], cache

    def decode_step(params, cache, tokens, lengths, on_use=OnUse()):
        return encdec.encdec_decode_step(params, cache, tokens, lengths, cfg,
                                         plan(), on_use)

    def cache_specs():
        dp, m = _cache_axes(dist)
        return {"self": {"k": P(None, dp, m, None, None),
                         "v": P(None, dp, m, None, None)},
                "cross": {"xk": P(None, dp, None, None, None),
                          "xv": P(None, dp, None, None, None)}}

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: encdec.encdec_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 cache_specs=cache_specs, dist=dist,
                 local_leaves=encdec.encdec_local_leaves(cols,
                                                         dist.model_axis),
                 per_layer_gathers=True, plan=plan)


FAMILIES = {"dense": _build_lm, "vlm": _build_lm, "moe": _build_lm,
            "hybrid": _build_hybrid, "ssm": _build_rwkv,
            "audio": _build_encdec}


def build_model(cfg: ArchConfig, device="cuda",
                dist: DistContext = no_dist()) -> Model:
    return FAMILIES[cfg.family](cfg, torch.device(device), dist)
