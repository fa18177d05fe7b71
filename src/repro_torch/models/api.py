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
``pure_dp``). ``local_leaves`` names the leaves the forward takes as
this rank's shards (the experts of a sharded MoE dispatch); the sharded
train step gathers every other leaf on use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import DistContext, no_dist
from repro_torch.dist.sharding import P, map_with_specs
from repro_torch.models import encdec, hybrid, rwkv6, transformer
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
    dist: DistContext = no_dist()
    pure_dp: bool = False            # no TP dim: batch shards over model too
    local_leaves: frozenset = frozenset()

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


def _plain_ce(logits, targets):
    ce = token_ce(logits, targets).mean()
    return ce, {"ce": ce}


def _build_lm(cfg: ArchConfig, device: torch.device,
              dist: DistContext) -> Model:
    def loss(params, batch):
        return transformer.lm_loss(params, batch["tokens"], batch["targets"],
                                   cfg, remat="full", dist=dist)

    def init_cache(params, batch, B, max_seq):
        return transformer.lm_init_cache(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return transformer.lm_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return transformer.lm_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: transformer.lm_init(gen, cfg, dev,
                                                              dist),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: transformer.lm_param_specs(cfg, dist),
                 dist=dist,
                 local_leaves=transformer.lm_local_leaves(cfg, dist))


def _build_hybrid(cfg: ArchConfig, device: torch.device,
                  dist: DistContext) -> Model:
    def loss(params, batch):
        return _plain_ce(hybrid.hybrid_forward(params, batch["tokens"], cfg,
                                               remat="full"),
                         batch["targets"])

    def init_cache(params, batch, B, max_seq):
        return hybrid.hybrid_states(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return hybrid.hybrid_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return hybrid.hybrid_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: hybrid.hybrid_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: _fs_specs(
                     hybrid.hybrid_init(None, cfg, "meta"), _fsdp_axis(dist)),
                 dist=dist, pure_dp=True)


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

    def prefill(params, batch, cache):
        logits, st = rwkv6.rwkv6_lm_apply(params, batch["tokens"], cfg,
                                          cache)
        return logits[:, -1, :], st

    def decode_step(params, cache, tokens, lengths):
        logits, st = rwkv6.rwkv6_lm_apply(params, tokens, cfg, cache)
        return logits[:, 0, :], st

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: rwkv6.rwkv6_lm_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step,
                 param_specs=lambda: _fs_specs(
                     rwkv6.rwkv6_lm_init(None, cfg, "meta"),
                     _fsdp_axis(dist)),
                 dist=dist, pure_dp=True)


def _build_encdec(cfg: ArchConfig, device: torch.device,
                  dist: DistContext) -> Model:
    """The encoder-decoder. As in the reference, ``init_cache`` runs the
    encoder over ``batch["frames"]``, and ``prefill`` runs it again and
    the teacher-forced decoder, returning the last position's logits and
    the cache unfilled: the self-KV fills step by step through
    ``decode_step``."""
    def loss(params, batch):
        return encdec.encdec_loss(params, batch["frames"], batch["tokens"],
                                  batch["targets"], cfg, remat="full")

    def init_cache(params, batch, B, max_seq):
        return encdec.encdec_init_cache(params, batch["frames"], cfg, B,
                                        max_seq)

    def prefill(params, batch, cache):
        enc_out = encdec.encode(params, batch["frames"], cfg)
        logits = encdec.decode_forward(params, batch["tokens"], enc_out, cfg)
        return logits[:, -1, :], cache

    def decode_step(params, cache, tokens, lengths):
        return encdec.encdec_decode_step(params, cache, tokens, lengths, cfg)

    def param_specs():
        # dense kernels [.., d_in, d_out]: TP on the last dim, FSDP on the
        # second-last; small leaves and vectors replicated
        fs, m = _fsdp_axis(dist), dist.model_axis

        def one(a):
            if a.ndim <= 1 or a.numel() < 1 << 16:
                return P()
            spec = [None] * a.ndim
            spec[-1], spec[-2] = m, fs
            return P(*spec)
        return map_with_specs(one, encdec.encdec_init(None, cfg, "meta"))

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: encdec.encdec_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 dist=dist)


FAMILIES = {"dense": _build_lm, "vlm": _build_lm, "moe": _build_lm,
            "hybrid": _build_hybrid, "ssm": _build_rwkv,
            "audio": _build_encdec}


def build_model(cfg: ArchConfig, device="cuda",
                dist: DistContext = no_dist()) -> Model:
    return FAMILIES[cfg.family](cfg, torch.device(device), dist)
