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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
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

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters on the model's device, from ``gen``."""
        return self.init_on(gen, self.device)

    def abstract_params(self) -> dict:
        """The parameter dict on the meta device: shapes and dtypes only."""
        return self.init_on(None, torch.device("meta"))

    def input_specs(self, shape) -> dict:
        """Meta input tensors for a prefill or decode ``ShapeConfig``-like
        ``shape`` (``seq_len``, ``global_batch``, ``kind``): ``tokens``
        [B,S] for prefill; ``tokens`` [B,1] and ``lengths`` [B] for
        decode, one new token against a ``seq_len`` cache; for the audio
        family also ``frames`` [B, n_frames, d] in the compute dtype. The
        reference's PartitionSpecs have no counterpart until distribution
        is ported."""
        B, S = shape.global_batch, shape.seq_len
        meta = dict(dtype=torch.int32, device="meta")
        if shape.kind == "decode":
            out = {"tokens": torch.empty((B, 1), **meta),
                   "lengths": torch.empty((B,), **meta)}
        else:
            out = {"tokens": torch.empty((B, S), **meta)}
        if self.cfg.enc_dec is not None:    # the audio frontend's frames
            out["frames"] = torch.empty(
                (B, self.cfg.enc_dec.n_frames, self.cfg.d_model),
                dtype=dt(self.cfg.compute_dtype), device="meta")
        return out


def _plain_ce(logits, targets):
    ce = token_ce(logits, targets).mean()
    return ce, {"ce": ce}


def _build_lm(cfg: ArchConfig, device: torch.device) -> Model:
    def loss(params, batch):
        return transformer.lm_loss(params, batch["tokens"], batch["targets"],
                                   cfg, remat="full")

    def init_cache(params, batch, B, max_seq):
        return transformer.lm_init_cache(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return transformer.lm_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return transformer.lm_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: transformer.lm_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


def _build_hybrid(cfg: ArchConfig, device: torch.device) -> Model:
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
                 decode_step=decode_step)


def _build_rwkv(cfg: ArchConfig, device: torch.device) -> Model:
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
                 decode_step=decode_step)


def _build_encdec(cfg: ArchConfig, device: torch.device) -> Model:
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

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: encdec.encdec_init(gen, cfg, dev),
                 loss=loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


FAMILIES = {"dense": _build_lm, "vlm": _build_lm, "moe": _build_lm,
            "hybrid": _build_hybrid, "ssm": _build_rwkv,
            "audio": _build_encdec}


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    return FAMILIES[cfg.family](cfg, torch.device(device))
