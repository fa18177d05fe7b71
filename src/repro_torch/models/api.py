"""Model API of the port: the LM family behind the reference's ``Model``
interface (``repro.models.api``).

``build_model(cfg, device)`` returns a ``Model`` whose ``init``,
``init_cache``, ``prefill`` and ``decode_step`` take the same arguments as
the reference's, with a ``torch.Generator`` in place of a JAX key and
tensors in place of arrays. ``abstract_params()`` and ``input_specs(shape)``
give parameters and inputs on the ``meta`` device, where nothing is
allocated: the counterpart of the reference's ``jax.eval_shape`` and
``ShapeDtypeStruct``s, which the static analysis traces at full width.
This port builds the ``dense``, ``vlm`` (early-fusion, token-stream),
``moe`` (MoE FFN, GQA or MLA attention) and ``hybrid`` (Mamba2 with a
shared attention block) families; the others raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, transformer


@dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    family: str
    init_on: Callable                # (gen, device) -> params
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
        decode, one new token against a ``seq_len`` cache. The reference's
        PartitionSpecs have no counterpart until distribution is ported."""
        B, S = shape.global_batch, shape.seq_len
        meta = dict(dtype=torch.int32, device="meta")
        if shape.kind == "decode":
            return {"tokens": torch.empty((B, 1), **meta),
                    "lengths": torch.empty((B,), **meta)}
        return {"tokens": torch.empty((B, S), **meta)}


def _build_lm(cfg: ArchConfig, device: torch.device) -> Model:
    def init_cache(params, batch, B, max_seq):
        return transformer.lm_init_cache(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return transformer.lm_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return transformer.lm_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: transformer.lm_init(gen, cfg, dev),
                 init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


def _build_hybrid(cfg: ArchConfig, device: torch.device) -> Model:
    def init_cache(params, batch, B, max_seq):
        return hybrid.hybrid_states(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return hybrid.hybrid_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return hybrid.hybrid_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init_on=lambda gen, dev: hybrid.hybrid_init(gen, cfg, dev),
                 init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


# families of later slices, and the ROADMAP item that ports each
LATER_SLICES = {
    "ssm": "RWKV6 (ROADMAP queue 1, item 7)",
    "audio": "the encoder-decoder (ROADMAP queue 1, item 8)",
}

FAMILIES = {"dense": _build_lm, "vlm": _build_lm, "moe": _build_lm,
            "hybrid": _build_hybrid}


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    if cfg.family not in FAMILIES:
        later = LATER_SLICES.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {later}")
    return FAMILIES[cfg.family](cfg, torch.device(device))
