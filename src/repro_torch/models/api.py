"""Model API of the port: the LM family behind the reference's ``Model``
interface (``repro.models.api``).

``build_model(cfg, device)`` returns a ``Model`` whose ``init``,
``init_cache``, ``prefill`` and ``decode_step`` take the same arguments as
the reference's, with a ``torch.Generator`` in place of a JAX key and
tensors in place of arrays. This slice builds the ``dense`` and ``vlm``
(early-fusion, token-stream) families; the others raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    family: str
    init: Callable                   # (gen) -> params
    init_cache: Callable             # (params, batch, B, max_seq) -> cache
    prefill: Callable                # (params, batch, cache) -> (logits, cache)
    decode_step: Callable            # (params, cache, tokens, lengths) -> ...


def _build_lm(cfg: ArchConfig, device: torch.device) -> Model:
    def init_cache(params, batch, B, max_seq):
        return transformer.lm_init_cache(cfg, B, max_seq, device)

    def prefill(params, batch, cache):
        return transformer.lm_prefill(params, batch["tokens"], cfg, cache)

    def decode_step(params, cache, tokens, lengths):
        return transformer.lm_decode_step(params, cache, tokens, lengths, cfg)

    return Model(cfg=cfg, device=device, family=cfg.family,
                 init=lambda gen: transformer.lm_init(gen, cfg, device),
                 init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


# families of later slices, and the ROADMAP item that ports each
LATER_SLICES = {
    "moe": "MLA and MoE (ROADMAP queue 1, item 5)",
    "hybrid": "Mamba2 and hybrid (ROADMAP queue 1, item 6)",
    "ssm": "RWKV6 (ROADMAP queue 1, item 7)",
    "audio": "the encoder-decoder (ROADMAP queue 1, item 8)",
}

FAMILIES = {"dense": _build_lm, "vlm": _build_lm}


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    if cfg.family not in FAMILIES:
        later = LATER_SLICES.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {later}")
    return FAMILIES[cfg.family](cfg, torch.device(device))
