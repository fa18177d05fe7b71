"""Region-level static analysis of the port (port of ``repro.analysis``):
the paper's §3.3 disassembler, over the ATen op stream with an H100
machine model.

  * :mod:`repro_torch.analysis.costs` — op-level cost model (tensor-core
    flops, total flops, dtype-aware bytes); the port's kernels carry
    their own counts (``kernels.library.KERNEL_FLOPS``);
  * :mod:`repro_torch.analysis.regions` — program-order phase
    segmentation under a ``TorchDispatchMode`` into :class:`Region`
    timelines (scalar / vector / tensor classes, the H100 analogue of
    SSE / AVX2 / AVX-512 license levels) plus the compat
    ``FunctionProfile`` / ``rank_functions`` / ``report`` API;
  * :mod:`repro_torch.analysis.differential` — static claims
    cross-checked against ``torch.utils.flop_counter.FlopCounterMode``;
  * :mod:`repro_torch.analysis.calibrate` — runs the pass over the
    port's kernels (on the card) and the ported model families (on the
    meta device) and writes ``derived_cuda.json``;
  * :mod:`repro_torch.analysis.derived` — loader for the reference's
    ``derived.json`` (a byte-identical copy), which serving reads.

The reference's intermittency lint (``analysis/lint.py``) is not ported
yet.

Attribute access is lazy (PEP 562): importing
``repro_torch.analysis.derived`` does not import the cost model.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CostConfig": "costs", "EqnCost": "costs", "op_cost": "costs",
    "cost_tuple": "costs",
    "FunctionProfile": "regions", "LEVEL_NAMES": "regions",
    "MachineModel": "regions", "Region": "regions",
    "RegionTimeline": "regions", "analyze": "regions", "fn_cost": "regions",
    "rank_functions": "regions", "record": "regions", "report": "regions",
    "segment": "regions", "tag_heavy": "regions",
    "DifferentialResult": "differential", "differential": "differential",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.analysis.{mod}"),
                   name)


def __dir__():
    return __all__
