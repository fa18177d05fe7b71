"""Static-vs-counted differential oracle (port of
``repro.analysis.differential``).

The static pass (:mod:`repro_torch.analysis.costs`) counts every op of the
recorded stream by its own rules. This module cross-checks its flop claim
against PyTorch's own counter, ``torch.utils.flop_counter.FlopCounterMode``,
over the same call — the counterpart of the reference's HLO cost model
over compiled HLO. The two count independently: the counter knows matrix
products (``mm``, ``bmm``, convolutions, attention) and nothing
elementwise, so matmul-dominated entrypoints agree within the tolerance
and pointwise or integer work diverges. For the port's attention kernels
the counter is given formulas here, in the form of its own
``sdpa_flop_count``, and for the Mamba2 step the products its plain
version counts as ``bmm``s; ``chacha20`` gets none, since its integer work is
what the counter does not count (``calibrate.KNOWN_DIVERGENT``).

Bytes are not compared: the counter counts none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.flop_counter import (FlopCounterMode, bmm_flop,
                                      register_flop_formula)

from repro_torch.analysis.regions import fn_cost
from repro_torch.kernels import library  # noqa: F401  (defines the ops)

# documented default: static and counted flop totals must agree within 25%
FLOPS_REL_TOL = 0.25


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flop(q_shape, k_shape, v_shape, *args, out_shape=None,
                          **kwargs) -> int:
    """QK^T and PV as two batched products over B*H query heads, as
    ``sdpa_flop_count`` counts them (each query head against its KV
    head's Skv keys)."""
    b, h, s_q, d_q = q_shape
    s_k, d_v = k_shape[2], v_shape[3]
    return (bmm_flop((b * h, s_q, d_q), (b * h, d_q, s_k))
            + bmm_flop((b * h, s_q, s_k), (b * h, s_k, d_v)))


@register_flop_formula([torch.ops.repro_torch.flash_decode,
                       torch.ops.repro_torch.flash_decode_lse])
def _flash_decode_flop(q_shape, k_shape, v_shape, *args, out_shape=None,
                       **kwargs) -> int:
    """One query row per head against the cache's S positions."""
    b, h, d_q = q_shape
    s_k, d_v = k_shape[2], v_shape[3]
    return (bmm_flop((b * h, 1, d_q), (b * h, d_q, s_k))
            + bmm_flop((b * h, 1, s_k), (b * h, s_k, d_v)))


@register_flop_formula(torch.ops.repro_torch.mamba2_step)
def _mamba2_step_flop(zx_shape, conv_shape, h_shape, conv_w_shape, *args,
                      out_shape=None, **kwargs) -> int:
    """The Mamba2 step's three products as the counter counts the plain
    path's ``bmm``s: the K-tap conv, the outer product (x dt) B^T and
    C . h (``library.mamba2_step_bmm_flops``)."""
    return int(library.mamba2_step_bmm_flops(h_shape, conv_w_shape))


@dataclass
class DifferentialResult:
    name: str
    static_flops: float
    counter_flops: float
    static_mxu_flops: float
    tol: float

    @property
    def rel_err(self) -> float:
        ref = max(self.static_flops, self.counter_flops)
        return abs(self.static_flops - self.counter_flops) / ref if ref \
            else 0.0

    @property
    def agrees(self) -> bool:
        return self.rel_err <= self.tol

    def to_dict(self) -> dict:
        return {"name": self.name, "static_flops": self.static_flops,
                "counter_flops": self.counter_flops,
                "static_mxu_flops": self.static_mxu_flops,
                "rel_err": self.rel_err, "tol": self.tol,
                "agrees": self.agrees}


def differential(fn: Callable, *args, name: str = "",
                 tol: float = FLOPS_REL_TOL) -> DifferentialResult:
    """Compare the static flop claim for ``fn(*args)`` against
    ``FlopCounterMode`` over the same call (run once for each)."""
    static = fn_cost(fn, *args)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return DifferentialResult(
        name=name or getattr(fn, "__name__", "fn"),
        static_flops=static.flops, counter_flops=counter.get_total_flops(),
        static_mxu_flops=static.mxu_flops, tol=tol)
