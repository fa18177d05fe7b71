"""Op-level cost model over the ATen op stream (port of
``repro.analysis.costs``).

The reference costs jaxpr equations; the port costs the ATen ops that a
``TorchDispatchMode`` sees when a function runs (on the card, on the CPU,
or on the meta device, where nothing is computed). One op costs an
:class:`EqnCost`:

  * matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``convolution``): ``2 M N K`` tensor-core flops, the counterpart of
    the reference's MXU flops (``dot_general`` / ``conv``);
  * the port's kernels (custom ops in ``repro_torch.kernels.library``):
    the flop count registered beside them (``KERNEL_FLOPS``), the
    counterpart of ``pallas_call`` = body x grid;
  * views (``view``, ``_unsafe_view``, ``t``, ``permute``, ``transpose``,
    ``expand``, ``slice``, ``select``, ``unsqueeze``, ``as_strided``, ...)
    and allocations alias or reserve memory and do no device work: they
    cost nothing;
  * copies (``clone``, ``copy_``) move bytes and do no flops;
  * everything else: one flop per output element. An indexed write
    (``index_put_``, the decode step's cache write) is costed like the
    reference's ``scatter``: its result is the whole tensor written into,
    an upper bound, since the card touches only the rows written.

Bytes are operands plus results at their dtypes. Eager execution records
every trip of a loop as it runs, so the op stream has no ``while``,
``scan`` or ``cond`` to multiply through: the port's layer loop appears as
one run of ops per layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.library import KERNEL_FLOPS

TENSOR_OPS = {"mm", "addmm", "bmm", "baddbmm", "convolution"}
# aliasing ops; any other op whose schema marks its result as an alias of
# an argument (``OpOverload.is_view``: split, unbind, detach, ...) too
VIEW_OPS = {"view", "_unsafe_view", "t", "permute", "transpose", "expand",
            "slice", "select", "unsqueeze", "as_strided"}
ALLOC_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
COPY_OPS = {"clone", "copy_"}


@dataclass(frozen=True)
class CostConfig:
    """The reference's cost-model knob that its artifact records
    (``assumed_while_trips``, written into ``derived_cuda.json`` as into
    ``derived.json``). An eager op stream has no ``while``: every trip
    that runs is recorded, so the knob changes no count here. The
    reference's ``asymmetric_branch_ratio`` warns on a ``cond``, which an
    eager stream has none of either; it returns with a compiled-graph
    path (ROADMAP)."""
    assumed_while_trips: int = 8


@dataclass(frozen=True)
class EqnCost:
    """(mxu_flops, flops, bytes) plus the widest output lane count.
    ``mxu_flops`` keeps the reference's name and counts tensor-core flops;
    ``lanes`` drives the scalar/vector classification in
    :mod:`repro_torch.analysis.regions`."""
    mxu_flops: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    lanes: float = 0.0

    def __add__(self, other: "EqnCost") -> "EqnCost":
        return EqnCost(self.mxu_flops + other.mxu_flops,
                       self.flops + other.flops,
                       self.bytes + other.bytes,
                       max(self.lanes, other.lanes))

    @property
    def is_zero(self) -> bool:
        return self.flops == 0.0 and self.bytes == 0.0


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def op_name(func) -> str:
    """``aten::mm`` -> ``mm``; ``repro_torch::flash_attention`` ->
    ``flash_attention``."""
    return func._schema.name.split("::", 1)[-1]


def op_cost(func, args, kwargs, out) -> EqnCost:
    """Cost of one dispatched op ``func(*args, **kwargs) -> out``."""
    full = func._schema.name
    name = full.split("::", 1)[-1]
    outs = _tensors(out)
    lanes = float(max((t.numel() for t in outs), default=0))
    if func.is_view or name in VIEW_OPS or name in ALLOC_OPS:
        return EqnCost(lanes=lanes)
    ins = _tensors((args, kwargs))
    by = _nbytes(ins) + _nbytes(outs)
    if full in KERNEL_FLOPS:
        mxu, fl = KERNEL_FLOPS[full](*args, **kwargs)
        return EqnCost(mxu, fl, by, lanes)
    if name in TENSOR_OPS:
        if name == "convolution":          # K = C_in / groups x kernel
            w = args[1]
            k = w.numel() / max(w.shape[0], 1)
        else:                              # K = last dim of the left matrix
            k = args[1 if name in ("addmm", "baddbmm") else 0].shape[-1]
        fl = 2.0 * outs[0].numel() * k
        return EqnCost(fl, fl, by, lanes)
    if name in COPY_OPS:
        src = args[1] if name == "copy_" else args[0]
        return EqnCost(0.0, 0.0, _nbytes([src]) + _nbytes(outs[:1]), lanes)
    return EqnCost(0.0, float(sum(t.numel() for t in outs)), by, lanes)


def cost_tuple(c: EqnCost) -> Tuple[float, float, float]:
    """(mxu_flops, total_flops, bytes) — the legacy triple."""
    return c.mxu_flops, c.flops, c.bytes
