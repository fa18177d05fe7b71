"""Per-rank cost of a traced call over its ATen op stream: the port of
``repro.roofline.hlo_cost``.

The reference parses compiled HLO: it multiplies while bodies by their
trip counts, charges memory traffic at fusion boundaries and estimates
each collective's wire bytes. The port runs the call (on the card, or
on fake tensors of a fake world, where nothing is computed) under
:class:`CostCounter`, a ``TorchDispatchMode`` that totals every op it
sees into :class:`CostTotals`, with the reference's fields and
``to_dict`` keys.

  * flops: ``repro_torch.analysis.costs.op_cost``, the one source of the
    flop rules (``2 M N K`` a product, ``KERNEL_FLOPS`` for the port's
    kernels, one a output element for the rest);
  * bytes, by the rules of the reference's that an eager stream can
    meet: an in-place indexed write (``index_put_``, ``index_copy_``,
    ``scatter_``, ``index_add_``) costs the update it writes, not the
    buffer, and ``copy_`` into a slice view (the prefill's cache write)
    costs the slice; a gather (``index``, ``index_select``, ``gather``,
    ``embedding``) reads what it returns; views and allocations cost
    nothing; every other op costs its operands and results;
  * casts: a dtype-only ``_to_copy`` is a kernel the card runs, so it
    counts in ``bytes`` and is also reported in ``cast_bytes``. The
    reference's ``cast_bytes`` are XLA:CPU's bf16/f32 artefacts, which it
    leaves out of ``bytes``: a difference of the two totals;
  * collectives: each ``c10d`` op of a process group (all-gather,
    all-reduce, reduce-scatter, all-to-all, send), with the group's size
    ``n`` from the group and the reference's wire formulas: all-gather
    res - opnd, all-reduce 2 opnd (n-1)/n, reduce-scatter opnd - res,
    all-to-all opnd (n-1)/n, send opnd. Wire bytes are also kept by
    group size (``wire_by_group``) and by link (``wire_by_link``:
    ``nvlink`` when the group lies in one node, as
    ``roofline.analysis.link_of`` says), which the roofline charges at
    their links' rates.

Eager execution records every trip of a loop as it runs, so there is no
loop body to multiply: every layer, chunk and microbatch that runs is
counted once each time it runs. Ops nested inside another op's
implementation (a custom op's wrapper, a composite's decomposition
below the mode) are not seen, and the ops a collective's backend runs
inside the call (``dist.collectives.in_call``) are not costed: the counter
costs what the program hands the dispatcher, the same on fake tensors as
on the card and under gloo as under NCCL.

The counter also follows device memory: ``peak_bytes`` is the most bytes
that storages created during the call held at once (the call's
arguments, made before it, are not counted; its outputs are, while they
live).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.costs import ALLOC_OPS, VIEW_OPS, op_cost, op_name
from repro_torch.dist.collectives import in_call
from repro_torch.roofline.analysis import link_of

# c10d op -> the reference's collective name
COLLECTIVES = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
               "allreduce_": "all-reduce",
               "_reduce_scatter_base_": "reduce-scatter",
               "reduce_scatter_": "reduce-scatter",
               "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
               "send": "collective-permute"}
# indexed in-place writes: op -> index of the written values' argument
WRITES = {"index_put_": 2, "index_put": 2, "index_copy_": 3,
          "index_copy": 3, "scatter_": 3, "scatter": 3, "scatter_add_": 3,
          "scatter_add": 3, "index_add_": 3, "index_add": 3}
GATHERS = {"index", "index_select", "gather", "embedding", "take"}


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    cast_bytes: float = 0.0      # dtype-only copies, also in ``bytes``
    coll_counts: Dict[str, float] = field(default_factory=dict)
    coll_operand: Dict[str, float] = field(default_factory=dict)
    coll_result: Dict[str, float] = field(default_factory=dict)
    coll_wire: Dict[str, float] = field(default_factory=dict)
    wire_by_group: Dict[int, float] = field(default_factory=dict)
    wire_by_link: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "CostTotals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.cast_bytes += other.cast_bytes * mult
        for d_self, d_o in ((self.coll_counts, other.coll_counts),
                            (self.coll_operand, other.coll_operand),
                            (self.coll_result, other.coll_result),
                            (self.coll_wire, other.coll_wire),
                            (self.wire_by_group, other.wire_by_group),
                            (self.wire_by_link, other.wire_by_link)):
            for k, v in d_o.items():
                d_self[k] = d_self.get(k, 0.0) + v * mult

    @property
    def total_wire(self) -> float:
        return sum(self.coll_wire.values())

    def to_dict(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "cast_bytes": self.cast_bytes,
                "coll_counts": self.coll_counts,
                "coll_operand": self.coll_operand,
                "coll_result": self.coll_result,
                "coll_wire": self.coll_wire,
                "total_wire": self.total_wire,
                "wire_by_group": {str(k): v for k, v
                                  in sorted(self.wire_by_group.items())},
                "wire_by_link": self.wire_by_link}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _group_ranks(args) -> list:
    """The global ranks of the process group among a c10d op's args."""
    box = next(a for a in args if isinstance(a, torch.ScriptObject))
    return tdist.get_process_group_ranks(tdist.ProcessGroup.unbox(box))


def _add(d: dict, k, v) -> None:
    d[k] = d.get(k, 0.0) + v


class CostCounter(TorchDispatchMode):
    """Totals every op of the calls made under it into ``totals``, and
    follows the bytes of the storages they create (``live_bytes``,
    ``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()

    # ------------------------------------------------------------ memory

    def _freed(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, outs, ins) -> None:
        """Adds each output storage that is new: not an input's (a view's
        or an in-place op's) and not seen before."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in seen or st in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[st] = weakref.ref(
                st, lambda _, n=nbytes: self._freed(n))
            self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ------------------------------------------------------------- costs

    def _collective(self, kind: str, args) -> None:
        t = self.totals
        if kind in ("all-reduce", "collective-permute"):
            opnd = res = _nbytes(_tensors(args))
        else:                        # (output, input, ...) in every schema
            res, opnd = _nbytes(_tensors(args[0])), _nbytes(_tensors(args[1]))
        ranks = _group_ranks(args)
        n = len(ranks)
        if kind == "all-gather":
            wire = max(res - opnd, 0.0)
        elif kind == "all-reduce":
            wire = 2 * opnd * (n - 1) / n
        elif kind == "reduce-scatter":
            wire = max(opnd - res, 0.0)
        elif kind == "all-to-all":
            wire = opnd * (n - 1) / n
        else:
            wire = opnd
        _add(t.coll_counts, kind, 1)
        _add(t.coll_operand, kind, opnd)
        _add(t.coll_result, kind, res)
        _add(t.coll_wire, kind, wire)
        _add(t.wire_by_group, n, wire)
        _add(t.wire_by_link, link_of(ranks), wire)
        t.bytes += res + opnd

    def _op(self, func, args, kwargs, out) -> None:
        name = op_name(func)
        outs = _tensors(out)
        if func.is_view or name in VIEW_OPS or name in ALLOC_OPS \
                or not outs:
            return
        t = self.totals
        t.flops += op_cost(func, args, kwargs, out).flops
        if name in WRITES:
            # the update read and written, and its indices read; a
            # scalar update writes one element an index
            i = WRITES[name]
            upd = args[i] if len(args) > i else next(iter(kwargs.values()))
            idx = _tensors(args[1:i])
            upd_b = _nbytes([upd]) if isinstance(upd, torch.Tensor) \
                else sum(x.numel() for x in idx) * outs[0].element_size()
            t.bytes += 2 * upd_b + _nbytes(idx)
        elif name in GATHERS:                # the rows read and written
            t.bytes += 2 * _nbytes(outs) + _nbytes(_tensors(args[1:]))
        elif name in ("clone", "copy_", "_to_copy"):
            src = args[1] if name == "copy_" else args[0]
            moved = _nbytes([src]) + _nbytes(outs[:1])
            t.bytes += moved
            if src.dtype != outs[0].dtype:
                t.cast_bytes += moved
        else:
            t.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = COLLECTIVES.get(op_name(func))
            if kind is not None:
                self._collective(kind, args)
            return out
        if func.namespace in ("aten", "repro_torch") and not in_call():
            self._op(func, args, kwargs, out)
            self._track(_tensors(out), _tensors((args, kwargs)))
        return out

