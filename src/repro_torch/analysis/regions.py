"""Program-order phase segmentation over the ATen op stream (port of
``repro.analysis.regions``): the paper's 'marked AVX region' at
sub-function granularity, with an H100 machine model.

``segment(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` that
records every op in program order and costs it
(:mod:`repro_torch.analysis.costs`). With meta arguments nothing is
computed or allocated (the counterpart of tracing ``ShapeDtypeStruct``s);
with CUDA arguments the ops run on the card, the port's kernels included.
Each costed op is one leaf, classified into a level by the kind of work it
does, not by the unit a kernel happens to use today:

  level 0  ``scalar``  — narrow outputs / bookkeeping        (SSE analogue)
  level 1  ``vector``  — wide elementwise / integer work on the CUDA
                         cores, at least one warpgroup wide (AVX2 analogue)
  level 2  ``tensor``  — matrix products, tensor-core class
                         (AVX-512 analogue)

So the fp32 CUDA-core ``flash_attention`` is level 2 and stays level 2 when
it moves to ``wgmma``. Consecutive leaves at the same level merge into one
region; ``klass`` is ``heavy`` for level >= 1. ``est_us`` comes from a
roofline :class:`MachineModel` (max of compute and memory time).

The port's layers are a Python loop, not a ``scan``: each layer appears as
its own run of leaves and every region has ``trips == 1``. Totals and
shares equal those of the scan form. Views and allocations cost nothing
and are not leaves. The regions' costs sum to the costs of the recorded
ops exactly (the property tests pin this).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.costs import EqnCost, op_cost, op_name

LEVEL_NAMES = ("scalar", "vector", "tensor")

# one warpgroup: 4 warps x 32 lanes, one warp on each of an SM's four
# schedulers. An op with fewer output elements cannot fill the SM's vector
# lanes even once — scalar-class bookkeeping; wider ones are vector work.
# The same 128 as the reference's VPU lane row and the x86 tool's register
# width test.
VECTOR_LANES = 128.0


@dataclass(frozen=True)
class MachineModel:
    """Roofline constants of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core
    GPU data sheet, dense rates without sparsity, at its 700 W limit):
    989e12 bf16 tensor-core flop/s, 67e12 fp32 flop/s on the CUDA cores,
    3.35e12 B/s of HBM3."""
    tensor_flops_per_s: float = 989e12
    vector_flops_per_s: float = 67e12
    hbm_bytes_per_s: float = 3.35e12

    @property
    def lane_ops_per_s(self) -> float:
        """32-bit operations a second at one per CUDA-core lane per clock
        (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz): the fp32 rate
        counts an FMA as two flops. No integer add / xor / shift work
        (ChaCha20) issues faster."""
        return self.vector_flops_per_s / 2

    def est_us(self, cost: EqnCost) -> float:
        vec = max(cost.flops - cost.mxu_flops, 0.0)
        compute = cost.mxu_flops / self.tensor_flops_per_s \
            + vec / self.vector_flops_per_s
        mem = cost.bytes / self.hbm_bytes_per_s
        return max(compute, mem) * 1e6

    def to_dict(self) -> dict:
        return {"tensor_flops_per_s": self.tensor_flops_per_s,
                "vector_flops_per_s": self.vector_flops_per_s,
                "hbm_bytes_per_s": self.hbm_bytes_per_s,
                "lane_ops_per_s": self.lane_ops_per_s}


@dataclass
class Region:
    """One phase of the timeline. ``start_eqn``/``end_eqn`` are inclusive
    leaf ordinals in program order (the reference's names); ``trips`` is
    1 in the port (no ``scan``), kept so the artifacts match."""
    start_eqn: int
    end_eqn: int
    level: int
    mxu_flops: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    est_us: float = 0.0
    trips: int = 1
    prims: Tuple[str, ...] = ()

    @property
    def klass(self) -> str:
        return "heavy" if self.level >= 1 else "light"

    @property
    def unit(self) -> str:
        return LEVEL_NAMES[self.level]


@dataclass
class RegionTimeline:
    """Ordered phase timeline of one entrypoint + aggregate views."""
    name: str
    regions: List[Region] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    # ---------------------------------------------------------- totals

    @property
    def mxu_flops(self) -> float:
        return sum(r.mxu_flops for r in self.regions)

    @property
    def flops(self) -> float:
        return sum(r.flops for r in self.regions)

    @property
    def bytes(self) -> float:
        return sum(r.bytes for r in self.regions)

    @property
    def est_us(self) -> float:
        return sum(r.est_us for r in self.regions)

    @property
    def heavy_us(self) -> float:
        return sum(r.est_us for r in self.regions if r.level >= 1)

    @property
    def heavy_share(self) -> float:
        """Fraction of estimated time spent in heavy (level>=1) regions."""
        return self.heavy_us / self.est_us if self.est_us else 0.0

    def level_share(self, level: int) -> float:
        if not self.est_us:
            return 0.0
        return sum(r.est_us for r in self.regions
                   if r.level == level) / self.est_us


# --------------------------------------------------------- segmentation


def _leaf_level(cost: EqnCost) -> int:
    if cost.mxu_flops > 0:
        return 2
    if cost.flops > 0 and cost.lanes >= VECTOR_LANES:
        return 1
    return 0


class _Builder:
    def __init__(self, machine: MachineModel):
        self.machine = machine
        self.regions: List[Region] = []
        self.ordinal = 0
        self._open: Optional[Region] = None

    def leaf(self, prim: str, cost: EqnCost):
        est = self.machine.est_us(cost)
        level = _leaf_level(cost)
        o = self.ordinal
        self.ordinal += 1
        cur = self._open
        if cur is not None and cur.level == level:
            cur.end_eqn = o
            cur.mxu_flops += cost.mxu_flops
            cur.flops += cost.flops
            cur.bytes += cost.bytes
            cur.est_us += est
            if prim not in cur.prims:
                cur.prims = cur.prims + (prim,)
            return
        self.flush()
        self._open = Region(start_eqn=o, end_eqn=o, level=level,
                            mxu_flops=cost.mxu_flops, flops=cost.flops,
                            bytes=cost.bytes, est_us=est, prims=(prim,))

    def flush(self):
        if self._open is not None:
            self.regions.append(self._open)
            self._open = None


class OpRecorder(TorchDispatchMode):
    """Runs each op it sees and hands ``(name, cost)`` of every op that
    does device work to ``sink``. Ops that a custom op's implementation
    runs inside it are not seen: the mode is off while it dispatches."""

    def __init__(self, sink: Callable[[str, EqnCost], None]):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        if not cost.is_zero:
            self.sink(op_name(func), cost)
        return out


def record(fn: Callable, *args) -> List[Tuple[str, EqnCost]]:
    """Run ``fn(*args)`` without autograd and return its costed ops,
    [(op name, cost), ...] in program order."""
    ops: List[Tuple[str, EqnCost]] = []
    with torch.no_grad(), OpRecorder(lambda n, c: ops.append((n, c))):
        fn(*args)
    return ops


def fn_cost(fn: Callable, *args) -> EqnCost:
    """Total cost of running ``fn(*args)`` (the reference's
    ``jaxpr_cost`` over ``make_jaxpr(fn)``)."""
    total = EqnCost()
    for _, c in record(fn, *args):
        total = total + c
    return total


# regions shorter than this fraction of the whole timeline are folded
# into their neighbor — a sub-permille bookkeeping gap (a scalar `get`
# between two vector blocks) is not a phase, and folding it keeps the
# lint's heavy/light alternation signal about real phases only
FOLD_FRAC = 0.002


def _absorb(dst: Region, src: Region):
    dst.start_eqn = min(dst.start_eqn, src.start_eqn)
    dst.end_eqn = max(dst.end_eqn, src.end_eqn)
    dst.mxu_flops += src.mxu_flops
    dst.flops += src.flops
    dst.bytes += src.bytes
    dst.est_us += src.est_us
    for p in src.prims:
        if p not in dst.prims:
            dst.prims = dst.prims + (p,)


def _fold(regions: List[Region], frac: float = FOLD_FRAC) -> List[Region]:
    total = sum(r.est_us for r in regions)
    if total <= 0 or len(regions) <= 1:
        return regions
    thresh = total * frac
    out: List[Region] = []
    pending: Optional[Region] = None          # tiny head with no host yet
    for r in regions:
        if r.est_us < thresh:
            if out:
                _absorb(out[-1], r)
            elif pending is None:
                pending = r
            else:
                _absorb(pending, r)
            continue
        if pending is not None:               # tiny head folds forward
            _absorb(r, pending)
            pending = None
        out.append(r)
    if pending is not None:
        out.append(pending)
    # folding may leave adjacent regions at the same level: merge them
    merged: List[Region] = []
    for r in out:
        if merged and merged[-1].level == r.level \
                and merged[-1].trips == r.trips:
            _absorb(merged[-1], r)
        else:
            merged.append(r)
    return merged


def segment(fn: Callable, *args, name: str = "",
            machine: MachineModel = MachineModel(),
            fold_frac: float = FOLD_FRAC) -> RegionTimeline:
    """Run ``fn(*args)`` under the op recorder (meta args: nothing is
    materialized; CUDA args: the ops run on the card) and segment its op
    stream into a phase timeline."""
    builder = _Builder(machine)
    for prim, cost in record(fn, *args):
        builder.leaf(prim, cost)
    builder.flush()
    return RegionTimeline(name=name or getattr(fn, "__name__", "fn"),
                          regions=_fold(builder.regions, fold_frac))


# --------------------------------------------------------- heavy tagging


def tag_heavy(timelines: Sequence[RegionTimeline], *,
              min_heavy_share: float = 0.25,
              rel_duration: float = 0.10) -> List[str]:
    """Which entrypoints should be tagged as heavy phases (the paper's
    'mark this region' decision), scale-free so it works on reduced CPU
    configs and full zoo configs alike.

    A timeline is tagged when (a) heavy regions cover at least
    ``min_heavy_share`` of its estimated time AND (b) its per-invocation
    heavy time is at least ``rel_duration`` of the cohort's largest —
    the paper's *density* criterion (§3.3: stalls and short bursts do
    not change frequency). Decode steps are MXU-classed but orders of
    magnitude shorter per invocation than a prefill, so (b) leaves them
    untagged: confining them to the licensed pool would thrash."""
    if not timelines:
        return []
    max_heavy = max(t.heavy_us for t in timelines)
    if max_heavy <= 0:
        return []
    return [t.name for t in timelines
            if t.heavy_share >= min_heavy_share
            and t.heavy_us >= rel_duration * max_heavy]


# ------------------------------------------------------------ compat API
# The reference's whole-function interface, derived from the same cost
# walk: ranking whole functions is still the right first look before
# reading a timeline.


@dataclass
class FunctionProfile:
    name: str
    mxu_flops: float
    total_flops: float
    bytes_touched: float

    @property
    def heavy_ratio(self) -> float:
        return self.mxu_flops / self.total_flops if self.total_flops else 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.total_flops / self.bytes_touched if self.bytes_touched \
            else 0.0


def analyze(fn: Callable, *args, name: str = "") -> FunctionProfile:
    """Whole-function profile (the reference's ``analyze_jaxpr``)."""
    c = fn_cost(fn, *args)
    return FunctionProfile(name or getattr(fn, "__name__", "fn"),
                           c.mxu_flops, c.flops, c.bytes)


def rank_functions(entries: Sequence[Tuple[str, Callable, tuple]]
                   ) -> List[FunctionProfile]:
    """The paper's report: functions sorted by heavy-op ratio (descending).
    entries: (name, fn, example_args)."""
    profs = [analyze(fn, *args, name=nm) for nm, fn, args in entries]
    return sorted(profs, key=lambda p: (p.heavy_ratio,
                                        p.arithmetic_intensity), reverse=True)


def report(profs: Sequence[FunctionProfile]) -> str:
    lines = [f"{'function':30s} {'heavy_ratio':>11s} {'GFLOP':>10s} "
             f"{'AI(flop/B)':>10s}"]
    for p in profs:
        lines.append(f"{p.name:30s} {p.heavy_ratio:11.3f} "
                     f"{p.total_flops/1e9:10.2f} "
                     f"{p.arithmetic_intensity:10.1f}")
    return "\n".join(lines)
