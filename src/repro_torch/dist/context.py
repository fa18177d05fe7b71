"""Distributed context: which mesh axes play which role, plus the
sharding knobs every layer threads through (``fsdp``, ``zero1``,
``seq_parallel``, ``ep_over_dp``). The port of ``repro.dist.context``.

Axis conventions (see ``launch/mesh.py``): the tensor/expert-parallel
axis is named ``model``; every other axis (``data``, and ``pod`` on
multi-pod meshes) is data-parallel, except ``stage`` (pipeline stages).

``Mesh`` is the port's device mesh: named axes over the ranks of the
current ``torch.distributed`` world, laid out row-major (rank = the
coordinates' row-major index), on this rank's device (its CUDA device
under NCCL, the CPU under gloo, and under the ``fake`` backend of a
dry-run the device its trace asks for, CUDA unless told otherwise). It
makes the process group of every tuple of axes in mesh order once, on
every rank, when it is built
(``torch.distributed.new_subgroups_by_enumeration``); a group's ranks,
sorted as torch keeps them, are then in the order of the reference's
shard numbers (the first axis major).

``DistContext`` is a frozen dataclass so it can be closed over freely.
``constrain`` marks where the reference constrains an activation's
sharding and returns the tensor unchanged: in eager PyTorch nothing
plays GSPMD's role, so the constraint has nothing to tell. The sharded
paths place and gather explicitly (``dist.sharding``, the MoE bodies,
``train.loop.make_train_step``). At the transformer's block boundaries,
where the reference constrains the residual (to ``P(dp, model, None)``
under ``seq_parallel``), the row-parallel exit plays the constraint's
role: a reduce-scatter over the sequence under ``seq_parallel``, else an
all-reduce (``models.tp``).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.dist.sharding import P

#: mesh axes that are never data-parallel: ``model`` carries TP/EP,
#: ``stage`` carries pipeline stages (see ``pipeline.gpipe_apply``).
_NON_DP_AXES = ("model", "stage")


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the current world; see the module docstring."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[Tuple[str, ...], object] = field(repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axes) -> object:
        """The process group of ``axes`` (a name or a tuple of names in
        mesh order) that holds this rank."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self.groups:
            raise ValueError(f"axes {key} are not a tuple of the mesh's "
                             f"axes {self.axis_names} in mesh order")
        return self.groups[key]


def build_mesh(shape, axes, device=None) -> Mesh:
    """A ``Mesh`` of ``shape`` named ``axes`` over the current world,
    whose size must be the product of ``shape``. Every rank must call it,
    in the same order as every other mesh it builds. ``device`` is the
    fake backend's (``cuda`` by default); NCCL and gloo fix their own."""
    if not tdist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group before building a mesh")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = tdist.get_world_size()
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} {axes} does not cover the world "
                         f"of {world} ranks")
    backend = tdist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "fake":
        device = torch.device(device or "cuda")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    grid = torch.arange(world).reshape(shape)
    rank = tdist.get_rank()
    coords = dict(zip(axes, (int(c) for c in torch.nonzero(grid == rank)[0])))
    groups = {}
    for n in range(1, len(axes) + 1):
        for dims in itertools.combinations(range(len(axes)), n):
            rest = [d for d in range(len(axes)) if d not in dims]
            members = grid.permute(*rest, *dims).reshape(-1, math.prod(
                shape[d] for d in dims))
            group, _ = tdist.new_subgroups_by_enumeration(
                [row.tolist() for row in members])
            groups[tuple(axes[d] for d in dims)] = group
    return Mesh(dict(zip(axes, shape)), coords, device, groups)


@dataclass(frozen=True)
class DistContext:
    active: bool
    mesh: Optional[Mesh] = None
    dp_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    ep_axes: Tuple[str, ...] = ()
    ep_over_dp: bool = False
    fsdp: bool = False
    zero1: bool = False
    seq_parallel: bool = False

    # ------------------------------------------------------- axis sizes

    def _size(self, axes: Tuple[str, ...]) -> int:
        if not self.active or self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in axes) if axes else 1

    @property
    def dp_size(self) -> int:
        return self._size(self.dp_axes)

    @property
    def model_size(self) -> int:
        return self._size((self.model_axis,) if self.model_axis else ())

    @property
    def ep_size(self) -> int:
        return self._size(self.ep_axes)

    # -------------------------------------------------------- placement

    def constrain(self, x, spec: Optional[P]):
        """``x`` unchanged: where the reference hands GSPMD ``spec``
        sanitized to ``x``'s shape, eager PyTorch has no compiler to
        hand it to. Never raises, as the reference's sanitized spec does
        not."""
        return x


def make_dist(mesh, *, fsdp: bool = True, zero1: bool = False,
              seq_parallel: bool = False,
              ep_over_dp: bool = False) -> DistContext:
    """Build a :class:`DistContext` from a mesh.

    * ``fsdp``        — shard big parameter dims over the dp axes
                        (gathered on use).
    * ``zero1``       — replicate params over dp but shard optimizer
                        state (see ``train.loop.train_state_specs``).
    * ``seq_parallel``— activations additionally shard their sequence
                        dim over the model axis between attention/FFN
                        (the transformer family's train forward).
    * ``ep_over_dp``  — expert parallelism spans the full mesh
                        (dp x model) instead of the model axis only.
    """
    names = tuple(mesh.axis_names)
    model_axis = "model" if "model" in names else None
    dp_axes = tuple(n for n in names if n not in _NON_DP_AXES)
    model_tuple = (model_axis,) if model_axis else ()
    ep_axes = (dp_axes + model_tuple) if ep_over_dp else model_tuple
    return DistContext(active=True, mesh=mesh, dp_axes=dp_axes,
                       model_axis=model_axis, ep_axes=ep_axes,
                       ep_over_dp=ep_over_dp, fsdp=fsdp, zero1=zero1,
                       seq_parallel=seq_parallel)


def no_dist() -> DistContext:
    """Single-device context: ``active=False``, every size 1,
    ``constrain`` is the identity."""
    return DistContext(active=False)
