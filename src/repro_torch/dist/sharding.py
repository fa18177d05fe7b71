"""Partition specs, their sanitation, and placement of tensors on a mesh:
the port of ``repro.dist.sharding``.

Model code writes *intent* specs (``P(('data',), 'model')`` ...) without
knowing the mesh it will run on or whether the (possibly ``reduced()``)
tensor dims divide the axis sizes. ``sanitize_spec`` reconciles one spec
against a concrete shape and mesh, exactly as the reference's does;
``sanitize_specs`` and ``tree_shardings`` lift it over nested dicts.

``P`` is the port's own ``PartitionSpec``: a tuple with one entry a
dimension, each None, an axis name or a tuple of axis names (a
one-name tuple becomes the name and a list a tuple, as JAX normalises
them). A tuple entry shards its dimension over the product of its axes,
the first axis major: the shard of the rank at coordinates (i, j) of
axes (a, b) is number i * |b| + j.

A mesh here is anything with ``shape`` (axis name -> size, in mesh
order) and, for the placement helpers, ``coords`` (axis name -> this
rank's index) and ``group(axes)`` (the process group of those axes):
``repro_torch.dist.context.Mesh``. The two helpers everything else uses
are ``shard`` (this rank's block of a full tensor) and ``gather`` (a
block back to the full tensor, autograd-aware: its backward is the
reduce-scatter, which gives each owner its slice of the summed
gradient).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.dist.collectives import all_gather


class P(tuple):
    """PartitionSpec: ``P('data', None, ('data', 'model'))``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def sanitize_spec(spec, shape: Tuple[int, ...], mesh) -> P:
    """Make ``spec`` valid for a tensor of ``shape`` on ``mesh``.

    Per dimension: axis names absent from the mesh are dropped; then,
    while the product of the remaining axis sizes does not divide the
    dimension, axes are dropped from the right (innermost first). A spec
    shorter than the rank is padded with ``None``; extra entries beyond
    the rank are discarded. With no mesh the result is fully replicated.
    """
    if mesh is None:
        return P(*([None] * len(shape)))
    sizes = dict(mesh.shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        axes = [a for a in entry_axes(entry) if a in sizes]
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            axes.pop()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def map_with_specs(fn, tree: Any, *specs: Any):
    """``fn(leaf, *specs)`` over a nested dict and dicts of specs (or
    placements) of the same structure; a spec is a leaf, though it is a
    tuple. With no specs, a map over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, *(s[k] for s in specs))
                for k, v in tree.items()}
    return fn(tree, *specs)


def sanitize_specs(tree: Any, specs: Any, mesh) -> Any:
    """Sanitize a dict of specs against a matching dict of tensors (or
    anything with ``.shape``)."""
    return map_with_specs(
        lambda a, s: sanitize_spec(s if s is not None else P(),
                                   tuple(a.shape), mesh), tree, specs)


def axis_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(axes))


def axis_index(mesh, axes) -> int:
    """This rank's shard number over ``axes``, the first axis major (the
    counterpart of ``jax.lax.axis_index`` over a tuple of axes)."""
    idx = 0
    for a in entry_axes(axes):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh: its sanitized ``spec``, and for
    each sharded dimension the axes (and so the process group) that
    split it. The counterpart of the reference's ``NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def dims(self) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
        return tuple((d, entry_axes(e)) for d, e in enumerate(self.spec)
                     if e is not None)

    @property
    def replica_axes(self) -> Tuple[str, ...]:
        """The mesh axes along which every rank holds the same block."""
        if self.mesh is None:
            return ()
        used = {a for _, axes in self.dims for a in axes}
        return tuple(a for a in self.mesh.shape if a not in used)


def tree_shardings(dist, tree: Any, specs: Any) -> Any:
    """A dict of sanitized ``Placement``s for ``tree`` on ``dist.mesh``
    (None when the context is inactive)."""
    if not dist.active:
        return None
    return map_with_specs(
        lambda a, s: Placement(dist.mesh, sanitize_spec(
            s if s is not None else P(), tuple(a.shape), dist.mesh)),
        tree, specs)


def shard(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` (a view)."""
    for d, axes in placement.dims:
        n = x.shape[d] // axis_size(placement.mesh, axes)
        x = x.narrow(d, axis_index(placement.mesh, axes) * n, n)
    return x


def gather(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The full tensor from this rank's block ``x``: an all-gather over
    each sharded dimension's axes, innermost dimension last. Under
    autograd its backward reduce-scatters the gradient (a sum over the
    gathering ranks); summing over ``replica_axes`` is the caller's."""
    for d, axes in placement.dims:
        x = all_gather(x, placement.mesh.group(axes), d)
    return x
