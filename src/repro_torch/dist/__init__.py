"""Distributed execution on ``torch.distributed``: the port of
``repro.dist`` (gloo across CPU processes, NCCL on the card).

Submodules:

* ``context``     — ``Mesh`` (named axes over the world, a process group
                    for each tuple of axes), ``DistContext`` (axis roles +
                    sharding knobs), ``make_dist``/``no_dist``.
* ``sharding``    — the port's ``P``, spec sanitation (``sanitize_specs``),
                    ``Placement``s (``tree_shardings``), ``shard`` and the
                    autograd-aware ``gather``.
* ``collectives`` — the named-axis primitives (``all_gather``, ``psum``,
                    ``all_to_all`` ...), ``compressed_allreduce`` (int8 +
                    error feedback) and ``hierarchical_allreduce``.
* ``pipeline``    — ``gpipe_apply`` microbatched pipeline parallelism.
"""
from __future__ import annotations

from repro_torch.dist.context import DistContext, Mesh, make_dist, no_dist
from repro_torch.dist.sharding import P, sanitize_specs, tree_shardings

__all__ = ["DistContext", "Mesh", "P", "make_dist", "no_dist",
           "sanitize_specs", "tree_shardings"]
