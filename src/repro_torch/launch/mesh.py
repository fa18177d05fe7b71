"""Mesh construction over the current ``torch.distributed`` world: the
port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. The caller starts the world first
(``torch.distributed.init_process_group`` with its address, world size
and rank; NCCL after ``torch.cuda.set_device``), on every rank.
"""
from __future__ import annotations

from repro_torch.dist.context import build_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes, 16 x 16 ("data", "model") or
    2 x 16 x 16 ("pod", "data", "model"); raises unless the world has
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """A small mesh over the current world (8 ranks by default)."""
    return build_mesh(shape, axes)
