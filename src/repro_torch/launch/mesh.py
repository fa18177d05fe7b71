"""Mesh construction over the current ``torch.distributed`` world: the
port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. The caller starts the world first
(``torch.distributed.init_process_group`` with its address, world size
and rank; NCCL after ``torch.cuda.set_device``), on every rank; the
dry-run starts a fake one (``fake_world``).
"""
from __future__ import annotations

import contextlib

import torch.distributed as tdist

from repro_torch.dist.context import build_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production meshes, 16 x 16 ("data", "model") or
    2 x 16 x 16 ("pod", "data", "model"); raises unless the world has
    256 or 512 ranks. ``device``: the fake backend's (``build_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None):
    """A small mesh over the current world (8 ranks by default)."""
    return build_mesh(shape, axes, device)


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a world of ``world_size`` ranks that exist only in name:
    ``torch.distributed``'s ``fake`` backend, whose collectives return at
    once and move nothing, so one process can trace what rank 0 of a
    production mesh runs. Ends the world on leaving. Raises if a world is
    already running, or if this torch has no fake backend."""
    # the test-support module that registers the backend; an ImportError
    # here means this torch cannot run a dry-run
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        raise RuntimeError("a torch.distributed world is already running")
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world_size)
    try:
        yield
    finally:
        tdist.destroy_process_group()
