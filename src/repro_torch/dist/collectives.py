"""Collectives over process groups: the named-axis primitives the sharded
code is written with, and the port of ``repro.dist.collectives``.

The primitives are the counterparts of ``jax.lax``'s collectives inside
a ``shard_map`` body, each over the process group of a mesh axis (or a
tuple of axes: ``Mesh.group``), and each differentiable as the
reference's are under ``jax.grad``: ``all_gather`` (tiled, along a dim;
backward the reduce-scatter), ``reduce_scatter`` (the reverse),
``psum`` / ``pmean`` (backward the same sum), ``all_to_all`` (tiled on dim
0; backward the reverse exchange), and ``pmax`` (no gradient: a shift,
as a softmax's max). Every call runs inside the profiler range
``collectives``. Each backward is the transpose of its forward, so a
sharded program's gradients are the sum of what its ranks' backwards
give: the tensor-parallel regions of ``models.tp`` are these primitives
(the all-gather and reduce-scatter over a sequence, the all-reduce
out of a row-parallel product). A tensor must lie on the group's own device kind:
CUDA for NCCL, the CPU for gloo, either for the ``fake`` backend of a
dry-run (which moves nothing); nothing is staged through the host.

* ``compressed_allreduce`` — int8-quantized mean with error feedback:
  each rank quantizes (value + carried residual) to int8 with one fp32
  scale, the int8 payload and the scales are all-gathered, and each rank
  dequantizes locally. Feed the returned residual into the next call, so
  quantization error accumulates into later steps instead of being lost.
* ``hierarchical_allreduce`` — a multi-pod sum decomposed into an
  intra-pod reduce-scatter, an inter-pod all-reduce on 1/Nth of the data
  and an intra-pod all-gather, so the slow links carry only the
  scattered fraction.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as tdist
from torch.profiler import record_function


_span = threading.local()


@contextlib.contextmanager
def _call():
    """The span of one process-group call, in the profiler range
    ``collectives``. Ops that the backend runs inside it are its own (gloo
    copies a reduce-scatter's result out with ``split`` and ``copy_``
    while the caller waits); ``in_call`` tells a cost count
    (``roofline.op_cost``) to leave them out."""
    with record_function("collectives"):
        _span.active = True
        try:
            yield
        finally:
            _span.active = False


def in_call() -> bool:
    """True inside a process-group call of this module, on this thread."""
    return getattr(_span, "active", False)


def _ready(x: torch.Tensor, group) -> torch.Tensor:
    backend = str(tdist.get_backend(group))
    if backend != "fake" and (backend == "nccl") != x.is_cuda:
        raise ValueError(f"a {x.device} tensor cannot go through a "
                         f"{backend} collective")
    return x.contiguous()


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``, contiguous (a
    strided result would send the products that read it down other
    kernels than the single device's)."""
    x = _ready(x, group)
    n = tdist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with _call():
        tdist.all_gather_into_tensor(out, x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over the group."""
    n = tdist.get_world_size(group)
    shape = list(x.shape)
    blocks = x.reshape(shape[:dim] + [n, shape[dim] // n]
                       + shape[dim + 1:]).movedim(dim, 0)
    blocks = _ready(blocks, group)
    out = blocks.new_empty(tuple(blocks.shape[1:]))
    with _call():
        tdist.reduce_scatter_tensor(
            out, blocks.view((-1,) + tuple(blocks.shape[2:])),
            op=tdist.ReduceOp.SUM, group=group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = _ready(x, group).clone()
    with _call():
        tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=group)
    return x


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = _ready(x, group)
    out = torch.empty_like(x)
    with _call():
        tdist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in group-rank order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over the group
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    return _ReduceScatter.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Sum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / tdist.get_world_size(group)


@torch.no_grad()
def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group, without a gradient."""
    x = _ready(x, group).clone()
    with _call():
        tdist.all_reduce(x, op=tdist.ReduceOp.MAX, group=group)
    return x


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 split into one block a rank, block j sent to rank j, the
    received blocks concatenated in rank order
    (``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``)."""
    return _AllToAll.apply(x, group)


def quantize_int8(v: torch.Tensor):
    """(int8 payload, fp32 scale) of fp32 ``v``: the scale is max |v| /
    127 (1 when v is all zeros), the payload round(v / scale) clipped to
    [-127, 127], rounded half to even as ``jnp.round``."""
    amax = v.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compressed_allreduce(x: torch.Tensor, err: torch.Tensor, group):
    """Int8 mean-allreduce of ``x`` over ``group`` with error feedback.
    Returns ``(mean, new_err)``: ``mean`` approximates the mean of ``x``
    over the group (the same value on every rank); ``new_err`` is this
    rank's quantization residual for the next call."""
    v = x.float() + err.float()
    q, scale = quantize_int8(v)
    new_err = v - q.float() * scale
    n = tdist.get_world_size(group)
    qs = _gather(q[None], group, 0)                   # int8 on the wire
    scales = _gather(scale.reshape(1), group, 0)      # one fp32 a rank
    mean = torch.einsum("n,n...->...", scales, qs.float()) / n
    return mean.to(x.dtype), new_err.to(err.dtype)


def hierarchical_allreduce(x: torch.Tensor, pod_group, local_group, *,
                           scatter_dim: int = 0) -> torch.Tensor:
    """Sum of ``x`` over the pod and local groups together, through the
    pod hierarchy. ``x.shape[scatter_dim]`` must divide by the local
    group's size (the intra-pod reduce-scatter's block)."""
    part = reduce_scatter(x, local_group, scatter_dim)
    part = psum(part, pod_group)
    return all_gather(part, local_group, scatter_dim)
