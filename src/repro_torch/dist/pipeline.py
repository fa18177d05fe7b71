"""GPipe-style pipeline parallelism over a ``stage`` mesh axis: the port
of ``repro.dist.pipeline``.

``gpipe_apply`` splits a stack of L identical layers into contiguous
stages, one a rank along the stage axis, and streams microbatches
through them: at step t, stage s runs microbatch t - s and hands its
activation to stage s + 1 (point-to-point, ``batch_isend_irecv``, where
the reference's ``ppermute`` shifts the ring). Total steps = n_micro +
n_stages - 1 (fill + drain bubble); the last stage's outputs are summed
to every rank, as the reference's ``psum`` does, and the numerics are
those of applying the layers in sequence. Forward only (the handoffs
are not differentiated).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch.dist.collectives import psum


@torch.no_grad()
def gpipe_apply(layer_fn, ws, x, *, mesh, layers_per_stage,
                stage_axis: str = "stage"):
    """Apply L stacked layers to microbatched inputs, pipelined.

    layer_fn:        ``(w, h) -> h`` single-layer apply.
    ws:              ``[L, ...]`` stacked layer weights (the full stack;
                     each stage applies its own contiguous block).
    x:               ``[n_micro, ...microbatch...]`` inputs.
    mesh:            mesh containing ``stage_axis``.
    layers_per_stage: contiguous layers owned by each stage;
                     ``L == layers_per_stage * mesh.shape[stage_axis]``.

    Returns ``[n_micro, ...]`` outputs equal to applying all L layers
    sequentially to every microbatch, on every rank.
    """
    n_stages = mesh.shape[stage_axis]
    L = ws.shape[0]
    if L != layers_per_stage * n_stages:
        raise ValueError(f"{L} layers != {layers_per_stage} x {n_stages}")
    n_micro = x.shape[0]
    n_steps = n_micro + n_stages - 1
    group = mesh.group(stage_axis)
    sid = mesh.coords[stage_axis]
    w_s = ws[sid * layers_per_stage:(sid + 1) * layers_per_stage]
    nxt = tdist.get_global_rank(group, (sid + 1) % n_stages)
    prv = tdist.get_global_rank(group, (sid - 1) % n_stages)

    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(n_steps):
        # stage 0 injects a fresh microbatch; the others use the handoff
        h = x[min(t, n_micro - 1)] if sid == 0 else buf
        for w in w_s:
            h = layer_fn(w, h)
        # the last stage finishes microbatch t - (n_stages - 1)
        mb = t - (n_stages - 1)
        if sid == n_stages - 1 and mb >= 0:
            out[mb] = h
        if n_stages > 1 and t < n_steps - 1:
            buf = torch.empty_like(h)
            for req in tdist.batch_isend_irecv([
                    tdist.P2POp(tdist.isend, h.contiguous(), nxt, group),
                    tdist.P2POp(tdist.irecv, buf, prv, group)]):
                req.wait()
    # only the last stage holds real outputs; replicate them
    if sid != n_stages - 1:
        out.zero_()
    return psum(out, group)
