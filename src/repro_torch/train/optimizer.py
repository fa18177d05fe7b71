"""AdamW with global-norm clipping, a cosine schedule and a configurable
optimizer-state dtype, the port of ``repro.train.optimizer``.

Plain functions over the parameter dict (``{"layers": {...}, "embed":
...}``), run under ``torch.no_grad()``. The update is the reference's, op
for op, in fp32 whatever the parameter dtype, and returns new tensors
(the reference's is functional). As in the reference, weight decay applies
to every parameter of two or more dims (``p.ndim >= 2``): that includes the
norm scales stacked on the layer axis ([L, d]), while ``final_norm``'s
[d] is not decayed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import DTYPES


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory


def _map(fn, *trees):
    """``fn`` over the leaves of dicts of one structure."""
    return {k: _map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def _leaves(tree) -> list:
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zeroed first and second moments in ``cfg.state_dtype`` and the
    step count (int32 scalar)."""
    sd = DTYPES[cfg.state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=sd, device=p.device)

    leaf = _leaves(params)[0]
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    sd = DTYPES[cfg.state_dtype]
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        step_dir = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            step_dir = step_dir + cfg.weight_decay * p.float()
        return (p.float() - lr * step_dir).to(p.dtype), m32.to(sd), \
            v32.to(sd)

    out = _map(lambda *a: upd(*a), params, grads, state["m"], state["v"])
    pick = lambda i: _map(lambda o: o[i], out)   # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
