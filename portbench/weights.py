"""The weights of a run, made by the benchmark from the seed, on the device
and in the dtype they are served in, one call a parameter (a stacked
parameter holds every layer), from one ``torch.Generator`` on the device.

A reference module's ``param_draws(model)`` says what to make: each
parameter's path, shape, dtype and draw. The program and the reference
are both handed the same tensors; ``check_layout`` holds them to the
program's own parameter layout before a run.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def make(draws: dict, param_dtype: str, gen: torch.Generator,
         device) -> dict:
    """A nested dict of tensors from ``draws`` (path -> (shape, dtype,
    draw)), in sorted path order. Draws: ("normal", std), ("const", v),
    ("dt_bias", lo, hi): softplus^-1 of exp(U(lo, hi)) in fp32, and
    ("log_linspace", lo, hi): log(linspace(lo, hi, n)) over the last dim,
    the same for every leading index."""
    tree: dict = {}
    for path in sorted(draws):
        shape, dtype, draw = draws[path]
        dt = DTYPES[param_dtype if dtype == "param" else dtype]
        t = torch.empty(shape, dtype=dt, device=device)
        kind = draw[0]
        if kind == "normal":
            t.normal_(0.0, draw[1], generator=gen)
        elif kind == "const":
            t.fill_(draw[1])
        elif kind == "dt_bias":
            lo, hi = draw[1:]
            u = torch.rand(shape, dtype=torch.float32, device=device,
                           generator=gen) * (hi - lo) + lo
            dt0 = torch.exp(u)
            t.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
        elif kind == "log_linspace":
            lo, hi = draw[1:]
            t.copy_(torch.log(torch.linspace(lo, hi, shape[-1],
                                             device=device)).expand(shape))
        else:
            raise ValueError(f"{path}: unknown draw {draw!r}")
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def check_layout(params: dict, abstract: dict) -> None:
    """Raise unless ``params`` has exactly the paths, shapes and dtypes of
    the program's ``abstract`` parameters (meta tensors)."""
    got, want = flat(params), flat(abstract)
    if set(got) != set(want):
        raise ValueError(f"weights: paths differ from the program's: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for k, w in want.items():
        g = got[k]
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise ValueError(f"weights: {k} is {tuple(g.shape)} {g.dtype}, "
                             f"the program takes {tuple(w.shape)} {w.dtype}")


def nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in flat(tree).values())


def count(draws: dict) -> int:
    return sum(math.prod(shape) for shape, _, _ in draws.values())
