"""Carry the reference's parameters into the port.

``params_from_jax`` takes the reference's parameter pytree already
flattened to a ``/``-joined dict of numpy arrays (the caller flattens it;
this module imports neither JAX nor the reference) and rebuilds the
port's nested dict of tensors, key for key and shape for shape. The two
layouts are the same, so the map is one-to-one.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    name = str(a.dtype)
    if name == "bfloat16":          # numpy has no bfloat16: go via fp32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a)).to(
        device=device, dtype=_TORCH_DTYPES.get(name))


def unflatten(flat: dict) -> dict:
    """``/``-joined flat dict -> nested dict, key for key."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        if leaf in node:
            raise ValueError(f"duplicate parameter key {key!r}")
        node[leaf] = v
    return out


def params_from_jax(flat: dict, device) -> dict:
    """``{"layers/attn/wq/w": array, ...}`` -> nested dict of tensors on
    ``device``."""
    return unflatten({k: _tensor(a, device) for k, a in flat.items()})


def flatten(params: dict, prefix: str = "") -> dict:
    """Nested dict of tensors -> ``/``-joined flat dict (the inverse)."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat
