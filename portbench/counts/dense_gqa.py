"""Operations and bytes of the dense GQA decoder's serving calls, counted
for what the inputs need, from the JAX package's equations: matrix
products only (the norms, RoPE and activations are a few operations a
value, under 0.1% of a step), causal attention over the pairs at or below
the diagonal, and the logits of the last position of a prefill alone (the
program computes no others).

A decode round's bytes count every weight once (what a batched step
would read) and each request's own: its embedding row and the K and V of
the positions it attends.
"""
from __future__ import annotations

from portbench import arith

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dims(m: dict):
    d, H = m["d_model"], m["n_heads"]
    hd = m.get("head_dim") or d // H
    return d, H, m["kv_heads"], hd, m["d_ff"], m["vocab"], m["n_layers"]


def elt(m: dict) -> int:
    return ELT[m["param_dtype"]]


def attention_calls(m: dict) -> int:
    """``flash_attention`` calls a prefill, ``flash_decode`` calls a step."""
    return m["n_layers"]


def token_flops(m: dict) -> float:
    """One position's dense products in one layer: q, k, v, o and the
    MLP."""
    d, H, KVH, hd, ff = _dims(m)[:5]
    mlp = 3 if m.get("glu", True) else 2
    return 2.0 * d * (H * hd + 2 * KVH * hd) + 2.0 * H * hd * d \
        + 2.0 * d * ff * mlp


def flash_attention_call(m: dict, S: int) -> tuple[float, float]:
    d, H, KVH, hd = _dims(m)[:4]
    return arith.flash_attention_cost(1, H, KVH, S, S, hd, hd, True, elt(m))


def flash_decode_call(m: dict, L: int) -> tuple[float, float]:
    d, H, KVH, hd = _dims(m)[:4]
    return arith.flash_decode_cost(1, H, KVH, L, hd, elt(m))


def prefill_flops(m: dict, S: int, causal_half: bool = True) -> float:
    """A batch-1 prefill of ``S`` tokens; ``causal_half`` False counts the
    attention products over all S x S pairs."""
    d, H, KVH, hd, ff, V, L = _dims(m)
    core = arith.flash_attention_cost(1, H, KVH, S, S, hd, hd, causal_half)[0]
    return L * (S * token_flops(m) + core) + 2.0 * d * V


def decode_flops(m: dict, L_pos: int) -> float:
    """One request's decode step attending ``L_pos`` positions."""
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    return L * (token_flops(m) + flash_decode_call(m, L_pos)[0]) \
        + 2.0 * d * V


def weight_bytes(m: dict) -> float:
    """Every parameter but the embedding table."""
    d, H, KVH, hd, ff, V, L = _dims(m)
    mlp = 3 if m.get("glu", True) else 2
    norm = 2 if m["norm"] == "layernorm" else 1
    layer = d * (H * hd + 2 * KVH * hd) + H * hd * d + d * ff * mlp \
        + 2 * norm * d
    return float(elt(m) * (L * layer + V * d + norm * d))


def request_bytes(m: dict, L_pos: int) -> float:
    """One request's own bytes in a decode step: its embedding row and
    the K and V of the ``L_pos`` positions it attends, every layer."""
    d, H, KVH, hd, ff, V, L = _dims(m)
    return float(elt(m) * (d + L * 2 * KVH * hd * L_pos))
