"""Operations and bytes of the published Zamba2 hybrid's serving calls
(``reference/zamba2_hybrid.py``'s equations), counted for what the inputs
need: matrix products only (the conv, the norms and the activations are a
few operations a value, under 0.1% of a step), each Mamba2 input
projection once, the SSD as the program's chunked scan computes it,
causal attention over the pairs at or below the diagonal, and the logits
of the last position of a prefill alone.

The SSD of a prefill of S positions runs in chunks of Q, the largest
length up to ``ssm.chunk`` that divides S (the program's chunk rule): in
each chunk every head takes C.B over all Q x Q pairs and the scores' Q x Q
product with x (the program masks, it does not skip, the upper half), the
carried state's read-out, and the state's update. A decode step updates
each head's state with one outer product and reads it out.

A decode round's bytes count every weight once (what a batched step
would read; the tied embedding is read whole by the logits) and each
request's own: its embedding row, every layer's Mamba2 state (the SSD
state and the conv window, fp32) read and written, and the K and V of the
positions it attends in each application of the shared block.

Without ``hybrid.layer_ids`` the counts are of the JAX package's block,
as the reference computes it: one shared block, no adapter and no L_k,
after every ``shared_attn_every`` layers, and an untied ``unembed``.
"""
from __future__ import annotations

from portbench import arith

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
F32 = 4


def elt(m: dict) -> int:
    return ELT[m["param_dtype"]]


def _ssm(m: dict):
    """(d_in, heads, head dim P, state N, groups G, conv channels, K)."""
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    G = s.get("n_groups", 1)
    return (d_in, d_in // s["head_dim"], s["head_dim"], s["d_state"], G,
            d_in + 2 * G * s["d_state"], s["conv_kernel"])


def _published(m: dict) -> bool:
    return bool(m["hybrid"].get("layer_ids"))


def _apps(m: dict) -> int:
    h = m["hybrid"]
    return len(h["layer_ids"]) if _published(m) \
        else m["n_layers"] // h["shared_attn_every"]


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attention_calls(m: dict) -> int:
    """``flash_attention`` calls a prefill, ``flash_decode`` calls a step:
    one an application of the shared block."""
    return _apps(m)


def chunk_len(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def mamba_token_flops(m: dict) -> float:
    """One position's in_proj and out_proj in one Mamba2 layer."""
    d = m["d_model"]
    d_in, nh, _, N, G = _ssm(m)[:5]
    return 2.0 * d * (2 * d_in + 2 * G * N + nh) + 2.0 * d_in * d


def ssd_prefill_flops(m: dict, S: int) -> float:
    """One layer's chunked SSD over S positions (batch 1)."""
    _, nh, P, N = _ssm(m)[:4]
    Q = chunk_len(S, m["ssm"]["chunk"])
    per_chunk = 2.0 * nh * Q * Q * (N + P) + 4.0 * nh * Q * N * P
    return S // Q * per_chunk


def ssd_decode_flops(m: dict) -> float:
    """One layer's state update and read-out for one token."""
    _, nh, P, N = _ssm(m)[:4]
    return 4.0 * nh * P * N


def block_token_flops(m: dict) -> float:
    """One position's products in one application of the shared block: q,
    k, v over [x; e], o, the MLP with its adapter, and L_k."""
    d, ff, H, KVH, hd = (m["d_model"], m["d_ff"], m["n_heads"],
                         m["kv_heads"], _hd(m))
    r = m["hybrid"].get("adapter_rank", 0)
    d_att = 2 * d if _published(m) else d
    return 2.0 * d_att * (H + 2 * KVH) * hd + 2.0 * H * hd * d \
        + 2.0 * d * 2 * ff + 2.0 * ff * d + 2.0 * r * (d + 2 * ff) \
        + 2.0 * d * d * _published(m)


def flash_attention_call(m: dict, S: int) -> tuple[float, float]:
    return arith.flash_attention_cost(1, m["n_heads"], m["kv_heads"], S, S,
                                      _hd(m), _hd(m), True, elt(m))


def flash_decode_call(m: dict, L: int) -> tuple[float, float]:
    return arith.flash_decode_cost(1, m["n_heads"], m["kv_heads"], L,
                                   _hd(m), elt(m))


def prefill_flops(m: dict, S: int, causal_half: bool = True) -> float:
    """A batch-1 prefill of ``S`` tokens; ``causal_half`` False counts the
    attention products over all S x S pairs."""
    H, KVH, hd = m["n_heads"], m["kv_heads"], _hd(m)
    core = arith.flash_attention_cost(1, H, KVH, S, S, hd, hd,
                                      causal_half)[0]
    return m["n_layers"] * (S * mamba_token_flops(m)
                            + ssd_prefill_flops(m, S)) \
        + _apps(m) * (S * block_token_flops(m) + core) \
        + 2.0 * m["d_model"] * m["vocab"]


def decode_flops(m: dict, L_pos: int) -> float:
    """One request's decode step attending ``L_pos`` positions."""
    return m["n_layers"] * (mamba_token_flops(m) + ssd_decode_flops(m)) \
        + _apps(m) * (block_token_flops(m) + flash_decode_call(m, L_pos)[0]) \
        + 2.0 * m["d_model"] * m["vocab"]


def weight_bytes(m: dict) -> float:
    """Every parameter, the tied embedding table included (the logits read
    it whole; an untied one is not, as in ``dense_gqa``); each layer's
    ``dt_bias``, ``A_log`` and ``D`` are fp32."""
    d, ff, V, L = m["d_model"], m["d_ff"], m["vocab"], m["n_layers"]
    H, KVH, hd = m["n_heads"], m["kv_heads"], _hd(m)
    h = m["hybrid"]
    d_in, nh, _, N, G, conv_ch, K = _ssm(m)
    d_att = 2 * d if _published(m) else d
    mamba = d * (2 * d_in + 2 * G * N + nh) + K * conv_ch + conv_ch \
        + d_in + d_in * d + d
    block = d_att * (H + 2 * KVH) * hd + H * hd * d + d * 2 * ff + ff * d \
        + d_att + d
    app = d * d + h.get("adapter_rank", 0) * (d + 2 * ff) \
        if _published(m) else 0
    n = L * mamba + h.get("n_blocks", 1) * block + _apps(m) * app + V * d \
        + d
    return float(elt(m) * n + F32 * L * 3 * nh)


def request_bytes(m: dict, L_pos: int) -> float:
    """One request's own bytes in a decode step: its embedding row, every
    layer's Mamba2 state read and written, and the K and V of the
    ``L_pos`` positions it attends in each application."""
    _, nh, P, N, _, conv_ch, K = _ssm(m)
    state = F32 * (nh * P * N + (K - 1) * conv_ch)
    kv = elt(m) * 2 * m["kv_heads"] * _hd(m) * L_pos
    return float(elt(m) * m["d_model"] + m["n_layers"] * 2 * state
                 + _apps(m) * kv)
