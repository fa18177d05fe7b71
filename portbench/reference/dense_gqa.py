"""Plain fp32 reference of the dense GQA decoder (family ``dense``).

A transcription of the JAX package's equations (``src/repro/models/
transformer.py``, ``attention.py``, ``layers.py``), the equations the port
is held to, in plain PyTorch. It imports nothing of the port nor of the
JAX package and takes nothing the program made: it is handed the weights
the benchmark made and the token ids, and computes its logits itself.

Per layer, pre-norm: ``x += wo(attn(rope(wq h), rope(wk h), wv h))`` with
``h = norm1(x)``, then ``x += down(silu(gate h) * up h)`` with ``h =
norm2(x)``; a final norm and ``x @ unembed^T``. The norm is LayerNorm
(scale and bias) or RMSNorm, eps 1e-5, over fp32; RoPE is half-split (not
interleaved), theta ``rope_theta``, on the whole head; attention is causal
with scale 1/sqrt(head_dim), K/V head ``j`` serving query heads ``j G ..
j G + G - 1``.

Departures from the program, each harmless to the comparison: everything
is fp32 (the program rounds matrix inputs to bf16 and keeps the residual
in bf16); sequences are right-padded into blocks (the layers are causal,
so padding never reaches a real position); K/V heads are not cached but
recomputed over the whole sequence.

``mm`` computes every dense projection of the layers (q, k, v, o, the
MLP), so a lower precision can be put in (the control); the embedding,
the norms, attention and the unembedding stay fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dims(m: dict):
    d, H = m["d_model"], m["n_heads"]
    hd = m.get("head_dim") or d // H
    return d, H, m["kv_heads"], hd, m["d_ff"], m["vocab"], m["n_layers"]


def _check(m: dict) -> None:
    for key in ("qkv_bias", "qk_norm", "tie_embeddings"):
        if m.get(key):
            raise ValueError(f"dense_gqa reference: {key} is not written")
    if m.get("attention", "gqa") != "gqa" or m.get("moe"):
        raise ValueError("dense_gqa reference: GQA and a dense MLP only")


def param_draws(m: dict) -> dict:
    """Each parameter's path (the port's dict layout, which is the JAX
    package's), shape, dtype ("param": the configuration's) and draw, as
    the JAX package initialises it: dense weights ``[d_in, d_out]``
    N(0, 1/d_in), embeddings N(0, 0.02^2), norm scales 1 and biases 0;
    the layers stacked on a leading axis."""
    _check(m)
    d, H, KVH, hd, ff, V, L = _dims(m)
    p = {}

    def dense(path, din, dout):
        p[path] = ((L, din, dout), "param", ("normal", 1.0 / math.sqrt(din)))

    dense("layers/attn/wq/w", d, H * hd)
    dense("layers/attn/wk/w", d, KVH * hd)
    dense("layers/attn/wv/w", d, KVH * hd)
    dense("layers/attn/wo/w", H * hd, d)
    for n in ("norm1", "norm2"):
        p[f"layers/{n}/scale"] = ((L, d), "param", ("const", 1.0))
        if m["norm"] == "layernorm":
            p[f"layers/{n}/bias"] = ((L, d), "param", ("const", 0.0))
    dense("layers/mlp/up/w", d, ff)
    dense("layers/mlp/down/w", ff, d)
    if m.get("glu", True):
        dense("layers/mlp/gate/w", d, ff)
    p["embed"] = ((V, d), "param", ("normal", 0.02))
    p["unembed"] = ((V, d), "param", ("normal", 0.02))
    p["final_norm/scale"] = ((d,), "param", ("const", 1.0))
    if m["norm"] == "layernorm":
        p["final_norm/bias"] = ((d,), "param", ("const", 0.0))
    return p


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def norm(x, p: dict, kind: str, eps: float = 1e-5):
    if kind == "rmsnorm":
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    else:
        mu = x.mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True)
                                   + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y


def rope(x, theta: float):
    """x [T, n, D] at positions 0..T-1, half-split."""
    T, _, D = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v):
    """q [T,H,D], k/v [T,KVH,D] -> [T, H*D], causal, scale 1/sqrt(D)."""
    T, H, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(T, KVH, H // KVH, D)
    s = torch.einsum("tkgd,skd->kgts", qg, k) / math.sqrt(D)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("kgts,skd->tkgd", p, v).reshape(T, H * D)


def attention_block(p: dict, h, lens, m: dict, mm):
    """Self-attention of each sequence of the block ``h`` [b, T, d] over
    its own ``lens[i]`` positions; the wo projection of all of them."""
    d, H, KVH, hd = _dims(m)[:4]
    theta = float(m.get("rope_theta", 10_000.0))
    b, T, _ = h.shape
    q = mm(h, p["wq"]["w"]).reshape(b, T, H, hd)
    k = mm(h, p["wk"]["w"]).reshape(b, T, KVH, hd)
    v = mm(h, p["wv"]["w"]).reshape(b, T, KVH, hd)
    o = torch.zeros(b, T, H * hd, dtype=h.dtype, device=h.device)
    for i, n in enumerate(lens):
        o[i, :n] = causal_attention(rope(q[i, :n], theta),
                                    rope(k[i, :n], theta), v[i, :n])
    return mm(o, p["wo"]["w"])


def mlp_block(p: dict, h, m: dict, mm):
    up = mm(h, p["up"]["w"])
    if m.get("glu", True):
        act = F.silu if m.get("act", "silu") == "silu" \
            else (lambda z: F.gelu(z, approximate="tanh"))
        up = act(mm(h, p["gate"]["w"])) * up
    return mm(up, p["down"]["w"])


def layer_f32(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, in fp32."""
    return {k: layer_f32(v, i) if isinstance(v, dict) else v[i].float()
            for k, v in tree.items()}


def blocks(seqs: list, budget: int) -> list:
    """Indices of ``seqs`` in groups of at most ``budget`` padded tokens
    (a longer sequence alone)."""
    out, cur, longest = [], [], 0
    for i, s in enumerate(seqs):
        if cur and max(longest, len(s)) * (len(cur) + 1) > budget:
            out.append(cur)
            cur, longest = [], 0
        cur.append(i)
        longest = max(longest, len(s))
    if cur:
        out.append(cur)
    return out


def embed_blocks(params, seqs: list, groups: list):
    """Each group's right-padded fp32 embeddings [b, T, d] and lengths."""
    out = []
    for g in groups:
        T = max(len(seqs[i]) for i in g)
        ids = torch.zeros(len(g), T, dtype=torch.long,
                          device=params["embed"].device)
        for j, i in enumerate(g):
            ids[j, :len(seqs[i])] = seqs[i]
        out.append((params["embed"][ids].float(), [len(seqs[i]) for i in g]))
    return out


def unembed_rows(params, x_rows, m: dict, chunk: int = 16384):
    """fp32 logits [n, V] of the final-normed rows ``x_rows`` [n, d]; the
    table is widened ``chunk`` rows at a time."""
    w = params["unembed"]
    return torch.cat([x_rows @ w[i:i + chunk].float().T
                      for i in range(0, w.shape[0], chunk)], dim=1)


def logits(params: dict, m: dict, seqs: list, rows: list, mm=plain_mm,
           budget: int = 16384) -> list:
    """fp32 logits [len(rows[i]), V] at positions ``rows[i]`` of each token
    sequence ``seqs[i]`` (1-D int64 tensors on the weights' device), the
    layers run one at a time over blocks of at most ``budget`` padded
    tokens."""
    _check(m)
    with no_tf32():
        groups = blocks(seqs, budget)
        xs = embed_blocks(params, seqs, groups)
        for li in range(m["n_layers"]):
            p = layer_f32(params["layers"], li)
            for j, (x, lens) in enumerate(xs):
                x = x + attention_block(p["attn"], norm(x, p["norm1"],
                                                        m["norm"]),
                                        lens, m, mm)
                x = x + mlp_block(p["mlp"], norm(x, p["norm2"], m["norm"]),
                                  m, mm)
                xs[j] = (x, lens)
        return final_logits(params, m, xs, groups, rows)


def final_logits(params, m: dict, xs: list, groups: list, rows: list):
    out = [None] * len(rows)
    for (x, _), g in zip(xs, groups):
        for j, i in enumerate(g):
            h = norm(x[j, rows[i]], params["final_norm"], m["norm"])
            out[i] = unembed_rows(params, h, m)
    return out


class no_tf32:
    """fp32 products in full fp32 (no TF32) inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
