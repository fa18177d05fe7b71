"""Plain fp32 reference of the published Zamba2 hybrid (family ``hybrid``,
``HybridConfig.layer_ids`` given).

A transcription of Zyphra's Zamba2 as ``transformers`` 4.57's
``models/zamba2/modeling_zamba2.py`` computes it (``Zamba2MambaMixer``'s
CUDA path, ``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``,
``Zamba2HybridLayer``), in plain PyTorch. It imports nothing of the port
nor of the JAX package and takes nothing the program made: it is handed
the weights the benchmark made, in the port's parameter layout, and the
token ids, and computes its logits itself.

With ``e`` the embedding and k counting the hybrid layers (``layer_ids``)
from 0, a Mamba layer i is ``x += Mamba2(norm_i(x))`` and a hybrid layer i

    a = RMSNorm_2d([x; e]);  o = W_o attn(W_q a, W_k a, W_v a)
    [g; u] = W_gu RMSNorm_d(o) + B_k A_k RMSNorm_d(o);  f = W_down(gelu(g) u)
    x += Mamba2(norm_i(x + L_k f))

with block ``k mod n_blocks`` giving W_q .. W_down and both norms, and
``A_k``, ``B_k``, ``L_k`` application k's own. Attention is causal, without
RoPE, its scores scaled by ``score_scale(head_dim)``, (head_dim / 2)^-1/2
as published. Mamba2: ``in_proj`` to ``[z, xBC, dt]``, a depthwise causal conv
with bias and SiLU over ``xBC``, ``dt = softplus(dt + dt_bias)``, ``A =
-exp(A_log)``, the SSD, plus ``D x``, then ``RMSNorm(y * silu(z))`` (eps
``ssm.norm_eps``) and ``out_proj``. Every RMSNorm but that one has eps 1e-5.
The logits are ``final_norm(x) @ embed^T`` (tied embeddings).

The SSD is taken in its quadratic form over the whole sequence, with no
chunks and no carried state:

    y_i = sum_{j <= i} L[i, j] (C_i . B_j) dt_j x_j + D x_i,
    L[i, j] = exp(sum_{j < t <= i} dt_t A)

so it is independent of the program's chunked scan.

Departures from the published model, each harmless to the comparison:

* everything is fp32 (the program rounds matrix inputs to bf16 and keeps
  the residual in bf16);
* dt is not clamped below: ``transformers``' plain PyTorch path clamps
  ``softplus(dt + dt_bias)`` at ``time_step_min`` (1e-3), while the
  published CUDA path's ``dt_limit`` is (0, inf), which is followed here;
* sequences are right-padded into blocks (every layer is causal, so
  padding never reaches a real position); no cache: K/V and the SSD are
  recomputed over the whole sequence.

``mm`` computes every dense projection of the layers (``in_proj``,
``out_proj``, q, k, v, o, the MLP and its adapter, ``L_k``), so a lower
precision can be put in (the control); the embedding, the conv, the SSD,
the norms, attention and the unembedding stay fp32.

Without ``layer_ids`` the file computes the JAX package's block instead
(``src/repro/models/hybrid.py``), which the benchmark's CPU tests serve
when they cut every configuration to the port's reduced registry entry:
after every ``shared_attn_every`` Mamba layers one shared block adds
``wo attn(rope(q), rope(k), v)`` of ``norm1(x)`` and a SiLU-gated MLP of
``norm2(x)`` to x, scores scaled by 1/sqrt(head_dim), and the logits read
an ``unembed`` of their own; its gated norm's eps is 1e-6.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dense_gqa import (
    attention_block, blocks, embed_blocks, layer_f32, mlp_block, no_tf32,
    plain_mm,
)

EPS = 1e-5


def published(m: dict) -> bool:
    return bool(m["hybrid"].get("layer_ids"))


def _check(m: dict) -> None:
    if m.get("family") != "hybrid" or m.get("norm") != "rmsnorm" \
            or not m.get("glu", True):
        raise ValueError("zamba2_hybrid reference: the hybrid family with "
                         "RMSNorm and a gated MLP only")
    if published(m) and not m.get("tie_embeddings"):
        raise ValueError("zamba2_hybrid reference: the published block "
                         "with tied embeddings only")


def _ssm_dims(m: dict):
    """(d_in, Mamba heads, head dim P, state N, groups G, conv channels)."""
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    gn = s.get("n_groups", 1) * s["d_state"]
    return (d_in, d_in // s["head_dim"], s["head_dim"], s["d_state"],
            s.get("n_groups", 1), d_in + 2 * gn)


def param_draws(m: dict) -> dict:
    """Each parameter's path (the port's layout: ``layers`` stacked on the
    backbone's layers, ``blocks`` on the shared blocks, ``apps`` on the
    hybrid layers), shape, dtype ("param": the configuration's) and draw,
    as the port initialises them: dense weights ``[d_in, d_out]``
    N(0, 1/d_in), the conv N(0, 0.2^2) with bias 0, ``dt_bias`` for a dt
    uniform in log space over [1e-3, 1e-1], ``A_log`` = log(1 .. heads)
    (``transformers``' init), D and norm scales 1, the embedding
    N(0, 0.02^2)."""
    _check(m)
    d, ff, V, L = m["d_model"], m["d_ff"], m["vocab"], m["n_layers"]
    H, KVH = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or d // H
    h = m["hybrid"]
    nb, na = h.get("n_blocks", 1), len(h.get("layer_ids", ()))
    r = h.get("adapter_rank", 0)
    d_in, nh, _, N, G, conv_ch = _ssm_dims(m)
    K = m["ssm"]["conv_kernel"]
    p = {}

    def dense(path, n, din, dout):
        p[path] = ((n, din, dout), "param", ("normal", 1.0 / math.sqrt(din)))

    dense("layers/m/in_proj", L, d, 2 * d_in + 2 * G * N + nh)
    p["layers/m/conv_w"] = ((L, K, conv_ch), "param", ("normal", 0.2))
    p["layers/m/conv_b"] = ((L, conv_ch), "param", ("const", 0.0))
    p["layers/m/dt_bias"] = ((L, nh), "float32",
                             ("dt_bias", math.log(1e-3), math.log(1e-1)))
    p["layers/m/A_log"] = ((L, nh), "float32", ("log_linspace", 1.0,
                                                float(nh)))
    p["layers/m/D"] = ((L, nh), "float32", ("const", 1.0))
    p["layers/m/out_norm"] = ((L, d_in), "param", ("const", 1.0))
    dense("layers/m/out_proj", L, d_in, d)
    p["layers/norm/scale"] = ((L, d), "param", ("const", 1.0))
    p["embed"] = ((V, d), "param", ("normal", 0.02))
    p["final_norm/scale"] = ((d,), "param", ("const", 1.0))
    if not published(m):
        for n, dout in (("wq", H * hd), ("wk", KVH * hd), ("wv", KVH * hd)):
            p[f"shared/attn/{n}/w"] = ((d, dout), "param",
                                       ("normal", 1.0 / math.sqrt(d)))
        p["shared/attn/wo/w"] = ((H * hd, d), "param",
                                 ("normal", 1.0 / math.sqrt(H * hd)))
        for n, din, dout in (("up", d, ff), ("gate", d, ff), ("down", ff, d)):
            p[f"shared/mlp/{n}/w"] = ((din, dout), "param",
                                      ("normal", 1.0 / math.sqrt(din)))
        for n in ("norm1", "norm2"):
            p[f"shared/{n}/scale"] = ((d,), "param", ("const", 1.0))
        p["unembed"] = ((V, d), "param", ("normal", 0.02))
        return p
    dense("blocks/attn/wq/w", nb, 2 * d, H * hd)
    dense("blocks/attn/wk/w", nb, 2 * d, KVH * hd)
    dense("blocks/attn/wv/w", nb, 2 * d, KVH * hd)
    dense("blocks/attn/wo/w", nb, H * hd, d)
    dense("blocks/mlp/gate_up/w", nb, d, 2 * ff)
    dense("blocks/mlp/down/w", nb, ff, d)
    p["blocks/norm1/scale"] = ((nb, 2 * d), "param", ("const", 1.0))
    p["blocks/norm2/scale"] = ((nb, d), "param", ("const", 1.0))
    dense("apps/linear/w", na, d, d)
    if r:
        dense("apps/adapter_a/w", na, d, r)
        dense("apps/adapter_b/w", na, r, 2 * ff)
    return p


def rmsnorm(x, scale, eps: float = EPS):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def causal_conv(u, w, b):
    """Depthwise causal conv of u [b, T, C] with w [K, C] and bias b, then
    SiLU: out[t] = sum_i w[i] u[t - K + 1 + i] (zeros before the start)."""
    K, T = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return F.silu(sum(pad[:, i:i + T] * w[i] for i in range(K)) + b)


def ssd(x, dt, A, B, C):
    """The SSD of one sequence in its quadratic form: x [T, nh, P], dt
    [T, nh] (after softplus), A [nh] (negative), B/C [T, G, N] -> y
    [T, nh, P], without the D term."""
    T, nh, _ = x.shape
    rep = nh // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)                  # [T, nh, N]
    Ch = C.repeat_interleave(rep, dim=1)
    cum = torch.cumsum(dt * A, dim=0)                     # [T, nh]
    seg = cum[:, None, :] - cum[None, :, :]               # [i, j, nh]
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    Lmat = seg.masked_fill(~below[:, :, None], -math.inf).exp()
    CB = torch.einsum("ihn,jhn->ijh", Ch, Bh)
    return torch.einsum("ijh,jhp->ihp", Lmat * CB, x * dt[..., None])


def mamba_block(p: dict, h, lens, m: dict, mm):
    """Mamba2 of the normed block ``h`` [b, T, d], each sequence over its
    own ``lens[i]`` positions."""
    d_in, nh, P, N, G, conv_ch = _ssm_dims(m)
    b, T, _ = h.shape
    zxd = mm(h, p["in_proj"])
    z, xbc, dt = torch.split(zxd, [d_in, conv_ch, nh], dim=-1)
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, B, C = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.zeros(b, T, nh, P, dtype=h.dtype, device=h.device)
    for i, n in enumerate(lens):
        xi = x[i, :n].reshape(n, nh, P)
        y[i, :n] = ssd(xi, dt[i, :n], A, B[i, :n].reshape(n, G, N),
                       C[i, :n].reshape(n, G, N)) \
            + p["D"][:, None] * xi
    y = y.reshape(b, T, d_in) * F.silu(z)
    y = rmsnorm(y, p["out_norm"], m["ssm"].get("norm_eps", 1e-6))
    return mm(y, p["out_proj"])


def block_input(x, e):
    """What the shared block's first norm reads: [x; e]."""
    return torch.cat([x, e], dim=-1)


def score_scale(hd: int) -> float:
    """The published block's score scale: (head_dim / 2)^-1/2."""
    return (hd / 2) ** -0.5


def causal_attention(q, k, v, scale: float):
    """q [T,H,D], k/v [T,KVH,D] -> [T, H*D], causal."""
    T, H, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(T, KVH, H // KVH, D)
    s = torch.einsum("tkgd,skd->kgts", qg, k) * scale
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    pr = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("kgts,skd->tkgd", pr, v).reshape(T, H * D)


def shared_block(blk: dict, app: dict, x, e, lens, m: dict, mm):
    """One application of the shared block: L_k f [b, T, d]."""
    H, KVH, hd = m["n_heads"], m["kv_heads"], m["head_dim"]
    scale = score_scale(hd)
    b, T, _ = x.shape
    a = rmsnorm(block_input(x, e), blk["norm1"]["scale"])
    at = blk["attn"]
    q = mm(a, at["wq"]["w"]).reshape(b, T, H, hd)
    k = mm(a, at["wk"]["w"]).reshape(b, T, KVH, hd)
    v = mm(a, at["wv"]["w"]).reshape(b, T, KVH, hd)
    o = torch.zeros(b, T, H * hd, dtype=x.dtype, device=x.device)
    for i, n in enumerate(lens):
        o[i, :n] = causal_attention(q[i, :n], k[i, :n], v[i, :n], scale)
    hm = rmsnorm(mm(o, at["wo"]["w"]), blk["norm2"]["scale"])
    gu = mm(hm, blk["mlp"]["gate_up"]["w"])
    if "adapter_a" in app:
        gu = gu + mm(mm(hm, app["adapter_a"]["w"]), app["adapter_b"]["w"])
    g, u = gu.chunk(2, dim=-1)
    f = mm(F.gelu(g) * u, blk["mlp"]["down"]["w"])
    return mm(f, app["linear"]["w"])


def logits(params: dict, m: dict, seqs: list, rows: list, mm=plain_mm,
           budget: int = 16384) -> list:
    """fp32 logits [len(rows[i]), V] at positions ``rows[i]`` of each token
    sequence ``seqs[i]`` (1-D int64 tensors on the weights' device), the
    layers run one at a time over blocks of at most ``budget`` padded
    tokens."""
    _check(m)
    h = m["hybrid"]
    app_of = {i: k for k, i in enumerate(h.get("layer_ids", ()))}
    every = h.get("shared_attn_every", 6)
    with no_tf32():
        groups = blocks(seqs, budget)
        es = embed_blocks(params, seqs, groups)
        xs = [x for x, _ in es]
        if not published(m):
            shared = _f32(params["shared"])
        for li in range(m["n_layers"]):
            p = layer_f32(params["layers"], li)
            k = app_of.get(li)
            if k is not None:
                blk = layer_f32(params["blocks"], k % h["n_blocks"])
                app = layer_f32(params["apps"], k)
            for j, (e, lens) in enumerate(es):
                x = xs[j]
                inp = x if k is None else \
                    x + shared_block(blk, app, x, e, lens, m, mm)
                x = x + mamba_block(p["m"], rmsnorm(
                    inp, p["norm"]["scale"]), lens, m, mm)
                if not published(m) and (li + 1) % every == 0:
                    x = x + attention_block(shared["attn"], rmsnorm(
                        x, shared["norm1"]["scale"]), lens, m, mm)
                    x = x + mlp_block(shared["mlp"], rmsnorm(
                        x, shared["norm2"]["scale"]), m, mm)
                xs[j] = x
        out = [None] * len(rows)
        table = params["unembed" if "unembed" in params else "embed"]
        for x, g in zip(xs, groups):
            for j, i in enumerate(g):
                hn = rmsnorm(x[j, rows[i]], params["final_norm"]["scale"])
                out[i] = torch.cat([hn @ table[c:c + 16384].float().T
                                    for c in range(0, table.shape[0],
                                                   16384)], dim=1)
        return out


def _f32(tree: dict) -> dict:
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}
