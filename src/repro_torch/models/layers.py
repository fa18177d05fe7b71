"""Shared layers: norms, RoPE, dense/GLU MLPs, plain attention, embeddings.

Port of ``repro.models.layers``. Everything is a plain function over dict
params (dense weights ``[d_in, d_out]``); stacked layer params carry a
leading layer axis. The ``init_*`` functions give parameter specs
(``Draw``s), which ``materialize`` allocates and fills. ``compute_dtype`` casting happens at matmul inputs;
norms, softmax and logits run in fp32.

On a mesh with a ``model`` axis (``models.tp``) the dense forms are
split by the caller: a column-parallel ``dense`` or ``mlp`` takes this
rank's columns of ``up``/``gate`` and its rows of ``down`` and gives
partial sums, which the caller sums over the axis. The vocabulary-parallel
forms are here: ``vocab_embed`` (this rank's rows of the table, the other
ids masked; the caller sums), ``vocab_ce_sum`` (the cross-entropy over the
vocabulary shards: the max and the sum of exp reduced over the axis, the
target's logit from the rank that holds it) and ``vocab_logits`` (the
shards' logits gathered into full rows).

``chunked_attention`` has no counterpart here: on the port's path the
``flash_attention`` kernel (``repro_torch.kernels``) and its plain version
take its place. ``full_attention`` and ``decode_attention`` stay as the
plain forms of attention in the model's ``[B, S, H, D]`` layout.
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.dist.collectives import all_gather, pmax, psum

# ---------------------------------------------------------------- dtypes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# ----------------------------------------------------------------- remat
#
# The reference's remat policies (``repro.models.transformer.
# REMAT_POLICIES``) as ``torch.utils.checkpoint`` (non-reentrant):
# "none" saves every activation; "full" (``nothing_saveable``) saves a
# block's inputs only and runs its forward again in the backward; "dots"
# (``checkpoint_dots``, which saves the results of ``dot_general``s) saves
# the results of the matrix products (``mm``, ``bmm``, ``addmm``,
# ``baddbmm``: einsums and ``@`` land on them) and of ``flash_attention``,
# the port's counterpart of the reference's attention einsums, through
# selective checkpointing, and recomputes the rest (norms, activations,
# softmax, casts).

_DOTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
         "repro_torch::flash_attention"}


def _save_dots(ctx, func, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if func.name().split(".")[0]
            in _DOTS else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_fn(fn: Callable, remat: str) -> Callable:
    """``fn`` under the remat policy ``remat``: "none", "dots" or "full"."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {remat!r}: one of none, dots, full")


# ---------------------------------------------------------------- init
#
# The init functions below return trees of ``Draw``s: what each parameter
# is, not its values. ``materialize`` then allocates every tensor once, in
# its final dtype, and fills it in place from the generator. At full width
# this keeps the peak at the parameters' own size: no stack of per-layer
# copies and no second fp32 copy of a weight (one deepseek-v3 expert
# tensor is 15 GB in fp32).

@dataclass(frozen=True)
class Draw:
    """One parameter: ``shape``, and N(0, std^2) drawn in fp32 and rounded
    to the parameter's dtype, or the constant ``value`` where ``std`` is
    None. A draw of more than two dims is made one trailing matrix at a
    time (an expert's at a time), so the fp32 draw holds one matrix.

    Two more draws, for Mamba2's and RWKV6's per-head parameters:
    ``uniform=(lo, hi)`` draws U(lo, hi) in fp32, ``linspace=(lo, hi)``
    takes ``torch.linspace(lo, hi, n)`` over all n elements in row-major
    order (a ``[H, hs]`` linspace is one of H * hs values, reshaped);
    either then goes through ``then`` (the reference's transform, fp32 to
    fp32) before it is stored.
    ``dtype`` is the parameter's own dtype, None for the tree's."""
    shape: Tuple[int, ...]
    std: Optional[float] = None
    value: float = 0.0
    dtype: Optional[torch.dtype] = None
    uniform: Optional[Tuple[float, float]] = None
    linspace: Optional[Tuple[float, float]] = None
    then: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _draws(tree, path=()):
    """(path, Draw) of every leaf, in the tree's insertion order."""
    if isinstance(tree, Draw):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _draws(v, path + (k,))


def _fill(t: torch.Tensor, d: Draw, gen) -> None:
    if t.device.type == "meta":
        return
    if d.uniform is not None or d.linspace is not None:
        f32 = dict(dtype=torch.float32, device=t.device)
        if d.uniform is not None:
            lo, hi = d.uniform
            v = torch.rand(d.shape, generator=gen, **f32) * (hi - lo) + lo
        else:
            v = torch.linspace(*d.linspace, t.numel(), **f32).reshape(
                d.shape)
        t.copy_(d.then(v) if d.then is not None else v)
        return
    if d.std is None:
        t.fill_(d.value)
        return
    for idx in itertools.product(*map(range, d.shape[:-2])):
        dst = t[idx]
        dst.copy_(torch.randn(dst.shape, generator=gen, dtype=torch.float32,
                              device=t.device).mul_(d.std))


def materialize(spec, gen, dtype, device, layers: int = 0):
    """Tensors for a tree of ``Draw``s, in ``dtype`` (or a ``Draw``'s own)
    on ``device``, filled in tree order from ``gen`` (on ``device``; None on
    the meta device, where nothing is allocated or drawn). With
    ``layers`` = L every leaf is ``[L, *shape]``, filled a layer at a
    time: all of layer 0, then layer 1, ..."""
    leaves = list(_draws(spec))
    out = [torch.empty(((layers,) if layers else ()) + tuple(d.shape),
                       dtype=d.dtype or dtype, device=device)
           for _, d in leaves]
    for i in range(max(layers, 1)):
        for t, (_, d) in zip(out, leaves):
            _fill(t[i] if layers else t, d, gen)
    tree: dict = {}
    for t, (path, _) in zip(out, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


# ----------------------------------------------------------------- norms

def init_norm(d: int, norm: str) -> dict:
    p = {"scale": Draw((d,), value=1.0)}
    if norm == "layernorm":
        p["bias"] = Draw((d,))
    return p


def apply_norm(p: dict, x: torch.Tensor, norm: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding.

    x: [B, S, H, D]; positions: [B, S] or [S].
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [D/2]
    ang = positions[..., None].float() * freqs               # [B, S, D/2]
    cos = torch.cos(ang)[..., None, :]                        # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- MLP / GLU

def init_dense(d_in: int, d_out: int, bias: bool = False) -> dict:
    p = {"w": Draw((d_in, d_out), std=1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = Draw((d_out,))
    return p


def dense(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# "gelu" is the tanh form, as the reference's ``jax.nn.gelu``; "gelu_exact"
# the erf form (the published Zamba2's MLP)
ACTS = {"silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu}


def init_mlp(d: int, d_ff: int, glu: bool) -> dict:
    p = {"up": init_dense(d, d_ff), "down": init_dense(d_ff, d)}
    if glu:
        p["gate"] = init_dense(d, d_ff)
    return p


def mlp(p: dict, x: torch.Tensor, act: str, glu: bool,
        compute_dtype) -> torch.Tensor:
    """The MLP; on ``up``/``gate`` columns and the matching ``down`` rows
    of a tensor-parallel split, this rank's partial sums of it."""
    h = dense(p["up"], x, compute_dtype)
    if glu:
        h = ACTS[act](dense(p["gate"], x, compute_dtype)) * h
    else:
        h = ACTS[act](h)
    return dense(p["down"], h, compute_dtype)


# ------------------------------------------------------- plain attention

NEG_INF = -1e30


def _gqa_scores(q, k, compute_dtype):
    """q [B,Sq,KVH,G,D] x k [B,Skv,KVH,D] -> [B,KVH,G,Sq,Skv] fp32.

    Inputs are rounded to ``compute_dtype`` and multiplied in fp32, as
    the reference's ``preferred_element_type=float32`` does."""
    return torch.einsum("bskgd,btkd->bkgst", q.to(compute_dtype).float(),
                        k.to(compute_dtype).float())


def _gqa_readout(p, v, compute_dtype):
    """p [B,KVH,G,Sq,Skv] x v [B,Skv,KVH,D] -> [B,Sq,KVH,G,D] fp32."""
    return torch.einsum("bkgst,btkd->bskgd", p.to(compute_dtype).float(),
                        v.to(compute_dtype).float())


def full_attention(q, k, v, *, causal: bool,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Unchunked attention. q [B,Sq,H,D], k/v [B,Skv,KVH,D*] -> [B,Sq,H,Dv]."""
    B, Sq, H, Dq = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = _gqa_scores(q.reshape(B, Sq, KVH, G, Dq), k, compute_dtype) * scale
    if causal:
        if q_positions is None:
            q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
        if kv_positions is None:
            kv_positions = torch.arange(Skv, device=q.device).expand(B, Skv)
        mask = (q_positions[:, None, None, :, None]
                >= kv_positions[:, None, None, None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _gqa_readout(p, v, compute_dtype)
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: [B, 1, H, D]; k/v_cache: [B, Smax, KVH, D*]; lengths: [B] valid
    length (the new token's position is lengths-1 after cache insert).
    """
    B, _, H, Dq = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = _gqa_scores(q.reshape(B, 1, KVH, G, Dq), k_cache, compute_dtype) * scale
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _gqa_readout(p, v_cache, compute_dtype)
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# ------------------------------------------------------------- embeddings


def token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each position's cross-entropy, logsumexp(logits) - logits[target]:
    logits [..., V] fp32, targets [...] integer ids -> [...]."""
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _vocab_rows(w: torch.Tensor, ids: torch.Tensor, rank: int):
    """(each id's row index in this rank's block ``w`` of the vocabulary,
    clamped into it; whether the block holds the id)."""
    n = w.shape[0]
    local = ids.long() - rank * n
    own = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), own


def vocab_embed(w: torch.Tensor, ids: torch.Tensor, rank: int,
                compute_dtype) -> torch.Tensor:
    """This rank's share of the embedding of ``ids``: the rows its block
    ``w`` of the table holds, zeros for the other ids; the sum over the
    vocabulary's shards is the lookup."""
    local, own = _vocab_rows(w, ids, rank)
    rows = torch.where(own[..., None], w[local], 0)
    return rows.to(compute_dtype)


def vocab_ce_sum(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                 compute_dtype, group, rank: int) -> torch.Tensor:
    """The summed cross-entropy of x [B,c,d] against ``targets`` with the
    unembedding split over ``group`` by vocabulary rows (``w``: this
    rank's block): its logits [B,c,V/n] in fp32, their max over the group
    (a shift without gradient), the sum of exp and the target's logit
    summed over the group in one all-reduce, logsumexp - logit."""
    logits = unembed(x, w, compute_dtype)
    m = pmax(logits.detach().amax(-1), group)
    local, own = _vocab_rows(w, targets, rank)
    gold = torch.where(own, logits.gather(-1, local[..., None])[..., 0], 0)
    se, gold = psum(torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                                 gold]), group)
    return (m + torch.log(se) - gold).sum()


def vocab_logits(x: torch.Tensor, w: torch.Tensor, compute_dtype,
                 group) -> torch.Tensor:
    """Full fp32 logits rows from this rank's block ``w`` of the
    unembedding: its columns, gathered over the vocabulary's shards."""
    logits = unembed(x, w, compute_dtype)
    return all_gather(logits, group, logits.dim() - 1)


def init_embedding(vocab: int, d: int) -> Draw:
    return Draw((vocab, d), std=0.02)


def unembed(x: torch.Tensor, emb_or_w: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    """x [B,S,d] @ W [V,d]^T -> fp32 logits.

    The operands are rounded to ``compute_dtype`` and multiplied with fp32
    accumulation into fp32 logits, as the reference's
    ``preferred_element_type=float32`` does. On the card a narrow compute
    dtype goes straight to an fp32-output matmul (``out_dtype``), so the
    [V, d] table is read in its own width and never widened; the CPU has
    no such matmul and widens both operands, which gives the same sums.
    That matmul has no derivative of its own: ``_Fp32Logits`` gives it one
    (without grad it runs only its forward, the same single product).
    """
    xc, wc = x.to(compute_dtype), emb_or_w.to(compute_dtype)
    if xc.dtype == torch.float32 or xc.device.type == "cpu":
        return xc.float() @ wc.float().T
    x2 = xc.reshape(-1, xc.shape[-1])
    y = _Fp32Logits.apply(x2, wc)
    return y.reshape(*xc.shape[:-1], wc.shape[0])


class _Fp32Logits(torch.autograd.Function):
    """x [T,d] @ w [V,d]^T -> fp32 logits through the fp32-output matmul,
    which has no derivative of its own. The backward rounds the logits'
    gradient to the operands' dtype (as a product's backward in that dtype
    does) and takes both products with fp32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (torch.mm(g, w, out_dtype=torch.float32).to(x.dtype),
                torch.mm(g.T, x, out_dtype=torch.float32).to(w.dtype))
