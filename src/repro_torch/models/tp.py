"""Tensor and sequence parallelism of the transformer family on a mesh.

Where the reference hands its layout to GSPMD (``lm_param_specs``: q/k/v,
up and gate split over ``model`` on their output dim, ``wo`` and ``down``
on their input dim, ``embed`` and ``unembed`` on the vocabulary; the
residual constrained to ``P(dp, model, None)`` under ``seq_parallel``),
the port computes that layout explicitly. :func:`plan` reads, from the
config and the mesh, which of those leaves the sanitized specs split in
whole units: whole query heads, whole K/V heads, whole FFN columns, whole
vocabulary rows. The forward takes those leaves as this rank's ``model``
shards; every other leaf it takes whole, gathered on use as before. One
such case: a spec that cuts a K/V head (starcoder2-15b's 4 K/V heads, or
grok-1-314b's 8, on a ``model`` axis of 16), where ``wk``/``wv`` come
whole and each rank computes the K/V heads its query heads read.

The regions. Every collective's backward is its transpose
(``dist.collectives``), and the sharded step sums what the ranks'
backwards give (each model rank's loss weighted by its share, a
replicated leaf's gradient summed over its replicas: ``train.loop``), so
a region needs no op of its own on the way in and one on the way out:

  * without sequence parallelism the residual is whole on every rank; a
    row-parallel product's partial sums leave through ``psum`` (an
    all-reduce, whose backward is the all-reduce);
  * under ``seq_parallel`` the residual between blocks is this rank's
    block of the sequence: a block enters through the sequence all-gather
    (backward: the reduce-scatter) and a row-parallel exit is the
    reduce-scatter over the sequence (backward: the all-gather); a part
    computed whole on every rank (a MoE FFN, attention that is not split)
    leaves as this rank's block of its output.

The other families. The hybrid (zamba2) rests its parameters pure FSDP,
so its plan splits nothing: it carries the ``model`` group, size and rank
for the shared block's sequence-sharded cache. The encoder-decoder
(whisper) rests every large dense kernel ``[.., d_in, d_out]`` split over
``model`` on ``d_out``; its plan names those leaves (``cols``) and says
whether the splits of ``wq``/``wk``/``wv`` fall on whole heads
(``heads``) and those of the MLP on ``up`` and ``down`` (``ffn``). Its
forward takes each split leaf as this rank's columns and gathers the
activations instead (``models.encdec``). RWKV6 runs pure DP: no plan.

With a ``model`` axis of 1 there is no plan: the forward is the single
device's, op for op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, FrozenSet, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_gather, psum, reduce_scatter
from repro_torch.dist.context import DistContext
from repro_torch.dist.sharding import axis_index, cuts_units, split_ways


@dataclass(frozen=True)
class TPPlan:
    """Which parts of a transformer layer this rank computes on its
    ``model`` shards, and the shards' place.

    ``heads``: attention on query heads ``q_lo .. q_lo + n_q`` and K/V
    heads ``kv_lo .. kv_lo + n_kv``, with ``wo`` row-parallel;
    ``kv_split``: ``wk``/``wv`` arrive as shards of those K/V heads (else
    whole, and sliced). ``ffn``: the dense MLP on this rank's
    columns. ``vocab``: ``embed``/``unembed`` are this rank's rows of the
    vocabulary. ``seq``: the residual is sequence-parallel (the train
    forward, where the sequence divides the axis). ``cols``: the
    encoder-decoder's dense layers (paths such as ``dec_layers/self/wq``)
    whose output columns the sanitized spec splits over the axis."""
    group: object
    size: int
    rank: int
    heads: bool
    kv_split: bool
    q_lo: int
    n_q: int
    kv_lo: int
    n_kv: int
    ffn: bool
    vocab: bool
    seq: bool
    cols: FrozenSet[str] = frozenset()

    @property
    def splits(self) -> bool:
        """Whether any leaf is computed as this rank's shard: the ranks
        of the axis then compute distinct work."""
        return self.heads or self.ffn or self.vocab or bool(self.cols)

    # ------------------------------------------------------------ regions

    def exit(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        """The sum of this rank's partial ``y`` [B,S,d] over the axis: the
        whole sum, or under ``seq`` this rank's block of the sequence."""
        if seq:
            return reduce_scatter(y, self.group, 1)
        return psum(y, self.group)

    def enter(self, h: torch.Tensor, seq: bool) -> torch.Tensor:
        """The whole sequence from this rank's block under ``seq``."""
        return all_gather(h, self.group, 1) if seq else h

    def block(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        """This rank's block of the sequence of ``y``, the same on every
        rank, under ``seq``."""
        if not seq:
            return y
        n = y.shape[1] // self.size
        return y.narrow(1, self.rank * n, n)


@dataclass(frozen=True)
class OnUse:
    """What the sharded steps tell a transformer about what they hand it:
    ``layer(p_l, stack)`` turns one layer's parameters of the stack
    ``stack`` (``layers``, or the encoder-decoder's ``enc_layers`` and
    ``dec_layers``) as they rest into what its forward takes (the
    per-layer gather), and ``cache_seq`` says that the attention caches
    rest sharded over ``model`` on their sequence."""
    layer: Callable = lambda p_l, stack="layers": p_l
    cache_seq: bool = False


def _split(cfg: ArchConfig, dist: DistContext):
    """(heads, kv_split, ffn, vocab): which parts the sanitized specs split
    over ``model`` in whole units (``TPPlan``'s flags); None without a
    ``model`` axis of more than one rank."""
    if not dist.active or dist.model_size == 1:
        return None
    mesh, m, M = dist.mesh, dist.model_axis, dist.model_size
    H = cfg.n_heads

    def whole(n_units, unit):       # split, and in whole units
        return split_ways(n_units * unit, m, mesh) == M and not cuts_units(
            n_units, unit, m, mesh)
    if cfg.attention == "mla":
        mla = cfg.mla
        heads = kv_split = all(whole(H, w) for w in (
            mla.nope_head_dim + mla.rope_head_dim,
            mla.nope_head_dim + mla.v_head_dim, mla.v_head_dim))
    else:
        hd, KVH = cfg.resolved_head_dim, cfg.kv_heads
        kv_split = whole(KVH, hd)
        # whole query heads, and each rank's heads within whole K/V heads
        heads = whole(H, hd) and (kv_split or (H // KVH) % (H // M) == 0)
        kv_split = kv_split and heads
    ffn = cfg.moe is None and split_ways(cfg.d_ff, m, mesh) == M
    return heads, kv_split, ffn, split_ways(cfg.vocab, m, mesh) == M


# the encoder-decoder's attention blocks and MLPs (layer stack/block)
ENCDEC_ATTN = ("enc_layers/attn", "dec_layers/self", "dec_layers/cross")
ENCDEC_MLP = ("enc_layers/mlp", "dec_layers/mlp")


def _encdec_plan(cfg: ArchConfig, dist: DistContext, base: dict,
                 cols: Optional[FrozenSet[str]]) -> TPPlan:
    if cols is None:
        raise ValueError("the encoder-decoder's plan reads which dense "
                         "layers its sanitized specs split: pass cols")
    m, M, mesh = dist.model_axis, dist.model_size, dist.mesh
    hd, H, KVH = cfg.resolved_head_dim, cfg.n_heads, cfg.kv_heads
    heads = all(f"{b}/{w}" in cols for b in ENCDEC_ATTN
                for w in ("wq", "wk", "wv")) and not (
        cuts_units(H, hd, m, mesh) or cuts_units(KVH, hd, m, mesh))
    ffn = all(f"{b}/{w}" in cols for b in ENCDEC_MLP
              for w in ("up", "down") + (("gate",) if cfg.glu else ()))
    n_q, n_kv = (H // M, KVH // M) if heads else (H, KVH)
    r = base["rank"] if heads else 0
    return TPPlan(**base, heads=heads, kv_split=heads, q_lo=r * n_q,
                  n_q=n_q, kv_lo=r * n_kv, n_kv=n_kv, ffn=ffn, vocab=False,
                  seq=False, cols=cols)


def plan(cfg: ArchConfig, dist: DistContext,
         cols: Optional[FrozenSet[str]] = None) -> Optional[TPPlan]:
    """The plan of ``cfg`` on ``dist``'s mesh for this rank; None without a
    ``model`` axis of more than one rank, and for RWKV6 (pure DP). The
    encoder-decoder's takes ``cols``, its dense layers whose sanitized
    spec splits the output dim over ``model`` (``Model.plan`` passes
    them)."""
    if not dist.active or dist.model_size == 1 or cfg.family == "ssm":
        return None
    mesh, m = dist.mesh, dist.model_axis
    base = dict(group=mesh.group(m), size=dist.model_size,
                rank=axis_index(mesh, m))
    if cfg.family == "hybrid":       # pure FSDP: nothing split
        return TPPlan(**base, heads=False, kv_split=False, q_lo=0,
                      n_q=cfg.n_heads, kv_lo=0, n_kv=cfg.kv_heads, ffn=False,
                      vocab=False, seq=False)
    if cfg.family == "audio":
        return _encdec_plan(cfg, dist, base, cols)
    split = _split(cfg, dist)
    if split is None:
        return None
    heads, kv_split, ffn, vocab = split
    M, rank = dist.model_size, base["rank"]
    H = cfg.n_heads
    KVH = H if cfg.attention == "mla" else cfg.kv_heads
    G = H // KVH
    n_q = H // M if heads else H
    q_lo = rank * n_q if heads else 0
    if heads and kv_split:
        n_kv = KVH // M
        kv_lo = rank * n_kv
    elif heads:
        n_kv, kv_lo = 1, q_lo // G
    else:
        n_kv, kv_lo = KVH, 0
    return TPPlan(**base, heads=heads, kv_split=kv_split, q_lo=q_lo,
                  n_q=n_q, kv_lo=kv_lo, n_kv=n_kv, ffn=ffn, vocab=vocab,
                  seq=dist.seq_parallel)


def local_leaves(cfg: ArchConfig, dist: DistContext) -> Tuple[str, ...]:
    """The leaves the forward takes as this rank's ``model`` shards on
    ``dist``'s mesh (the MoE's experts aside)."""
    split = _split(cfg, dist)
    if split is None:
        return ()
    heads, kv_split, ffn, vocab = split
    out = []
    if heads:
        if cfg.attention == "mla":
            out += ["attn/wq_b/w", "attn/wkv_b/w", "attn/wo/w"]
        else:
            out += ["attn/wq/w", "attn/wo/w"]
            kv = ["attn/wk/w", "attn/wv/w"] if kv_split else []
            out += kv
            if cfg.qkv_bias:
                out += ["attn/wq/b"] + [k[:-1] + "b" for k in kv]
    if ffn:
        out += [f"mlp/{k}/w" for k in ("up", "down", "gate")
                if k != "gate" or cfg.glu]
    layers = tuple("layers/" + k for k in out)
    if vocab:
        layers += ("embed",) if cfg.tie_embeddings else ("embed", "unembed")
    return layers
