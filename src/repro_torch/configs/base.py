"""Architecture + shape configuration for the repro framework.

Every assigned architecture gets one module in this package exporting a
single ``CONFIG: ArchConfig`` with the exact published hyperparameters.
``reduced()`` derives a CPU-smoke-test-sized config of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # shared (always-on) experts
    d_ff: int = 0                  # per-expert hidden size (0 -> arch d_ff)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims (v3 defaults)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block dims."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64             # SSD head dim (P)
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128               # SSD chunk length
    # the gated output RMSNorm's epsilon (port only, left out of the repr,
    # which the registry's configs share with the reference's)
    norm_eps: float = field(default=1e-6, repr=False)


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    chunk: int = 32                # bounded by the decay recentering (rwkv6.py)


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 32
    n_frames: int = 1500           # post-conv audio frames (frontend stub)


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + shared (weight-tied) attention block.

    The defaults are the reference's block: one shared block after every
    ``shared_attn_every`` backbone layers, reading the residual stream and
    adding to it. ``layer_ids`` given selects the published Zamba2 block
    (``published``): before each listed backbone layer the shared block
    ``k mod n_blocks`` (k counting the applications) reads
    ``[x; embedding]``, scales its scores by (head_dim / 2)^-1/2, its MLP
    adds the application's own adapter of rank ``adapter_rank``, and its
    output enters that layer's input through the application's own linear
    map."""
    shared_attn_every: int = 6     # apply the shared block every N backbone layers
    # the published block's fields (port only, left out of the repr, which
    # the registry's configs share with the reference's)
    layer_ids: tuple = field(default=(), repr=False)    # the hybrid layers
    n_blocks: int = field(default=1, repr=False)        # alternating blocks
    adapter_rank: int = field(default=0, repr=False)    # MLP adapter's rank

    def __post_init__(self):
        object.__setattr__(self, "layer_ids", tuple(self.layer_ids))
        if not self.layer_ids and (self.n_blocks != 1 or self.adapter_rank):
            raise ValueError("HybridConfig: n_blocks and adapter_rank belong "
                             "to the published block, which layer_ids "
                             "selects")

    @property
    def published(self) -> bool:
        return bool(self.layer_ids)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    act: str = "silu"              # silu | gelu
    glu: bool = True               # gated MLP (SwiGLU/GeGLU) vs plain 2-layer MLP
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    attention: str = "gqa"         # gqa | mla | none
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    hybrid: Optional[HybridConfig] = None
    notes: str = ""
    # --- numerics / memory policy (overridable per run) ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention chunking for the pure-JAX flash path (0 = full attention)
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(1)-state or seq-sharded 500k decode."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb
        if self.attention == "mla":
            m = self.mla or MLAConfig()
            qk = m.nope_head_dim + m.rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        elif self.attention == "gqa":
            attn = d * (self.n_heads * hd) + 2 * d * (self.kv_heads * hd) \
                + (self.n_heads * hd) * d
        else:
            attn = 0
        if self.moe is not None:
            e_ff = self.moe.d_ff or ff
            per_expert = d * e_ff * (3 if self.glu else 2)
            mlp = (self.moe.n_experts + self.moe.n_shared) * per_expert \
                + d * self.moe.n_experts  # router
        else:
            mlp = d * ff * (3 if self.glu else 2)
        if self.family == "ssm" and self.rwkv is not None:
            r = self.rwkv
            d_attn = d
            # time-mix: r,k,v,g,o + decay/a LoRAs (approx Finch layout)
            tm = 5 * d * d_attn + 2 * d * r.decay_lora + r.decay_lora * d_attn
            cm = 2 * d * ff // 2 if False else d * ff + ff * d  # channel mix (k, v)
            n += self.n_layers * (tm + cm + 2 * d)
            return n
        if self.family in ("hybrid",) and self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_mamba = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                         + s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)
                         + nh + nh  # A_log, D
                         + d_in * d + d)
            shared = attn + d * ff * (3 if self.glu else 2)
            n_shared_apps = 1  # weight-tied single block
            n += self.n_layers * per_mamba + n_shared_apps * shared
            return n
        per_layer = attn + mlp + 2 * d  # 2 norms
        n_l = self.n_layers
        if self.enc_dec is not None:
            # encoder layers: self-attn + mlp; decoder: self + cross + mlp
            enc = self.enc_dec.n_encoder_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            n += enc + dec
            return n
        n += n_l * per_layer
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed only)."""
        if self.moe is None:
            return self.param_count()
        e_ff = self.moe.d_ff or self.d_ff
        per_expert = self.d_model * e_ff * (3 if self.glu else 2)
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert * self.n_layers
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2 if self.hybrid is None else 6,
            d_model=64,
            n_heads=4,
            kv_heads=min(self.kv_heads, 4) if self.kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
            attn_chunk_q=32,
            attn_chunk_kv=32,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, n_shared=self.moe.n_shared,
                                  d_ff=64, capacity_factor=2.0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
            kw["head_dim"] = 0
        if self.ssm is not None:
            kw["ssm"] = MoEConfig if False else SSMConfig(
                d_state=16, expand=2, head_dim=16, conv_kernel=4, chunk=16)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, chunk=16)
        if self.enc_dec is not None:
            kw["enc_dec"] = EncDecConfig(n_encoder_layers=2, n_frames=24)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(shared_attn_every=3)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
