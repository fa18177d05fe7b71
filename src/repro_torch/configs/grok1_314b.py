"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=32768,
    vocab=131072,
    act="gelu",
    glu=True,                # GeGLU-style gated experts
    norm="rmsnorm",
    attention="gqa",
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff=32768),
    notes="8 experts; EP degree 16 uses 2x expert replication",
)
