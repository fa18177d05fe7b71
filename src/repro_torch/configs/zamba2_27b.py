"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54 Mamba2 layers with a single weight-tied (shared) attention+MLP block
applied every 6 backbone layers (9 application points).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, HybridConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    d_ff=10240,
    vocab=32000,
    act="silu",
    glu=True,
    norm="rmsnorm",
    attention="gqa",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_kernel=4, chunk=128),
    hybrid=HybridConfig(shared_attn_every=6),
    notes="Mamba2 + shared attn blocks; sub-quadratic (runs long_500k)",
)
