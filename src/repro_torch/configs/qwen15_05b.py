"""qwen1.5-0.5b — dense [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    act="silu",
    glu=True,
    norm="rmsnorm",
    attention="gqa",
    tie_embeddings=True,
)
