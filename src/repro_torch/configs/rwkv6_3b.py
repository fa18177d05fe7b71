"""rwkv6-3b (Finch) — attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,               # attention-free
    kv_heads=0,
    d_ff=8960,
    vocab=65536,
    act="silu",
    glu=False,
    norm="layernorm",
    attention="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, chunk=128),
    notes="constant-size state; runs long_500k",
)
