"""starcoder2-15b — dense GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    kv_heads=4,
    d_ff=24576,
    vocab=49152,
    qkv_bias=True,           # starcoder2 uses bias
    act="gelu",
    glu=False,               # plain MLP (c_fc -> gelu -> c_proj)
    norm="layernorm",
    attention="gqa",
)
