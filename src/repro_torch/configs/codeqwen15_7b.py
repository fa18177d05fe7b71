"""codeqwen1.5-7b — dense, qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,           # qwen1.5 family uses QKV bias
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    norm="rmsnorm",
    attention="gqa",
)
