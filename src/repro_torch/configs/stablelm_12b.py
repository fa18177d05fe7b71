"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-12b; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    d_ff=13824,
    vocab=100352,
    act="silu",
    glu=True,
    norm="layernorm",        # stablelm-2 uses LayerNorm (no bias)
    attention="gqa",
)
