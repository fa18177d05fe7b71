"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818; unverified].

Early fusion: VQ image tokens share the text token stream; the VQ-VAE
image tokenizer is the modality frontend and is STUBBED — ``input_specs``
supplies token ids drawn from the unified 65536-entry vocabulary.
Backbone = dense GQA transformer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,            # chameleon stabilizes with QK-norm
    act="silu",
    glu=True,
    norm="rmsnorm",
    attention="gqa",
    notes="early-fusion, VQ image tokens in-stream (frontend stubbed)",
)
