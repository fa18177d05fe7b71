"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356; unverified].

The conv/mel frontend is STUBBED: ``input_specs`` supplies precomputed
frame embeddings (B, 1500, d_model). Positional scheme: the published
model uses absolute positions bounded at 448 decoder tokens; the assigned
shapes require 32k-token decode, so the backbone uses RoPE instead
(documented deviation — backbone-only reproduction).
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,             # decoder layers
    d_model=1280,
    n_heads=20,
    kv_heads=20,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    glu=False,
    norm="layernorm",
    attention="gqa",
    enc_dec=EncDecConfig(n_encoder_layers=32, n_frames=1500),
)
