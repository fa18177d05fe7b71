"""deepseek-v3-671b — MoE with MLA [arXiv:2412.19437; hf].

61 layers, MLA (q_lora 1536 / kv_lora 512 / rope 64 / nope 128 / v 128),
MoE: 1 shared + 256 routed experts, top-8, expert d_ff 2048.
MTP (multi-token prediction) is available as an optional extra head
(``models.transformer.mtp_head``) and is exercised by its own test.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    kv_heads=128,            # MLA: kv_heads == n_heads after decompression
    d_ff=2048,               # per-expert hidden (assignment spec)
    vocab=129280,
    act="silu",
    glu=True,
    norm="rmsnorm",
    attention="mla",
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff=2048),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
)
