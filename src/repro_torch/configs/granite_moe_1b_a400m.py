"""IBM Granite-3.0-1B-A400M — 32-expert top-8 MoE.

[moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="granite_moe_1b_a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        n_experts=32,
        top_k=8,
        moe_dense_ff=0,  # no dense residual branch
        capacity_factor=1.25,
        rope_theta=10_000.0,
        remat="nothing",
        fsdp=False,
        notes="1B total / ~400M active; tiny experts stress the dispatch path.",
    )
)
