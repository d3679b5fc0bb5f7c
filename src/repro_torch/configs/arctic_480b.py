"""Snowflake Arctic 480B — 128-expert top-2 MoE with dense residual branch.

[moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="arctic_480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        n_experts=128,
        top_k=2,
        moe_dense_ff=4864,  # Arctic's dense-residual MLP in parallel with MoE
        capacity_factor=1.25,
        rope_theta=10_000.0,
        remat="dots",
        fsdp=True,
        opt_state_dtype="bfloat16",  # 480B-class: bf16 m/v halves optimizer HBM
        notes=(
            "~470B params; experts sharded over 'model' (EP), d_model dim over "
            "'data' (FSDP). bf16 optimizer states keep the 256-chip pod within "
            "HBM (documented in EXPERIMENTS.md)."
        ),
    )
)
