"""Llama-3.2-3B — small llama3 dense GQA transformer.

[dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="llama3_2_3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
        remat="dots",
        fsdp=False,
        notes="llama3-style; 3B fits replicated-over-data comfortably.",
    )
)
