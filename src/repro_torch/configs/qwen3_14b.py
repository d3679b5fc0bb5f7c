"""Qwen3-14B — dense GQA transformer with qk-norm.

[dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 — qk_norm, GQA
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen3_14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        remat="dots",
        fsdp=True,
        notes="qk-norm per head (RMSNorm on q/k before RoPE), head_dim=128.",
    )
)
