"""Zamba2-1.2B — Mamba2 backbone + shared attention block hybrid.

[hybrid] 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="zamba2_1_2b",
        family="hybrid",
        n_layers=38,  # Mamba2 blocks
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,  # shared attention block is MHA
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_variant="mamba2",
        expand=2,
        attn_every=6,  # shared attn block applied every 6 Mamba2 blocks
        remat="dots",
        fsdp=False,
        notes=(
            "One shared transformer block (attn+MLP) reused at every application "
            "site (Zamba trick); per-site LoRA deltas omitted (documented "
            "simplification). Runs long_500k: SSM state is O(1), shared-attn KV "
            "cache sharded over sequence."
        ),
    )
)
