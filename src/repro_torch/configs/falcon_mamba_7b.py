"""Falcon-Mamba-7B — pure Mamba-1 SSM (attention-free).

[ssm] 64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="falcon_mamba_7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_variant="mamba1",
        expand=2,
        d_conv=4,
        remat="dots",
        fsdp=True,
        notes=(
            "Attention-free: Plaid's attention-related sharding aspects N/A "
            "(DESIGN.md §4); motif fusion applies to the SSM block DFG. Runs "
            "long_500k with O(1) recurrent state."
        ),
    )
)
