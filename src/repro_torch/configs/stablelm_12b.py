"""StableLM-2-12B — dense GQA transformer.

[dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="stablelm_12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        rope_theta=10_000.0,
        remat="dots",
        fsdp=True,
        notes="12B dense; head_dim=160 (d_model/n_heads).",
    )
)
