"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention.

[dense] 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — SWA
[arXiv:2401.16818; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="h2o_danube_3_4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=10_000.0,
        remat="dots",
        fsdp=False,
        notes="SWA window=4096 (mistral-style); runs long_500k via window KV cache.",
    )
)
