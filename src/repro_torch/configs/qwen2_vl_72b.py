"""Qwen2-VL-72B — VLM backbone with M-RoPE (vision frontend stubbed).

[vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE
[arXiv:2409.12191; hf]

The vision patch-embedding frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch/token embeddings (B, T, d)
plus 3-axis (t, h, w) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2_vl_72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        m_rope=True,
        m_rope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        remat="dots",
        fsdp=True,
        notes="72B backbone; dynamic-resolution handled by the (stubbed) frontend.",
    )
)
