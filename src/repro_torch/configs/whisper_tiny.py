"""Whisper-tiny — encoder-decoder audio backbone (conv frontend stubbed).

[audio] 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865 — enc-dec
[arXiv:2212.04356; unverified]

The modality frontend is a STUB per the assignment: ``input_specs()``
provides precomputed audio-frame embeddings (B, enc_seq, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="whisper_tiny",
        family="encdec",
        n_layers=4,  # decoder layers
        n_enc_layers=4,
        enc_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        rope_theta=10_000.0,  # we use RoPE in place of learned abs-pos (noted)
        remat="dots",
        fsdp=False,
        notes=(
            "Backbone only; mel-spectrogram conv frontend stubbed with "
            "precomputed frame embeddings. Decoder has self+cross attention."
        ),
    )
)
