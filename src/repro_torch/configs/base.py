"""Model configurations of the port: a copy of ``repro.configs.base``.

``ModelConfig`` fully describes one architecture; ``ShapeSpec`` one
(seq_len, global_batch, kind) input-shape cell; ``RunConfig`` couples a
model, a shape and the training knobs.  Configs live in
``repro_torch.configs.<arch_id>`` and register themselves in
``ARCH_REGISTRY`` via ``register``.  Every served architecture's config
is copied (dense, vlm, moe, ssm, hybrid and encdec); :func:`get_config`
raises ``NotImplementedError`` for an id it does not know.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (family-specific fields default off)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention flavour ---
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention; >0 = SWA window
    rope_theta: float = 10_000.0
    m_rope: bool = False  # Qwen2-VL multimodal RoPE (3 sections)
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)  # t, h, w (per half-dim)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0  # Arctic-style parallel dense residual MLP width
    capacity_factor: float = 1.25

    # --- SSM ---
    ssm_state: int = 0
    ssm_variant: str = ""  # mamba1 | mamba2
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 256  # chunked-scan block size
    ssm_heads: int = 0  # mamba2 value heads (0 -> d_inner // 64)

    # --- hybrid (Zamba2) ---
    attn_every: int = 0  # shared attention block applied every k SSM blocks

    # --- encoder-decoder (Whisper backbone) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500  # audio frame positions (frontend is a stub)

    # --- numerics / memory policy ---
    dtype: str = "bfloat16"
    remat: str = "nothing"  # nothing | dots | full(=no remat)
    attn_impl: str = "banded"  # banded (flash-style) | naive (masked full)
    unroll_layers: bool = False  # roofline harness only (see layers.scan_layers)
    logits_chunk: int = 8192  # chunked cross-entropy block (tokens)
    attn_chunk: int = 1024  # flash-attention KV block (pure-jnp path)

    # --- parallelism hints ---
    fsdp: bool = False  # shard the d_model dim of params over 'data'
    opt_state_dtype: str = "float32"  # bf16 for the 480B-class model

    # free-form notes (source, verification tier, simplifications)
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(self.d_inner // 64, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter count (for MODEL_FLOPS = 6*N*D roofline accounting)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d  # wq, wk, wv, wo
        norms = 2 * d
        if self.qk_norm:
            norms += 2 * hd
        mlp_dense = 3 * d * self.d_ff
        per_layer: int
        if self.family in ("dense", "vlm"):
            per_layer = attn + mlp_dense + norms
            n = self.n_layers * per_layer
        elif self.family == "moe":
            router = d * self.n_experts
            n_exp = self.n_experts if not active_only else self.top_k
            experts = n_exp * 3 * d * self.d_ff
            dense_res = 3 * d * self.moe_dense_ff if self.moe_dense_ff else 0
            per_layer = attn + router + experts + dense_res + norms
            n = self.n_layers * per_layer
        elif self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per_layer = (
                d * 2 * di  # in_proj
                + di * self.d_conv  # depthwise conv
                + di * (2 * ns + di // 16 + 1)  # x_proj(B,C,dt) approx + dt_proj
                + di * ns  # A_log
                + di  # D
                + di * d  # out_proj
                + d
            )
            n = self.n_layers * per_layer
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            ssm_layer = d * 2 * di + di * self.d_conv + 3 * di + di * ns + di * d + d
            shared_attn = attn + mlp_dense + norms  # one shared block
            n = self.n_layers * ssm_layer + shared_attn
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp_dense + norms)
            dec = self.n_layers * (2 * attn + mlp_dense + norms + d)
            n = enc + dec
        else:
            raise ValueError(self.family)
        n += self.vocab_size * d  # tied embedding / output head
        return n


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment skip rules (documented in DESIGN.md §4)."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_IDS = [
    "stablelm_12b",
    "qwen3_14b",
    "llama3_2_3b",
    "h2o_danube_3_4b",
    "zamba2_1_2b",
    "whisper_tiny",
    "arctic_480b",
    "granite_moe_1b_a400m",
    "falcon_mamba_7b",
    "qwen2_vl_72b",
]


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.arch_id] = cfg
    return cfg


#: the architectures whose configs the port carries (dense, vlm, moe, ssm,
#: hybrid, encdec)
PORTED_ARCH_IDS = [
    "stablelm_12b",
    "qwen3_14b",
    "llama3_2_3b",
    "h2o_danube_3_4b",
    "zamba2_1_2b",
    "whisper_tiny",
    "arctic_480b",
    "granite_moe_1b_a400m",
    "falcon_mamba_7b",
    "qwen2_vl_72b",
]


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_REGISTRY:
        if arch_id not in PORTED_ARCH_IDS:
            raise NotImplementedError(
                f"{arch_id}: not a ported architecture; ported: "
                f"{PORTED_ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{arch_id}")
    return ARCH_REGISTRY[arch_id]


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def smoke_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config: small layers/width/experts/vocab."""
    cfg = get_config(arch_id)
    kw: Dict[str, Any] = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        logits_chunk=64,
        attn_chunk=32,
        ssm_chunk=16,
        fsdp=False,
        opt_state_dtype="float32",
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_dense_ff=64 if cfg.moe_dense_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_heads=4)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, n_kv_heads=4)  # zamba2 uses MHA
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=16)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.m_rope:  # scale M-RoPE sections to the reduced head_dim
        half = kw["head_dim"] // 2
        t = half - 2 * (half // 3)
        kw.update(m_rope_sections=(t, half // 3, half // 3))
    return cfg.replace(**kw)


def default_checkpoint_dir() -> str:
    """Where a run keeps its checkpoints unless told: ``repro_torch_ckpt``
    in the temporary directory (``$TMPDIR``); the JAX package's default is
    ``/tmp/repro_ckpt``."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass(frozen=True)
class RunConfig:
    """One launchable run = model x shape x training knobs
    (``repro/configs/base.py:256-276``; the JAX package's ``multi_pod`` is
    left out: the port runs on one card)."""

    model: ModelConfig
    shape: ShapeSpec
    # training knobs
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = dataclasses.field(
        default_factory=default_checkpoint_dir)
    keep_checkpoints: int = 3
    # distributed-optimization tricks
    grad_compression: str = "none"  # none | int8
    straggler_threshold: float = 3.0  # x median step time -> flagged
