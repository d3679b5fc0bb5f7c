"""The work a cell's steps need, counted from the configuration and the
traffic's shapes, so it is the same whatever implements it.

Frozen copy of the port's ``launch.train.model_flops`` and of
``ModelConfig.param_count`` for the dense and moe families, taking the
benchmark's own configuration files (``bench/configs/*.json``, keys as in
the published ``config.json``) rather than the program's config objects.
Recomputation counts as time and not as work."""
from __future__ import annotations

from typing import Dict


def dims(cfg: Dict) -> Dict[str, int]:
    """The widths the counts need, from a configuration as run."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {"d": d, "H": H, "Hkv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // H,
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"],
            "E": cfg.get("num_local_experts", 0),
            "K": cfg.get("num_experts_per_tok", 0)}


def causal_pairs(T: int, window: int = 0) -> int:
    """The (query, key) pairs a causal (windowed) attention over T tokens
    computes."""
    if not window or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def layer_params(cfg: Dict, active_only: bool = False) -> int:
    """Parameters of one decoder layer: attention, the feed-forward half
    (top-k experts where ``active_only``) and the two norms."""
    x = dims(cfg)
    d, hd = x["d"], x["hd"]
    q, kv = x["H"] * hd, x["Hkv"] * hd
    attn = d * q + 2 * d * kv + q * d
    norms = 2 * d
    if x["E"]:
        n_exp = x["K"] if active_only else x["E"]
        return attn + d * x["E"] + n_exp * 3 * d * x["ff"] + norms
    return attn + 3 * d * x["ff"] + norms


def param_count(cfg: Dict, active_only: bool = False) -> int:
    """Every layer plus the tied embedding (the output head), and the
    final norm left out, as the port's ``param_count`` counts."""
    x = dims(cfg)
    return x["L"] * layer_params(cfg, active_only) + x["V"] * x["d"]


def attention_pair_flops(cfg: Dict) -> float:
    """Operations of one (query, key) pair of one head, forward: the two
    products QK^T and PV, 2 x head dim each."""
    return 4.0 * dims(cfg)["hd"]


def train_step_flops(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    """Model FLOPs of one training step of ``batch`` x ``seq`` tokens,
    forward and backward: 6 x the parameters a token uses x tokens for the
    products (the tied embedding once, as the output head), and 12 x head
    dim x query heads x causal pairs x batch for attention in each layer."""
    x = dims(cfg)
    tokens = batch * seq
    products = 6.0 * param_count(cfg, active_only=bool(x["E"])) * tokens
    attention = 3 * attention_pair_flops(cfg) * x["H"] * batch * \
        x["L"] * causal_pairs(seq)
    return {"products": products, "attention": attention,
            "total": products + attention}


def prefill_flops(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens:
    2 x the parameters a token uses x tokens for the layers' products, the
    output head at the last position only (the one logit row a prefill
    serves), and 4 x head dim x query heads x causal pairs x batch for
    attention in each layer."""
    x = dims(cfg)
    layers = x["L"] * layer_params(cfg, active_only=bool(x["E"]))
    products = 2.0 * layers * batch * seq + 2.0 * x["V"] * x["d"] * batch
    attention = attention_pair_flops(cfg) * x["H"] * batch * x["L"] * \
        causal_pairs(seq)
    return {"products": products, "attention": attention,
            "total": products + attention}


def swiglu_flops(cfg: Dict, tokens: int) -> float:
    """The gate and up products of the SwiGLU feed-forward, once a layer:
    2 products of tokens x d_model x d_ff, 2 operations a multiply-add."""
    x = dims(cfg)
    return 4.0 * tokens * x["d"] * x["ff"] * x["L"]


def attention_flops(cfg: Dict, batch: int, seq: int, train: bool) -> float:
    """Attention's two products over every layer: forward only for a
    prefill, forward and backward (3x) for a training step."""
    x = dims(cfg)
    f = attention_pair_flops(cfg) * x["H"] * batch * x["L"] * \
        causal_pairs(seq)
    return 3 * f if train else f
