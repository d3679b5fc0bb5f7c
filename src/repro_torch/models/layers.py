"""Shared model building blocks of the port (``repro/models/layers.py``).

Conventions, kept from the JAX package so the tests compare like with like:

* Params are nested dicts of tensors.  Every model module exposes
  ``param_spec(cfg)`` returning a matching nested dict of :class:`Spec`
  (shape, dtype, logical axes, init rule).  Weights are ``(in, out)`` and a
  projection is ``x @ w``.
* Activations are (B, T, ...) with heads before the head dim:
  q is (B, T, Hq, hd), k and v are (B, T, Hkv, hd).

Where the JAX package computes inline, the port calls its kernels:
:func:`rms_norm` is the ``rmsnorm`` kernel, the gate of :func:`swiglu` is
the ``fused_swiglu`` kernel and :func:`banded_attention` is the
``flash_attention`` kernel.  They compute the kernels' function, which in
bfloat16 rounds in other places than the JAX layers do (the JAX
``rms_norm`` multiplies by the scale after its cast; the JAX ``swiglu``
rounds ``x @ w1`` before the silu).  In float32 the two agree up to the
order of sums.

Training: :func:`chunked_xent` is the loss (one ``torch.utils.checkpoint``
a token chunk, so one chunk's float32 logits and their gradient are alive
at a time) and :func:`remat_policy` maps the config's ``remat`` onto
``torch.utils.checkpoint`` (:func:`remat`).  On a CUDA tensor that wants a
gradient each kernel goes through its ``torch.autograd.Function``, whose
backward is a kernel too.  ``lax.scan`` over layers is a Python loop in
the model modules.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import tracing
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_swiglu import fused_swiglu
from repro_torch.kernels.rmsnorm import rmsnorm

NEG = -1e30

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    #: the fan-in a normal leaf is scaled by, where it is not ``shape[0]``
    #: (a depth cut keeps the full stack's scale: ``depth_cut``)
    fan_in: Optional[int] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec_map(fn, tree):
    """Apply ``fn`` to every :class:`Spec` leaf of a nested dict."""
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: spec_map(fn, v) for k, v in tree.items()}


def shapes_of(tree):
    """Meta tensors of every leaf's shape and dtype (no memory), the
    counterpart of ``jax.ShapeDtypeStruct``."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def axes_of(tree):
    return spec_map(lambda s: s.axes, tree)


def _leaves(tree, prefix=()):
    """(path, Spec) pairs in ``jax.tree.flatten`` order (sorted keys)."""
    if isinstance(tree, Spec):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k], prefix + (k,))
    return out


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device,
                dtype: Optional[torch.dtype] = None):
    """Materialize params on ``device``: the counterpart of ``init_of``
    (layers.py:57-79), drawing normals from ``generator`` (which must live
    on ``device``) leaf by leaf in the JAX package's flatten order.  Every
    rule of ``init_of``: normal, zeros, ones, and the SSM's two fixed ones,
    ``ssm_a`` (``A_log`` = log 1..N along the state axis) and ``ssm_dt``
    (``dt_bias`` = softplus^-1(0.01)).  A normal weight is N(0, 1) /
    sqrt(shape[0]), so a weight stacked over layers is scaled by the layer
    count as in the JAX package; ``jax.random`` cannot be reproduced, so
    the normal values differ (a spec's ``fan_in``, where set, replaces
    ``shape[0]``).  The fixed rules give the JAX values, except
    that ``ssm_a`` takes the correctly rounded float32 log (computed in
    float64), where XLA's float32 log on the CPU is one ulp off at a few
    integers (7, 47, 49, 179).  ``dtype`` overrides every spec's dtype."""
    out: Dict[str, Any] = {}
    for path, s in _leaves(spec_tree):
        dt = dtype or s.dtype
        if s.init == "zeros":
            v = torch.zeros(s.shape, dtype=dt, device=device)
        elif s.init == "ones":
            v = torch.ones(s.shape, dtype=dt, device=device)
        elif s.init == "ssm_a":  # -log-uniform init for A_log
            a = torch.arange(1, s.shape[-1] + 1, dtype=torch.float64,
                             device=device)
            v = a.log().float().to(dt).expand(s.shape).contiguous()
        elif s.init == "ssm_dt":  # softplus^-1(0.01)
            v = torch.full(s.shape, math.log(math.e ** 0.01 - 1.0),
                           dtype=dt, device=device)
        else:
            fan_in = s.fan_in or (s.shape[0] if len(s.shape) > 1
                                  else max(s.shape[-1], 1))
            v = torch.randn(s.shape, generator=generator, device=device,
                            dtype=torch.float32)
            v = v.div_(math.sqrt(fan_in)).to(dt)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis through the ``rmsnorm`` kernel (the scale
    is applied in float32 before the one cast)."""
    return rmsnorm(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """RoPE's inverse frequencies in float32, each the float64 power
    rounded once, so the same bits on every device: CUDA's float32 pow
    is up to 5 ulp off the CPU's, which at position 4600 moves an angle
    by up to about 1e-3 rad."""
    half = head_dim // 2
    return (theta ** (-torch.arange(0, half, dtype=torch.float64,
                                    device=device) / half)).float()


def apply_rope(x: torch.Tensor,  # (B, T, H, hd)
               positions: torch.Tensor,  # (B, T) or (B, 3, T) for m_rope
               theta: float,
               m_rope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    hd = x.shape[-1]
    half = hd // 2
    inv = _inv_freq(hd, theta, x.device)  # (half,)
    if m_rope_sections is not None:
        st, sh, sw = m_rope_sections
        assert st + sh + sw == half, (m_rope_sections, half)
        # section s of the frequency spectrum reads position axis s (t/h/w)
        sec = torch.cat([torch.full((n,), i, dtype=torch.long,
                                    device=x.device)
                         for i, n in enumerate((st, sh, sw))])
        pos = positions.float()[:, sec, :]  # (B, half, T)
        ang = torch.einsum("bft,f->btf", pos, inv)  # (B, T, half)
    else:
        ang = positions.float()[..., None] * inv  # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]  # (B, T, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def banded_attention(q: torch.Tensor,  # (B, T, Hq, hd)
                     k: torch.Tensor,  # (B, T, Hkv, hd)
                     v: torch.Tensor, *, causal: bool = True,
                     window: int = 0) -> torch.Tensor:
    """Causal / sliding-window attention through the ``flash_attention``
    kernel, which skips the tiles off the band as the JAX blockwise walk
    does.  Heads go to the front, (B * H, T, hd); grouped-query attention
    is the kernel's ``kv_group``, so k and v are never repeated."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    # at B = 1 the reshape is a view with the heads' stride, which the
    # kernel refuses: contiguous() copies only then
    heads_first = lambda t: t.permute(0, 2, 1, 3).reshape(  # noqa: E731
        -1, T, hd).contiguous()
    o = flash_attention(heads_first(q), heads_first(k), heads_first(v),
                        causal=causal, window=window, kv_group=Hq // Hkv)
    return o.view(B, Hq, T, hd).permute(0, 2, 1, 3)


def naive_attention(q, k, v, *, causal=True, window: int = 0):
    """Full masked attention (plain PyTorch, float32 inside)."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor,  # (B, 1, Hq, hd)
                     k_cache: torch.Tensor,  # (B, S, Hkv, hd)
                     v_cache: torch.Tensor,
                     valid: torch.Tensor,  # (B, S) bool: live cache slots
                     ) -> torch.Tensor:
    """One query per sequence against its cache (plain PyTorch, float32
    inside; the JAX package computes it outside any kernel too)."""
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    s = s / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attention_param_spec(cfg) -> Dict[str, Spec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": Spec((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": Spec((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wv": Spec((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wo": Spec((cfg.n_heads * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = Spec((hd,), (None,), init="ones")
        p["k_norm"] = Spec((hd,), (None,), init="ones")
    return p


def attention_qkv(cfg, w, x, positions):
    """Projections + qk-norm + RoPE (span ``model.rope``).  Returns q
    (B,T,Hq,hd), k, v (B,T,Hkv,hd)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ w["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = (x @ w["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (x @ w["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"])
        k = rms_norm(k, w["k_norm"])
    sections = cfg.m_rope_sections if cfg.m_rope else None
    with tracing.span("model.rope"):
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attention_layer(cfg, w, x, positions, *, causal=True,
                    attn_impl="banded",
                    cross_x: Optional[torch.Tensor] = None):
    """Self- or cross-attention over a full sequence (prefill).  Returns
    (out, (k, v)) so prefill can build the cache.

    ``cross_x``: encoder hidden states (B, S, D).  k and v are projected
    from them (no RoPE; q gets RoPE at ``positions``) and the attention is
    bidirectional over the encoder axis.  Causal self-attention goes
    through the ``flash_attention`` kernel; non-causal attention (the
    encoder, cross-attention, whose q and k lengths differ) is
    :func:`naive_attention`, as the JAX package computes it."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    if cross_x is None:
        q, k, v = attention_qkv(cfg, w, x, positions)
    else:
        q = (x @ w["wq"]).reshape(B, T, cfg.n_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, w["q_norm"])
        with tracing.span("model.rope"):
            q = apply_rope(q, positions, cfg.rope_theta,
                           cfg.m_rope_sections if cfg.m_rope else None)
        S = cross_x.shape[1]
        k = (cross_x @ w["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (cross_x @ w["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            k = rms_norm(k, w["k_norm"])
        causal = False
    if attn_impl == "banded" and causal:
        o = banded_attention(q, k, v, causal=causal,
                             window=cfg.sliding_window)
    else:
        o = naive_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window)
    out = o.reshape(B, T, -1) @ w["wo"]
    return out, (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_param_spec(cfg, d_ff=None) -> Dict[str, Spec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w1": Spec((d, f), ("embed", "mlp")),
        "w3": Spec((d, f), ("embed", "mlp")),
        "w2": Spec((f, d), ("mlp", "embed")),
    }


def swiglu(w, x):
    """``fused_swiglu(x, w1, w3) @ w2``: the gate through the kernel, the
    down projection a plain matrix product."""
    d = x.shape[-1]
    h = fused_swiglu(x.reshape(-1, d), w["w1"], w["w3"])
    return (h @ w["w2"]).reshape(x.shape[:-1] + (w["w2"].shape[1],))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_param_spec(cfg) -> Dict[str, Spec]:
    return {"emb": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}


def embed_lookup(emb, tokens):
    return emb[tokens]


# ---------------------------------------------------------------------------
# Chunked cross-entropy and rematerialisation (training)
# ---------------------------------------------------------------------------


def _xent_chunk(hh: torch.Tensor, yy: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
    """Sum over a chunk of ``logsumexp(logits) - logits[label]``, logits in
    float32: one ``cross_entropy`` (log-softmax, then the label's pick;
    both backwards are deterministic on CUDA).
    ``scripts/xent_peak.py`` measures its memory on the card."""
    logits = (hh @ emb.T).float()  # (chunk, V)
    return torch.nn.functional.cross_entropy(logits, yy, reduction="sum")


def chunked_xent(hidden: torch.Tensor, emb: torch.Tensor,
                 labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Next-token cross-entropy without building (tokens, vocab) in float32
    (``repro/models/layers.py:378``): the tokens run in chunks of
    ``chunk``, each under its own ``torch.utils.checkpoint``, so at most one
    chunk's (chunk, V) float32 logits and their gradient are alive at a
    time (the backward recomputes them).  As in the JAX package the last
    chunk is padded with zero hidden states and label 0, each pad row adds
    log V to the sum (its logits are all 0), and the sum is divided by the
    true token count; the pad rows add nothing to any gradient."""
    B, T, D = hidden.shape
    h = hidden.reshape(B * T, D)
    y = labels.reshape(B * T).long()
    n = h.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for hh, yy in zip(h.split(chunk), y.split(chunk)):
        total = total + _ckpt.checkpoint(_xent_chunk, hh, yy, emb,
                                         use_reentrant=False)
    return total / n


#: the products the ``"dots"`` policy keeps: every matrix product without
#: batch dimensions, as ``jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable`` keeps them (a projection ``x @ w`` of
#: a (B, T, D) activation folds into one ``mm``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = _ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _SAVED_DOTS else \
        policy.PREFER_RECOMPUTE


def remat_policy(name: str) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a config's
    ``remat`` (``repro/models/layers.py:409``): ``"dots"`` saves the
    outputs of ``aten.mm`` / ``aten.addmm`` (selective checkpointing, the
    counterpart of ``dots_with_no_batch_dims_saveable``) and recomputes the
    rest, ``"nothing"`` recomputes everything (full checkpointing), and any
    other name (``"full"``) gives ``None``: no wrapper, everything kept.
    A kernel launched through ``ctypes`` is not an aten op, so it is
    recomputed in the backward under both wrapping policies."""
    if name == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                 _save_dots)
    if name == "nothing":
        return _ckpt.noop_context_fn
    return None


def remat(fn: Callable, policy: Optional[Callable], *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``policy`` (a
    :func:`remat_policy` result) when a gradient is being recorded and the
    policy is not ``None``; a plain call otherwise."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=policy)
