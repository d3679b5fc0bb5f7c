"""What each language-model kernel of the port must move and compute: the
bytes (each input read once, each output written once) and the operations
of one call, with the card's peak rate for their type.

One copy for everything that needs them: ``chip_smoke.py``'s kernel bounds
and the dry run's kernel tally (:mod:`repro_torch.kernels.fake`).  Each
function returns ``(bytes, operations, operations a second)``; the rates
are :mod:`repro_torch.launch.roofline`'s (NVIDIA H100 SXM data sheet).
Products on tensor cores count at the dense bf16 rate in bfloat16 and at
the float32 rate in float32 (the float32 routes run on the SIMT units);
the elementwise kernels' arithmetic runs in float32.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.launch.roofline import BF16_OPS_PER_S, FP32_OPS_PER_S

Cost = Tuple[float, float, float]


def _product_rate(itemsize: int) -> float:
    return BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S


def attention_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs one head of an S-token attention computes,
    under the mask of ``ref.flash_attention``: key j is live for query i
    where ``i - j < window`` (if ``window``) and ``j <= i`` (if
    ``causal``)."""
    far = 0 if not window or window >= S else \
        (S - window) * (S - window + 1) // 2  # pairs window or more back
    return (S * (S + 1) // 2 if causal else S * S) - far


def rmsnorm(M: int, D: int, itemsize: int) -> Cost:
    """x (M, D) and scale (D,) in, (M, D) out; square, sum, scale twice a
    value."""
    return (2 * M * D + D) * itemsize, 4 * M * D, FP32_OPS_PER_S


def fused_swiglu(M: int, D: int, F: int, itemsize: int) -> Cost:
    """x (M, D), w1 and w3 (D, F) in, (M, F) out; two products and the
    gate."""
    return ((M * D + 2 * D * F + M * F) * itemsize, 4 * M * D * F + 5 * M * F,
            _product_rate(itemsize))


def flash_attention(H: int, Hkv: int, S: int, d: int, itemsize: int, *,
                    causal: bool = True, window: int = 0,
                    train: bool = False) -> Cost:
    """q and out (H, S, d), k and v (Hkv, S, d); two products over the live
    pairs.  The training form also writes each row's float32 log-sum-exp
    and, in bfloat16, the float32 output."""
    n_bytes = (2 * H + 2 * Hkv) * S * d * itemsize
    if train:
        n_bytes += H * S * 4 + (H * S * d * 4 if itemsize != 4 else 0)
    pairs = H * attention_pairs(S, causal, window)
    return n_bytes, 4 * d * pairs, _product_rate(itemsize)


def rmsnorm_bwd(M: int, D: int, itemsize: int) -> Cost:
    """x and dy (M, D), scale (D,) in, dx (M, D) and dscale (D,) out."""
    return 3 * M * D * itemsize + 2 * D * itemsize, 10 * M * D, FP32_OPS_PER_S


def swiglu_gate_bwd(n: int, itemsize: int) -> Cost:
    """a, b, dh in, da, db out, ``n`` elements each."""
    return 5 * n * itemsize, 12 * n, FP32_OPS_PER_S


def flash_attention_bwd(H: int, Hkv: int, S: int, d: int, itemsize: int, *,
                        causal: bool = True, window: int = 0) -> Cost:
    """q, dout, dq (H, S, d), k, v, dk, dv (Hkv, S, d) and the float32 row
    statistics; five products over the live pairs."""
    pairs = H * attention_pairs(S, causal, window)
    return ((4 * H + 4 * Hkv) * S * d * itemsize + H * S * 4, 10 * d * pairs,
            _product_rate(itemsize))


def adamw(n: int, p_size: int, g_size: int, s_size: int) -> Cost:
    """AdamW's fused update over ``n`` parameters (params, grads and state
    of the given item sizes): reads p, g, m and v and writes p, m and v
    once; about 17 operations a parameter."""
    return n * (2 * p_size + g_size + 4 * s_size), 17 * n, FP32_OPS_PER_S


def adamw_norm(n: int, n_bytes: int) -> Cost:
    """The global norm over ``n`` gradient entries, ``n_bytes`` in all
    (leaves of either dtype): each read once, a square and an add each
    (the finishing sum of the partials is negligible)."""
    return n_bytes, 2 * n, FP32_OPS_PER_S
