"""Causal / sliding-window flash attention as a hand-written CUDA kernel.

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``: online-softmax
attention over q (H, S, d) with the (S, S) scores kept on chip, causal
and/or windowed, ``acc / max(l, 1e-30)``.  The port adds ``kv_group``: k and
v hold ``H // kv_group`` heads and query head h reads kv head
``h // kv_group``, so grouped-query attention needs no repeated k/v
(``kv_group=1`` is the TPU kernel's function).  The source is
``csrc/flash_attention.cu`` (design and bound are documented there), on
one of three routes that :func:`fwd_route` picks from the dtype, the head
dim and the operands' alignment: bfloat16 with ``d % 8 == 0`` up to 160
on ``wgmma`` + TMA (instantiated at 64, 128 and 160, the next at or above
d: danube's 120 runs the 128 kernels, reading zero columns past d),
misaligned bfloat16 views, ``d % 8 != 0`` and d past 160 on ``mma.sync``
(the head dim padded to 32, 64, 128, 160 or 256 on chip), float32 on a
SIMT kernel without tensor cores.  Head dims run up to 256.

:func:`flash_attention` is the wrapper the attention layer calls: a CPU
tensor takes the plain version (:func:`repro_torch.kernels.ref.
flash_attention`, which autograd differentiates), a CUDA tensor launches
the kernel or raises.  Where a gradient is wanted on a CUDA tensor the call
goes through :class:`FlashAttentionFn`: its forward is the kernel's
training form (each row's log-sum-exp and the output in float32 beside
it; in bfloat16 the P V product also adds P's bf16 remainder, so the output
comes within about 2**-16 of the float32 one before its cast, where
serving's P V rounds P to bf16), its backward is the kernel
``flash_attention_bwd`` (:func:`flash_attention_bwd_cuda`, in the same
source; no atomics, so the same bits on every run) on one of three routes
that :func:`bwd_route` picks from the dtype, the head dim and the
operands' alignment: ``wgmma`` + TMA for bf16 with ``d % 8 == 0`` up to
160 (at d 160 its dk/dv kernel splits dK and dV between the block's two
warpgroups), ``mma.sync`` for the other bf16 calls up to 160 (``d % 8 !=
0``, misaligned views), SIMT for float32 and bf16 past 160.
Importing this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch, cost, fake, ref

#: the largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: q, k, v, out, lse, out32, H, S, d, causal, window, kv_group, scale,
#: dtype code, route code (then the device and the stream)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                      ctypes.c_int,
                                                      ctypes.c_int]
_NAMES = ("q", "k", "v")
#: q, k, v, out32, dout, lse, dq, dk, dv, delta, H, S, d, causal, window,
#: kv_group, scale, dtype code, route code (then the device and the stream)
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                           ctypes.c_int,
                                                           ctypes.c_int]

#: the route codes of both C entries, and their names in the dry run's
#: tally
WGMMA, MMA_SYNC, SIMT = 0, 1, 2
ROUTE_NAMES = ("wgmma", "mma.sync", "SIMT")
#: the largest head dim on ``wgmma`` + TMA (its kernels are built at 64,
#: 128 and 160)
WGMMA_MAX_HEAD_DIM = 160


def _on_wgmma(d: int, aligned: bool) -> bool:
    """Whether a bfloat16 call at head dim ``d`` takes ``wgmma`` + TMA:
    operands on 16-byte boundaries and rows of a multiple of 16 bytes, as
    its tensor maps need, up to ``WGMMA_MAX_HEAD_DIM``."""
    return aligned and d % 8 == 0 and d <= WGMMA_MAX_HEAD_DIM


def fwd_route(dtype: torch.dtype, d: int, aligned: bool = True) -> int:
    """The forward's route for head dim ``d`` in ``dtype``: ``WGMMA``
    (``wgmma`` + TMA) for bfloat16 with ``d % 8 == 0`` up to 160 when
    ``aligned``, ``MMA_SYNC`` (``mma.sync``, the head dim padded on chip)
    for the other bfloat16 calls up to d 256 (misaligned views, ``d % 8 !=
    0``, d past 160), ``SIMT`` for float32 (whose products on tensor cores
    would round to TF32).  ``aligned``: whether q, k and v all start on
    16-byte boundaries, as TMA needs (out, lse and out32, which the
    wrapper allocates, always do)."""
    if dtype == torch.bfloat16:
        return WGMMA if _on_wgmma(d, aligned) else MMA_SYNC
    return SIMT


def bwd_route(dtype: torch.dtype, d: int, aligned: bool = True) -> int:
    """The backward's route for head dim ``d`` in ``dtype``: ``WGMMA``
    (``wgmma`` + TMA) for bfloat16 with ``d % 8 == 0`` up to 160 when
    ``aligned``, ``MMA_SYNC`` (``mma.sync``, the head dim padded to 32,
    64, 128 or 160 on chip) for the other bfloat16 calls up to d 160
    (misaligned views, ``d % 8 != 0``), ``SIMT`` for float32 (whose
    products on tensor cores would round to TF32) and for bfloat16 past d
    160.  ``aligned``: whether q, k, v and dout all start on 16-byte
    boundaries, as TMA needs (dq, dk and dv, which the wrapper allocates,
    always do)."""
    if dtype == torch.bfloat16 and d <= WGMMA_MAX_HEAD_DIM:
        return WGMMA if _on_wgmma(d, aligned) else MMA_SYNC
    return SIMT


def _check_shapes(name: str, q, k, v, kv_group: int):
    """(H, S, d) of ``q``; raise ``ValueError`` unless k and v are (H //
    kv_group, S, d) with d in [1, 256]."""
    if q.dim() != 3 or kv_group < 1 or q.shape[0] % kv_group:
        raise ValueError(f"{name} takes q (H, S, d) with H divisible by "
                         f"kv_group={kv_group}, got {tuple(q.shape)}")
    H, S, d = q.shape
    kv_shape = (H // kv_group, S, d)
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"{name}: k and v must be {kv_shape}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name} takes head dims up to {MAX_HEAD_DIM}, got "
                         f"{d}")
    return H, S, d


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_group: int = 1, train: bool = False):
    """Launch the kernel: ``q`` (H, S, d), ``k`` and ``v`` (H // kv_group,
    S, d) with d <= 256, all float32 or all bfloat16, contiguous, on one
    CUDA device.  Returns a new (H, S, d) tensor of ``q``'s dtype; with
    ``train``, the kernel's training form (see the module note) and
    ``(out, lse, out32)``: each row's log-sum-exp of its scaled, masked
    scores, float32 (H, S), and the output in float32 (``out`` itself in
    float32).  The kernel runs on :func:`fwd_route`'s route.  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when the launch
    is refused."""
    code, dev = _launch.check_operands("flash_attention", _NAMES, q, k, v)
    H, S, d = _check_shapes("flash_attention", q, k, v, kv_group)
    out = torch.empty_like(q)
    lse = out32 = None
    if train:
        lse = torch.empty((H, S), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
    if fake.modelled(q):
        fake.record("flash_attention", cost.flash_attention(
            H, k.shape[0], S, d, q.element_size(), causal=causal,
            window=window, train=train),
            ROUTE_NAMES[fwd_route(q.dtype, d, fake.aligned(q, k, v))])
        return (out, lse, out32) if train else out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0
    ptr = lambda t: 0 if t is None or t is out else t.data_ptr()  # noqa
    _launch.launch("flash_attention", _ARGS, dev, *ptrs, out.data_ptr(),
                   ptr(lse), ptr(out32), H, S, d, int(causal), int(window),
                   kv_group, 1.0 / math.sqrt(d), code,
                   fwd_route(q.dtype, d, aligned))
    flash_attention_cuda.launches += 1
    return (out, lse, out32) if train else out


#: kernel launches since the last reset (``flash_attention_cuda.launches =
#: 0``)
flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out32: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             kv_group: int = 1):
    """Launch the backward kernels on their :func:`bwd_route`: q, k, v as
    for the forward, ``out32`` and ``lse`` from its training form (the
    output and each row's log-sum-exp, float32, (H, S, d) and (H, S)),
    ``dout`` the gradient of the output (H, S, d, q's dtype), on one CUDA
    device.  Returns (dq, dk, dv) in q's dtype, dk and dv summed over each
    kv head's ``kv_group`` query heads.  Raises ``ValueError`` on any other
    input and ``RuntimeError`` when the launch is refused."""
    code, dev = _launch.check_operands(
        "flash_attention_bwd", ("q", "k", "v", "dout"), q, k, v, dout)
    H, S, d = _check_shapes("flash_attention_bwd", q, k, v, kv_group)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout must be "
                         f"{tuple(q.shape)}, got {tuple(dout.shape)}")
    for name, t, shape in (("out32", out32, (H, S, d)), ("lse", lse, (H, S))):
        if (t.dtype != torch.float32 or t.shape != shape
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous float32 {shape} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((H, S), dtype=torch.float32, device=q.device)
    if fake.modelled(q):
        code = bwd_route(q.dtype, d, fake.aligned(q, k, v, dout))
        fake.record("flash_attention_bwd", cost.flash_attention_bwd(
            H, k.shape[0], S, d, q.element_size(), causal=causal,
            window=window), ROUTE_NAMES[code])
        return dq, dk, dv
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0
    _launch.launch("flash_attention_bwd", _BWD_ARGS, dev, *ptrs[:3],
                   out32.data_ptr(), ptrs[3], lse.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), H, S, d,
                   int(causal), int(window), kv_group, 1.0 / math.sqrt(d),
                   code, bwd_route(q.dtype, d, aligned),
                   library="flash_attention")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


#: kernel launches since the last reset
#: (``flash_attention_bwd_cuda.launches = 0``)
flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's training form with the backward kernel as its gradient
    (CUDA tensors): the forward keeps its float32 output and row
    log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_group):
        out, lse, out32 = flash_attention_cuda(
            q, k, v, causal=causal, window=window, kv_group=kv_group,
            train=True)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.mask = (causal, window, kv_group)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        causal, window, kv_group = ctx.mask
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out32, dout.contiguous(), lse, causal=causal,
            window=window, kv_group=kv_group)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_group: int = 1) -> torch.Tensor:
    """Masked softmax attention over (H, S, d): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (through
    :class:`FlashAttentionFn` when a gradient is wanted; fake tensors that
    stand for the card's take the kernel's fake rule,
    :mod:`repro_torch.kernels.fake`)."""
    if q.is_cpu and not fake.modelled(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   kv_group=kv_group)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_group)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_group=kv_group)
