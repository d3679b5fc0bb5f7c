"""Causal / sliding-window flash attention as a hand-written CUDA kernel.

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``: online-softmax
attention over q (H, S, d) with the (S, S) scores kept on chip, causal
and/or windowed, ``acc / max(l, 1e-30)``.  The port adds ``kv_group``: k and
v hold ``H // kv_group`` heads and query head h reads kv head
``h // kv_group``, so grouped-query attention needs no repeated k/v
(``kv_group=1`` is the TPU kernel's function).  The source is
``csrc/flash_attention.cu`` (design and bound are documented there): a
bfloat16 kernel on tensor cores (``mma.sync``, the head dim padded to 32,
64, 128, 160 or 256 on chip) and a float32 kernel without them, chosen by
dtype.  Head dims run up to 256.

:func:`flash_attention` is the wrapper the attention layer calls: a CPU
tensor takes the plain version (:func:`repro_torch.kernels.ref.
flash_attention`), a CUDA tensor launches the kernel or raises.  Importing
this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch, ref

#: the largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: q, k, v, out, H, S, d, causal, window, kv_group, scale, dtype code (then
#: the device and the stream)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                      ctypes.c_int]
_NAMES = ("q", "k", "v")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_group: int = 1) -> torch.Tensor:
    """Launch the kernel: ``q`` (H, S, d), ``k`` and ``v`` (H // kv_group,
    S, d) with d <= 256, all float32 or all bfloat16, contiguous, on one
    CUDA device.  Returns a new (H, S, d) tensor of ``q``'s dtype.  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when the launch
    is refused."""
    code, dev = _launch.check_operands("flash_attention", _NAMES, q, k, v)
    if q.dim() != 3 or kv_group < 1 or q.shape[0] % kv_group:
        raise ValueError(f"flash_attention takes q (H, S, d) with H "
                         f"divisible by kv_group={kv_group}, got "
                         f"{tuple(q.shape)}")
    H, S, d = q.shape
    kv_shape = (H // kv_group, S, d)
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"flash_attention: k and v must be {kv_shape}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    out = torch.empty_like(q)
    _launch.launch("flash_attention", _ARGS, dev, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), out.data_ptr(), H, S, d,
                   int(causal), int(window), kv_group, 1.0 / math.sqrt(d),
                   code)
    flash_attention_cuda.launches += 1
    return out


#: kernel launches since the last reset (``flash_attention_cuda.launches =
#: 0``)
flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_group: int = 1) -> torch.Tensor:
    """Masked softmax attention over (H, S, d): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if q.is_cpu:
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   kv_group=kv_group)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_group=kv_group)
