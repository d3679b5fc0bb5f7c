"""RMSNorm as a hand-written CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``: per row
of an (M, D) matrix, ``x * rsqrt(mean(x**2) + eps) * scale`` in float32,
cast to the input type once.  The source is ``csrc/rmsnorm.cu`` (design and
bound are documented there), built at first use
(:mod:`repro_torch.kernels._build`) and launched through ``ctypes`` on
PyTorch's current stream.

:func:`rmsnorm` is the wrapper the model calls: a CPU tensor takes the plain
version (:func:`repro_torch.kernels.ref.rmsnorm`), a CUDA tensor launches
the kernel or raises.  Importing this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, ref

#: x, scale, out, M, D, eps, dtype code (then the device and the stream)
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int]
_NAMES = ("x", "scale")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: ``x`` (M, D) and ``scale`` (D,), both float32 or
    both bfloat16, contiguous, on one CUDA device.  Returns a new (M, D)
    tensor of ``x``'s dtype.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the launch is refused."""
    code, dev = _launch.check_operands("rmsnorm", _NAMES, x, scale)
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (M, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    out = torch.empty_like(x)
    M, D = x.shape
    _launch.launch("rmsnorm", _ARGS, dev, x.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), M, D, eps, code)
    rmsnorm_cuda.launches += 1
    return out


#: kernel launches since the last reset (``rmsnorm_cuda.launches = 0``)
rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the rows of (M, D) ``x``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if x.is_cpu:
        return ref.rmsnorm(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
