"""RMSNorm as a hand-written CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``: per row
of an (M, D) matrix, ``x * rsqrt(mean(x**2) + eps) * scale`` in float32,
cast to the input type once.  The source is ``csrc/rmsnorm.cu`` (design and
bound are documented there), built at first use
(:mod:`repro_torch.kernels._build`) and launched through ``ctypes`` on
PyTorch's current stream.

:func:`rmsnorm` is the wrapper the model calls: a CPU tensor takes the plain
version (:func:`repro_torch.kernels.ref.rmsnorm`, which autograd
differentiates), a CUDA tensor launches the kernel or raises.  Where a
gradient is wanted on a CUDA tensor the call goes through
:class:`RMSNormFn`, whose backward is the kernel ``rmsnorm_bwd``
(:func:`rmsnorm_bwd_cuda`, in the same source).  Importing this module
needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, cost, fake, ref

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
    if fake.modelled(x):
        fake.record("rmsnorm", cost.rmsnorm(M, D, x.element_size()))
        return out
    _launch.launch("rmsnorm", _ARGS, dev, x.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), M, D, eps, code)
    rmsnorm_cuda.launches += 1
    return out


#: kernel launches since the last reset (``rmsnorm_cuda.launches = 0``)
rmsnorm_cuda.launches = 0


#: x, scale, dy, dx, dscale, partial, M, D, blocks, eps, dtype code (then
#: the device and the stream)
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int]
#: warps a block of the backward, at least one row each
BWD_WARPS = 8
#: the most blocks of the backward: one per SM of an H100, since the
#: register kernels' 241 to 255 registers a thread in bf16 (ptxas, on the
#: card: 241 a row over one warp, 251 over 2, 255 over 4) leave room for
#: one block an SM (each walks every (blocks x rows in flight)-th row, so
#: the dscale partials, and their sum, depend on the row count alone;
#: ``scripts/bwd_design_probes.py`` times 132, 264 and 528)
BWD_MAX_BLOCKS = 132
#: the widest row the backward takes
BWD_MAX_D = 32768


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the backward kernel: ``x`` and ``dy`` (M, D), ``scale`` (D,),
    one dtype, contiguous, on one CUDA device.  Returns (dx, dscale) in
    that dtype: dscale sums per-block partials (a float32 (blocks, D)
    scratch, one row a block) in block order, so it is the same bits on
    every run.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the launch is refused.

    The C entry, not this wrapper, picks the kernel: a row that fits the
    registers of 1, 2 or 4 warps (D a multiple of the 16-byte vector, at
    most 3072, 6144 or 12288 bf16, half that in float32; x, dy and dx on
    16-byte boundaries) takes ``rmsnorm_bwd_warp_kernel`` (one warp) or
    ``rmsnorm_bwd_split_kernel`` (2 or 4), any other
    ``rmsnorm_bwd_loop_kernel``.  All compute the same function within
    rounding and take any shape this wrapper passes, so the choice is one
    of speed alone and rests on the register kernels' vector width, which
    only the C side defines."""
    code, dev = _launch.check_operands("rmsnorm_bwd", ("x", "scale", "dy"),
                                       x, scale, dy)
    if x.dim() != 2 or scale.shape != (x.shape[1],) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd takes x and dy (M, D), scale (D,), "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(dy.shape)}")
    M, D = x.shape
    if D > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd takes rows up to {BWD_MAX_D} wide, "
                         f"got {D}")
    dx = torch.empty_like(x)
    if M == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    blocks = min(-(-M // BWD_WARPS), BWD_MAX_BLOCKS)
    partial = torch.empty((blocks, D), dtype=torch.float32,
                          device=x.device)
    if fake.modelled(x):
        fake.record("rmsnorm_bwd", cost.rmsnorm_bwd(M, D, x.element_size()))
        return dx, dscale
    _launch.launch("rmsnorm_bwd", _BWD_ARGS, dev, x.data_ptr(),
                   scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                   dscale.data_ptr(), partial.data_ptr(), M, D, blocks, eps,
                   code, library="rmsnorm")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dscale


#: kernel launches since the last reset (``rmsnorm_bwd_cuda.launches = 0``)
rmsnorm_bwd_cuda.launches = 0


class RMSNormFn(torch.autograd.Function):
    """The kernel's function with the backward kernel as its gradient
    (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the rows of (M, D) ``x``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (through :class:`RMSNormFn`
    when a gradient is wanted; fake tensors that stand for the card's take
    the kernel's fake rule, :mod:`repro_torch.kernels.fake`)."""
    if x.is_cpu and not fake.modelled(x):
        return ref.rmsnorm(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
