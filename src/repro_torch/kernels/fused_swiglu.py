"""The fused SwiGLU gate as a hand-written CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/fused_swiglu.py::fused_swiglu``:
``silu(x @ w1) * (x @ w3)`` for x (M, D) and w1, w3 (D, F), both products
and the gate in float32, cast to the input type once.  The source is
``csrc/fused_swiglu.cu`` (design and bound are documented there): the
products are the kernel's own, with no cuBLAS and no ``torch.matmul``.

The kernel has three routes, picked by :func:`route` from the shape, the
dtype and the operands' alignment: a byte-bound stream for decode
(``STREAM``, M <= 16), a ``wgmma`` + TMA GEMM for bf16 prefill
(``TENSOR_CORES``) and the SIMT kernel for the rest (``SIMT``).

:func:`fused_swiglu` is the wrapper the MLP calls: a CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.fused_swiglu`, which autograd
differentiates), a CUDA tensor launches the kernel or raises.  Where a
gradient is wanted on a CUDA tensor the call goes through
:class:`SwiGLUFn`: its backward recomputes ``a = x @ w1`` and ``b = x @
w3`` with ``torch.matmul`` in the input type (so in bfloat16 both are
rounded to bfloat16 before the gate's backward; the forward keeps them in
float32), runs the gate's backward kernel ``swiglu_gate_bwd``
(:func:`swiglu_gate_bwd_cuda`, in the same source) and leaves dx, dw1 and
dw3 to ``torch.matmul``, as the JAX package leaves every product of its
gradient to XLA.  Importing this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, cost, fake, ref

#: x, w1, w3, out, M, D, F, dtype code, route code (then the device and the
#: stream)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
_NAMES = ("x", "w1", "w3")
_INT_MAX = 2 ** 31 - 1

#: the route codes of the C entry
STREAM, TENSOR_CORES, SIMT = 0, 1, 2
ROUTE_NAMES = {STREAM: "stream", TENSOR_CORES: "tensor cores", SIMT: "SIMT"}
#: the most rows of x the stream route takes
STREAM_MAX_ROWS = 16


def route(M: int, D: int, F: int, dtype: torch.dtype,
          aligned: bool = True) -> int:
    """The route for x (M, D) and w1, w3 (D, F) of ``dtype``: ``STREAM``
    for at most 16 rows (decode; either dtype), ``TENSOR_CORES`` for more
    rows in bfloat16 when D and F are multiples of 8 (TMA's 16-byte
    strides) and ``aligned``, ``SIMT`` otherwise (float32 at M > 16, where
    TF32 products would miss the float32 tolerance, and bf16 that TMA
    cannot describe).  ``aligned``: whether x, w1, w3 and the output all
    start on 16-byte boundaries, as TMA needs (a view at an odd element
    offset does not; the output, which the wrapper allocates, always
    does)."""
    if M <= STREAM_MAX_ROWS:
        return STREAM
    if dtype == torch.bfloat16 and D > 0 and D % 8 == 0 and F % 8 == 0 \
            and aligned:
        return TENSOR_CORES
    return SIMT


def fused_swiglu_cuda(x: torch.Tensor, w1: torch.Tensor,
                      w3: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on its :func:`route`: ``x`` (M, D), ``w1`` and
    ``w3`` (D, F), all float32 or all bfloat16, contiguous, on one CUDA
    device.  Returns a new (M, F) tensor of ``x``'s dtype.  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when the launch
    is refused."""
    code, dev = _launch.check_operands("fused_swiglu", _NAMES, x, w1, w3)
    if x.dim() != 2 or w1.dim() != 2 or w1.shape[0] != x.shape[1] \
            or w3.shape != w1.shape:
        raise ValueError(f"fused_swiglu takes x (M, D), w1/w3 (D, F), got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, "
                         f"{tuple(w3.shape)}")
    (M, D), F = x.shape, w1.shape[1]
    if max(M, D, F) > _INT_MAX:
        raise ValueError(f"fused_swiglu: a dimension of {(M, D, F)} "
                         "exceeds int32")
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    if fake.modelled(x):
        code = route(M, D, F, x.dtype, fake.aligned(x, w1, w3, out))
        fake.record("fused_swiglu",
                    cost.fused_swiglu(M, D, F, x.element_size()),
                    ROUTE_NAMES[code])
        return out
    ptrs = (x.data_ptr(), w1.data_ptr(), w3.data_ptr(), out.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0
    _launch.launch("fused_swiglu", _ARGS, dev, *ptrs, M, D, F, code,
                   route(M, D, F, x.dtype, aligned))
    fused_swiglu_cuda.launches += 1
    return out


#: kernel launches since the last reset (``fused_swiglu_cuda.launches = 0``)
fused_swiglu_cuda.launches = 0


#: a, b, dh, da, db, n, dtype code (then the device and the stream)
_GATE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]


def swiglu_gate_bwd_cuda(a: torch.Tensor, b: torch.Tensor,
                         dh: torch.Tensor):
    """Launch the gate's backward kernel on same-shape ``a`` (x @ w1), ``b``
    (x @ w3) and ``dh`` (the gradient of the gate), one dtype, contiguous,
    on one CUDA device: returns (da, db) = (dh * b * silu'(a), dh *
    silu(a)), computed in float32 and cast once.  Raises ``ValueError`` on
    any other input and ``RuntimeError`` when the launch is refused."""
    code, dev = _launch.check_operands("swiglu_gate_bwd", ("a", "b", "dh"),
                                       a, b, dh)
    if b.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"swiglu_gate_bwd takes same-shape a, b, dh, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(dh.shape)}")
    da, db = torch.empty_like(a), torch.empty_like(b)
    if fake.modelled(a):
        fake.record("swiglu_gate_bwd",
                    cost.swiglu_gate_bwd(a.numel(), a.element_size()))
        return da, db
    _launch.launch("swiglu_gate_bwd", _GATE_ARGS, dev, a.data_ptr(),
                   b.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                   a.numel(), code, library="fused_swiglu")
    swiglu_gate_bwd_cuda.launches += 1
    return da, db


#: kernel launches since the last reset (``swiglu_gate_bwd_cuda.launches =
#: 0``)
swiglu_gate_bwd_cuda.launches = 0


class SwiGLUFn(torch.autograd.Function):
    """The fused gate with the gate's backward kernel in its gradient (CUDA
    tensors); see the module note."""

    @staticmethod
    def forward(ctx, x, w1, w3):
        ctx.save_for_backward(x, w1, w3)
        return fused_swiglu_cuda(x, w1, w3)

    @staticmethod
    def backward(ctx, dh):
        x, w1, w3 = ctx.saved_tensors
        da, db = swiglu_gate_bwd_cuda(x @ w1, x @ w3, dh.contiguous())
        dx = dw1 = dw3 = None
        if ctx.needs_input_grad[0]:
            dx = (da @ w1.T).addmm_(db, w3.T)
        if ctx.needs_input_grad[1]:
            dw1 = x.T @ da
        if ctx.needs_input_grad[2]:
            dw3 = x.T @ db
        return dx, dw1, dw3


def fused_swiglu(x: torch.Tensor, w1: torch.Tensor,
                 w3: torch.Tensor) -> torch.Tensor:
    """``silu(x @ w1) * (x @ w3)``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (through :class:`SwiGLUFn` when a gradient
    is wanted; fake tensors that stand for the card's take the kernel's
    fake rule, :mod:`repro_torch.kernels.fake`)."""
    if x.is_cpu and not fake.modelled(x):
        return ref.fused_swiglu(x, w1, w3)
    if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad
                                    or w3.requires_grad):
        return SwiGLUFn.apply(x, w1, w3)
    return fused_swiglu_cuda(x, w1, w3)
