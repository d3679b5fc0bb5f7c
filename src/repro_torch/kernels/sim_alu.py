"""The batched simulator's ALU stage as a hand-written CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/sim_alu.py::sim_alu``: per
(mapping, node) lane of one simulated cycle, apply the node's opcode to
its three gathered operands and its leaf value.  The source is
``csrc/sim_alu.cu`` (design, bound and semantics are documented there);
it is built with ``nvcc --fmad=false`` at first use
(:mod:`repro_torch.kernels._build`) and launched through ``ctypes`` on
PyTorch's current stream.

:func:`sim_alu` is the wrapper the cycle loop calls: a CPU tensor takes
the plain version (:func:`repro_torch.kernels.ref.sim_alu`), a CUDA
tensor launches the kernel or raises — never a fallback.  Importing this
module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, ref

#: opcode, a, b, c, leaf, out, element count (then the device and the
#: stream)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
_NAMES = ("a", "b", "c", "leaf")


def sim_alu_cuda(opcode, a, b, c, leaf):
    """Launch the CUDA kernel: ``opcode`` int32, ``a``/``b``/``c``/``leaf``
    float32, all contiguous, of one shape, on one CUDA device.  Returns a
    new float32 tensor.  Raises ``ValueError`` on any other input and
    ``RuntimeError`` when the launch is refused."""
    if not opcode.is_cuda:
        raise ValueError(f"sim_alu_cuda needs CUDA tensors, got "
                         f"{opcode.device}")
    if opcode.dtype is not torch.int32:
        raise ValueError(f"opcode must be int32, got {opcode.dtype}")
    operands = (a, b, c, leaf)
    for i, t in enumerate(operands):
        if t.dtype is not torch.float32:
            raise ValueError(f"{_NAMES[i]} must be float32, got {t.dtype}")
    dev, shape = opcode.get_device(), opcode.shape
    for t in (opcode, *operands):
        if not t.is_cuda or t.get_device() != dev or t.shape != shape:
            args = (opcode, *operands)
            raise ValueError("sim_alu_cuda operands must share one device "
                             f"and shape; got {[tuple(x.shape) for x in args]}"
                             f" on {[str(x.device) for x in args]}")
        if not t.is_contiguous():
            raise ValueError("sim_alu_cuda operands must be contiguous")
    out = torch.empty_like(a)
    _launch.launch("sim_alu", _ARGS, dev, opcode.data_ptr(), a.data_ptr(),
                   b.data_ptr(), c.data_ptr(), leaf.data_ptr(),
                   out.data_ptr(), opcode.numel())
    sim_alu_cuda.launches += 1
    return out


#: kernel launches since the last reset (``sim_alu_cuda.launches = 0``)
sim_alu_cuda.launches = 0


def sim_alu(opcode, a, b, c, leaf):
    """Elementwise ALU over same-shape tensors: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if opcode.is_cpu:
        return ref.sim_alu(opcode, a, b, c, leaf)
    return sim_alu_cuda(opcode, a, b, c, leaf)
