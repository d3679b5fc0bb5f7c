"""The batched simulator's whole cycle loop as one hand-written CUDA kernel.

Replaces, on the verify path, the Pallas kernel
``repro/kernels/sim_alu.py::sim_alu`` together with the cycle loop around
it: one launch runs every cycle of every mapping of a bucket, one block per
mapping, with the ALU of ``csrc/sim_alu.cuh`` inside it.  The source is
``csrc/sim_loop.cu`` (design, bound and semantics are documented there); it
is built with ``nvcc --fmad=false`` at first use
(:mod:`repro_torch.kernels._build`) and launched through ``ctypes`` on
PyTorch's current stream.

The plain version is the eager loop,
:func:`repro_torch.sim.step.run_bucket_eager`, with
:func:`repro_torch.kernels.ref.sim_alu` as its ALU;
:func:`repro_torch.sim.step.run_bucket` takes it for a CPU bucket and
launches this kernel for a CUDA one.  :func:`sim_loop_cuda` itself takes
CUDA tensors only.  Importing this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, _launch

#: the bucket's statics, in the C entry's order: each one's dtype and its
#: shape in the letters of (B, N, K, M, S)
STATICS = {
    "ii": (torch.int32, "B"),
    "horizon": (torch.int32, "B"),
    "opcode": (torch.int32, "BN"),
    "exec_mask": (torch.bool, "BN"),
    "issue": (torch.int32, "BN"),
    "leaf": (torch.float32, "BN"),
    "op_kind": (torch.int8, "BNK"),
    "op_src": (torch.int32, "BNK"),
    "op_dist": (torch.int32, "BNK"),
    "op_feed": (torch.float32, "BNK"),
    "op_steps": (torch.int32, "BNKM"),
    "step_src": (torch.int32, "BS"),
    "step_abs": (torch.int32, "BS"),
}
#: the statics, val, done, avail, fail, stage, then B, N, K, M, S, I (then
#: the device and the stream)
_ARGS = [ctypes.c_void_p] * (len(STATICS) + 5) + [ctypes.c_int] * 6
#: ``sim_loop_state_in_shared``'s N, S, I and device
_FITS_ARGS = [ctypes.c_int] * 4


@functools.lru_cache(maxsize=None)
def state_in_shared(N: int, S: int, I: int, index: int) -> bool:
    """Whether one mapping's state fits card ``index``'s opt-in shared
    memory (the C entry's own rule, ``sim_loop_state_in_shared``, asked
    once per shape and card); when it does not, the kernel keeps the state
    in global scratch buffers."""
    fn = _build.load("sim_loop").sim_loop_state_in_shared
    fn.argtypes, fn.restype = _FITS_ARGS, ctypes.c_int
    rc = fn(N, S, I, index)
    if rc < 0:
        raise RuntimeError(f"sim_loop: reading the shared-memory limit of "
                           f"card {index} failed: CUDA error {-rc}")
    return rc == 1


def sim_loop_cuda(statics: Dict[str, torch.Tensor], iterations: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Run every cycle of the bucket ``statics`` (a tensor per key of
    :data:`STATICS`, of its dtype and shape, contiguous, on one CUDA
    device) for ``iterations`` iterations, in one launch.  Returns the
    state in the eager loop's layout: ``val`` (B, N + 2, I) float32,
    ``done`` (B, N + 2, I) bool and ``fail`` (B,) bool (rows N and N + 1
    hold nothing).  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when the launch
    is refused."""
    first = statics["ii"]
    if not first.is_cuda:
        raise ValueError(f"sim_loop_cuda needs CUDA tensors, got "
                         f"{first.device}")
    if statics["op_steps"].dim() != 4 or statics["step_src"].dim() != 2:
        raise ValueError("sim_loop_cuda: op_steps must be (B, N, K, M) and "
                         "step_src (B, S)")
    B, N, K, M = statics["op_steps"].shape
    dims = {"B": B, "N": N, "K": K, "M": M, "S": statics["step_src"].shape[1]}
    index = first.get_device()
    for name, (dtype, letters) in STATICS.items():
        t = statics[name]
        want = tuple(dims[c] for c in letters)
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"sim_loop_cuda: {name} lies on {t.device}, not "
                             f"{first.device}")
        if t.dtype is not dtype:
            raise ValueError(f"sim_loop_cuda: {name} is {t.dtype}, not "
                             f"{dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"sim_loop_cuda: {name} is {tuple(t.shape)}, "
                             f"not {want} ({letters})")
        if not t.is_contiguous():
            raise ValueError(f"sim_loop_cuda: {name} must be contiguous")
    I = int(iterations)
    if I < 1 or K < 3:
        raise ValueError(f"sim_loop_cuda takes iterations >= 1 and K >= 3 "
                         f"operand columns, got {I} and {K}")
    S = dims["S"]
    dev = first.device
    val = torch.empty((B, N + 2, I), dtype=torch.float32, device=dev)
    done = torch.empty((B, N + 2, I), dtype=torch.bool, device=dev)
    fail = torch.empty(B, dtype=torch.bool, device=dev)
    avail_ptr = stage_ptr = None  # scratch of the global-memory variant
    if not state_in_shared(N, S, I, index):
        avail = torch.empty((B, S + 2, I), dtype=torch.bool, device=dev)
        stage = torch.empty((B, 2 * N), dtype=torch.int32, device=dev)
        avail_ptr, stage_ptr = avail.data_ptr(), stage.data_ptr()
    _launch.launch("sim_loop", _ARGS, index,
                   *(statics[name].data_ptr() for name in STATICS),
                   val.data_ptr(), done.data_ptr(), avail_ptr,
                   fail.data_ptr(), stage_ptr, B, N, K, M, S, I)
    sim_loop_cuda.launches += 1
    return val, done, fail


#: kernel launches since the last reset (``sim_loop_cuda.launches = 0``)
sim_loop_cuda.launches = 0
