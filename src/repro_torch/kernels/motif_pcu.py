"""The Plaid PCU running a motif schedule, as a hand-written CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/motif_pcu.py::motif_pcu``: a
static schedule of ``(dst, op, a, b)`` steps runs over a value table whose
first ``n_inputs`` slots hold the inputs, for N loop iterations side by
side, with the table kept on chip.  The source is ``csrc/motif_pcu.cu``
(design, bound and op semantics are documented there), built at first use
(:mod:`repro_torch.kernels._build`) and launched through ``ctypes`` on
PyTorch's current stream.

:func:`motif_pcu` is the wrapper: it checks the schedule, then a CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.motif_pcu`) and a
CUDA tensor launches the kernel or raises.  Importing this module needs no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _launch, ref

#: the opcode of each op in the C entry: its place in ``ref.PCU_OPS``
OPCODES = {name: code for code, name in enumerate(ref.PCU_OPS)}
#: the most slots (``n_inputs + len(schedule)``) one block's 232,448 bytes
#: of shared memory hold at the kernel's 256 threads: 223 x 256 x 4 bytes of
#: table plus 223 x 16 bytes of schedule is 231,920 bytes
MAX_SLOTS = 223
#: in, schedule, out, steps, n_inputs, N, dtype code (then the device and
#: the stream)
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                      ctypes.c_int]

# the canonical three-motif schedules (slots 0..2 = inputs a, b, c), as in
# repro/kernels/motif_pcu.py
FANIN = ((3, "mul", 0, 1), (4, "mul", 1, 2), (5, "add", 3, 4))
FANOUT = ((3, "add", 0, 1), (4, "mul", 3, 2), (5, "sub", 3, 0))
UNICAST = ((3, "mul", 0, 1), (4, "add", 3, 2), (5, "max", 4, 0))


def check_schedule(schedule: ref.PcuSchedule, n_inputs: int,
                   inputs: torch.Tensor) -> Tuple[Tuple[int, str, int, int],
                                                  ...]:
    """Raise ``ValueError`` unless ``inputs`` is (n_inputs, N) with N >= 1
    and every step ``(dst, op, a, b)`` has ``0 <= a, b < dst < n_slots``
    and ``op`` in ``PCU_OPS`` (the asserts of the Pallas wrapper, plus the
    lower bound that keeps the kernel's indices inside its table).  Returns
    the schedule as a tuple of tuples."""
    if inputs.dim() != 2 or inputs.shape[0] != n_inputs or \
            inputs.shape[1] < 1:
        raise ValueError(f"motif_pcu takes inputs (n_inputs={n_inputs}, N) "
                         f"with N >= 1, got {tuple(inputs.shape)}")
    steps = tuple((int(dst), op, int(a), int(b))
                  for dst, op, a, b in schedule)
    n_slots = n_inputs + len(steps)
    for dst, op, a, b in steps:
        if not (dst < n_slots and 0 <= a < dst and 0 <= b < dst):
            raise ValueError(f"motif_pcu step {(dst, op, a, b)}: need "
                             f"0 <= a, b < dst < n_slots = {n_slots}")
        if op not in ref.PCU_OPS:
            raise ValueError(f"motif_pcu step {(dst, op, a, b)}: op must be "
                             f"one of {sorted(ref.PCU_OPS)}")
    return steps


@functools.lru_cache(maxsize=64)
def _device_schedule(steps, device: torch.device) -> torch.Tensor:
    """The int32 (steps, 4) rows (dst, opcode, a, b) on ``device``, copied
    from the host once per schedule and device."""
    rows = [(dst, OPCODES[op], a, b) for dst, op, a, b in steps]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device)


def motif_pcu_cuda(schedule: ref.PcuSchedule, n_inputs: int,
                   inputs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``inputs`` (n_inputs, N) float32 or bfloat16,
    contiguous, on a CUDA device, and a schedule of at most
    ``MAX_SLOTS - n_inputs`` steps.  Returns a new (n_inputs +
    len(schedule), N) tensor of the inputs' dtype.  Raises ``ValueError`` on
    any other input and ``RuntimeError`` when the launch is refused."""
    steps = check_schedule(schedule, n_inputs, inputs)
    code, dev = _launch.check_operands("motif_pcu", ("inputs",), inputs)
    n_slots = n_inputs + len(steps)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"motif_pcu: {n_slots} slots exceed the kernel's "
                         f"{MAX_SLOTS} (one block's shared memory)")
    out = torch.empty((n_slots, inputs.shape[1]), dtype=inputs.dtype,
                      device=inputs.device)
    rows = _device_schedule(steps, inputs.device)
    _launch.launch("motif_pcu", _ARGS, dev, inputs.data_ptr(),
                   rows.data_ptr(), out.data_ptr(), len(steps), n_inputs,
                   inputs.shape[1], code)
    motif_pcu_cuda.launches += 1
    return out


#: kernel launches since the last reset (``motif_pcu_cuda.launches = 0``)
motif_pcu_cuda.launches = 0


def motif_pcu(schedule: ref.PcuSchedule, n_inputs: int,
              inputs: torch.Tensor) -> torch.Tensor:
    """The value table (n_inputs + len(schedule), N) of ``schedule`` over
    inputs (n_inputs, N): the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors.  Raises ``ValueError`` on a bad schedule either way."""
    if inputs.is_cpu:
        return ref.motif_pcu(check_schedule(schedule, n_inputs, inputs),
                             n_inputs, inputs)
    return motif_pcu_cuda(schedule, n_inputs, inputs)


#: a bound on |op(x, y)| from bounds on |x| and |y|; |x & y|, |x | y| and
#: |x ^ y| stay below 2 * max(|x|, |y|) + 1
_GROWTH = {"add": lambda x, y: x + y, "sub": lambda x, y: x + y,
           "mul": lambda x, y: x * y, "max": max, "min": max,
           "and": lambda x, y: 2 * max(x, y) + 1,
           "or": lambda x, y: 2 * max(x, y) + 1,
           "xor": lambda x, y: 2 * max(x, y) + 1,
           "shl": lambda x, y: 2 * x, "shr": lambda x, y: x / 2}


def random_schedule(seed: int, n_inputs: int = 3, steps: int = 64,
                    input_bound: float = 100.0):
    """A valid schedule of ``steps`` steps (at least 13) over all ten ops,
    drawn from numpy seed ``seed``, for inputs in [-input_bound,
    input_bound].  It writes an input slot (dst 2), reads a slot before it
    is written and writes one slot twice.  Whatever the inputs in that
    range, every value stays below 1e30 in magnitude and the bitwise ops
    only see values inside int32: a bound on each slot's magnitude is
    carried through the steps, and operands that would break it are drawn
    again (slot 0, an input that no step can write, always fits)."""
    if n_inputs < 3 or steps < 13:
        raise ValueError("random_schedule needs n_inputs >= 3, steps >= 13")
    rng = np.random.default_rng(seed)
    n_slots = n_inputs + steps
    bound = [input_bound] * n_inputs + [0.0] * steps
    ops = list(ref.PCU_OPS) + [str(o) for o in rng.choice(
        list(ref.PCU_OPS), steps - len(ref.PCU_OPS))]
    rng.shuffle(ops)
    # (dst, a) fixed at four steps, None = drawn: dst 2 is an input slot,
    # slot n_slots - 2 is read at step 1 and written at step 2, and slot
    # n_slots - 1 is written at steps 1 and steps - 1
    fixed = {0: (2, 0), 1: (n_slots - 1, n_slots - 2),
             2: (n_slots - 2, None), steps - 1: (n_slots - 1, None)}
    sched = []
    for k, op in enumerate(ops):
        dst, a = fixed.get(k, (None, None))
        while True:
            d = dst if dst is not None else int(rng.integers(1, n_slots))
            x = a if a is not None else int(rng.integers(0, d))
            y = int(rng.integers(0, d))
            new = _GROWTH[op](bound[x], bound[y])
            if new < (2.0 ** 31 if op in ("and", "or", "xor") else 1e30):
                break
        bound[d] = new
        sched.append((d, op, x, y))
    return tuple(sched)
