"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, in ordinary tensor
code that runs on any device.  The CPU path uses them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Nothing on the card's main path calls
them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.sim.lower import OPS


def _alu(code: int, a, b, c, leaf):
    op = OPS[code]
    if op in ("const", "input", "load"):
        return leaf
    if op in ("store", "output"):
        return a
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "mac":
        return a * b + c
    if op == "shl":
        return a * 2.0
    if op == "shr":
        return a / 2.0
    ai = a.to(torch.int32)
    bi = b.to(torch.int32)
    if op == "and":
        return (ai & bi).to(a.dtype)
    if op == "or":
        return (ai | bi).to(a.dtype)
    if op == "xor":
        return (ai ^ bi).to(a.dtype)
    if op == "not":
        return (~ai & 0xFFFF).to(a.dtype)
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    if op == "abs":
        return torch.abs(a)
    if op == "cmp":
        return (a > b).to(a.dtype)
    if op == "select":
        return torch.where(a != 0.0, b, c)
    raise ValueError(op)


def sim_alu(opcode, a, b, c, leaf):
    """Elementwise ``repro_torch.core.dfg._apply(OPS[opcode], a, b, c,
    leaf)`` over same-shape float32 tensors: the where-ladder of
    ``repro/sim/step.py::apply_ops_jnp``.  Opcodes outside
    ``[0, len(OPS))`` give 0.0."""
    out = torch.zeros_like(a)
    for code in range(len(OPS)):
        out = torch.where(opcode == code, _alu(code, a, b, c, leaf), out)
    return out


def rmsnorm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x**2) + eps) * scale`` over the last axis of (M, D)
    ``x``, in float32, cast to ``x.dtype`` once at the end
    (``repro/kernels/ref.py::rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def fused_swiglu(x, w1, w3):
    """``silu(x @ w1) * (x @ w3)`` for x (M, D), w1/w3 (D, F): both products
    and the gate in float32, cast to ``x.dtype`` once
    (``repro/kernels/ref.py::fused_swiglu``)."""
    a = x.float() @ w1.float()
    b = x.float() @ w3.float()
    return (torch.nn.functional.silu(a) * b).to(x.dtype)


NEG = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_group: int = 1):
    """Masked softmax attention over q (H, S, d) and k/v (H // kv_group, S,
    d) in float32, cast to ``q.dtype`` (``repro/kernels/ref.py::
    flash_attention``).  Query head h reads kv head ``h // kv_group``;
    ``kv_group=1`` is the reference's function.  Masked scores are -1e30."""
    H, S, d = q.shape
    k = k.float().repeat_interleave(kv_group, dim=0)
    v = v.float().repeat_interleave(kv_group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k) / math.sqrt(d)
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v).to(q.dtype)


def _int_op(fn):
    """A bitwise op of the PCU: both operands truncated toward zero to
    int32, the result converted back."""
    return lambda a, b: fn(a.to(torch.int32), b.to(torch.int32)).to(a.dtype)


#: the ops of the Plaid PCU (``repro/kernels/ref.py::PCU_OPS``); their order
#: numbers the opcodes of ``csrc/motif_pcu.cu``.  max/min propagate NaN.
PCU_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "max": torch.maximum,
    "min": torch.minimum,
    "and": _int_op(torch.bitwise_and),
    "or": _int_op(torch.bitwise_or),
    "xor": _int_op(torch.bitwise_xor),
    "shl": lambda a, b: a * 2.0,
    "shr": lambda a, b: a / 2.0,
}

#: a PCU schedule: steps ``(dst_slot, op, src_a, src_b)`` over a value table
#: whose first ``n_inputs`` slots hold the inputs
PcuSchedule = Sequence[Tuple[int, str, int, int]]


def motif_pcu(schedule: PcuSchedule, n_inputs: int, inputs):
    """Run ``schedule`` over inputs (n_inputs, N), the N loop iterations
    side by side; returns the value table (n_inputs + len(schedule), N).

    This is the function of the Pallas kernel ``repro/kernels/motif_pcu.py``:
    the inputs are cast to float32, every step runs in a float32 table whose
    slots start at zero (a slot read before it is written gives 0), and the
    whole table is cast to the inputs' dtype once at the end.  The JAX
    oracle ``repro/kernels/ref.py::motif_pcu`` computes in the inputs'
    dtype: the same in float32, but it rounds every step in bfloat16.
    No schedule checks here (:func:`repro_torch.kernels.motif_pcu.
    check_schedule` makes them)."""
    n_slots = n_inputs + len(schedule)
    table = torch.zeros((n_slots, inputs.shape[1]), dtype=torch.float32,
                        device=inputs.device)
    table[:n_inputs] = inputs.float()
    for dst, op, a, b in schedule:
        table[dst] = PCU_OPS[op](table[a], table[b])
    return table.to(inputs.dtype)
