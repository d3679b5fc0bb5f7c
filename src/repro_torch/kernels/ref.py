"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, in ordinary tensor
code that runs on any device.  The CPU path uses them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Nothing on the card's main path calls
them.
"""
from __future__ import annotations

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
