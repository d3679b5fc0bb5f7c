"""Gradient compression, the port of ``repro/parallel/compression.py``:
int8 per-tensor symmetric quantize -> dequantize of each gradient leaf
before the optimizer (the numerics of an 8-bit wire format), with an
error-feedback variant whose residual re-injects the quantization error
at the next step.  One card has no cross-pod hop to shrink; the numerics
are what the port keeps.  Each function returns new tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.train.tree import tree_map


def compress_int8(g: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize ``g`` with one scale, max|g| / 127 (+1e-12);
    int32 and scalar leaves pass through."""
    if g.dtype == torch.int32 or g.dim() == 0:
        return g
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def compress_tree_int8(grads: Dict) -> Dict:
    return tree_map(compress_int8, grads)


def compress_with_feedback(grads: Dict, residual: Dict) -> Tuple[Dict, Dict]:
    """(compressed grads, new residual): each leaf plus its float32
    residual is quantized; what the quantization lost is the next
    residual."""
    def one(g, r):
        if g.dim() == 0:
            return g, r
        gf = g.float() + r
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        deq = q * scale
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, residual)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_residual(params: Dict) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
