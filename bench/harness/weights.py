"""The benchmark's weights, made on the device from ``--seed``: every
normal leaf of a dtype comes from one buffer filled by a few large calls
of one ``torch.Generator`` on the device, each leaf a view of it scaled to
N(0, 1 / fan-in) (the input width: ``shape[-2]`` of an ``(in, out)``
weight, stacked or per expert; the embedding's row width); norm scales are
1.  The same seed gives the same bits, so the reference draws the same
weights again after the program's state is freed."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements a call fills at most
CHUNK = 1 << 30
#: each leaf starts on a multiple of this many elements (16-byte aligned)
ALIGN = 64


def leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs of a nested dict in sorted-key order, paths
    joined with ``/``."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += leaves(val, f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", val))
    return out


def fan_in(spec) -> int:
    if tuple(spec.axes[-2:]) == ("vocab", "embed"):
        return spec.shape[-1]
    return spec.shape[-2] if len(spec.shape) > 1 else spec.shape[-1]


def make(spec_tree: Dict, seed: int, device) -> Dict:
    """A params tree shaped like ``spec_tree`` (the program's spec: each
    leaf's ``shape``, ``axes``, ``dtype`` and ``init``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    specs = leaves(spec_tree)
    normal: Dict[torch.dtype, List] = {}
    for path, s in specs:
        if s.init == "normal":
            normal.setdefault(s.dtype, []).append((path, s))
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted(normal, key=str):
        offsets, total = [], 0
        for path, s in normal[dtype]:
            offsets.append(total)
            total += -(-math.prod(s.shape) // ALIGN) * ALIGN
        buf = torch.empty(total, dtype=dtype, device=device)
        for a in range(0, total, CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen)
        for (path, s), off in zip(normal[dtype], offsets):
            view = buf[off:off + math.prod(s.shape)].view(s.shape)
            out[path] = view.mul_(1.0 / math.sqrt(fan_in(s)))
    for path, s in specs:
        if s.init == "ones":
            out[path] = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.init == "zeros":
            out[path] = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init != "normal":
            raise NotImplementedError(f"{path}: init {s.init!r}")
    tree: Dict = {}
    for path, _ in specs:
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = out[path]
    return tree
