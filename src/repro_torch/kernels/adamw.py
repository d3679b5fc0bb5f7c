"""AdamW as two hand-written CUDA kernels over many leaves a launch: the
global norm of the gradients, and one fused update pass.

Replaces no TPU kernel: it takes the place, on the card, of the plain loop
of :func:`repro_torch.train.optimizer.apply_updates` (a stacked leaf one
layer slice at a time, about 27 aten launches a slice), and computes the
same function.  The source is ``csrc/adamw.cu`` (design and bound are
documented there), built at first use (:mod:`repro_torch.kernels._build`)
and launched through ``ctypes`` on PyTorch's current stream.

The optimizer routes by device alone, as :mod:`repro_torch.kernels.ops`
does: CPU tensors take its loop, CUDA tensors (or fake tensors that stand
for the card's, :mod:`repro_torch.kernels.fake`) these kernels, which
raise ``ValueError`` for any tensor they cannot take (not on the call's
one CUDA device, not contiguous, neither float32 nor bfloat16).
:func:`global_norm_cuda` writes the float32 norm and the clip scale into
one scratch tensor; :func:`adamw_update_cuda` updates parameters and
moments in place, one launch per combination of the three roles' dtypes,
reading lr, the bias corrections and the scale from float32 device
scalars (no host sync).  With the same scale the update is the loop's bit
for bit; the norm differs from the loop's only in the order of its sum,
and is the same bits on every run.  Importing this module needs no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _launch, cost, fake

#: elements a block of either pass (the C side's ``kChunk``): the norm
#: writes one partial sum per chunk of a leaf
CHUNK = 32768
#: leaves a launch's table holds (the C side's ``kMaxLeaves``); a call with
#: more launches once per table inside its one C entry call
MAX_LEAVES = 32

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_LONGS = ctypes.POINTER(ctypes.c_longlong)
#: the norm's C entry (``adamw_norm_launch``): g, n, dtype codes, count,
#: scratch, partials, grad_clip (then the device and the stream)
_NORM_ARGS = [_PTRS, _LONGS, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float]
#: the update's C entry (``adamw_launch``): p, g, m, v, n, count, lr,
#: bc1, bc2, scale, b1, 1 - b1, b2, 1 - b2, eps, weight decay, the dtype
#: codes of params, grads and state (then the device and the stream)
_ARGS = [_PTRS] * 4 + [_LONGS, ctypes.c_int] + \
    [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_int] * 3


def partials(grads: Sequence[torch.Tensor]) -> int:
    """The norm's partial sums for ``grads``: one per chunk of
    :data:`CHUNK` elements of each leaf (an empty leaf has none)."""
    return sum(-(-g.numel() // CHUNK) for g in grads)


def _check(name: str, tensors: Sequence[torch.Tensor]) -> int:
    """The CUDA device index of ``tensors``, or ``ValueError`` unless they
    all lie on one CUDA device (or are fakes standing for the card's), are
    contiguous and are float32 or bfloat16."""
    if not tensors:
        raise ValueError(f"{name} takes at least one leaf")
    index = tensors[0].get_device()
    if not all((t.is_cuda or fake.modelled(t)) and t.get_device() == index
               and t.dtype in _launch.DTYPE_CODES and t.is_contiguous()
               for t in tensors):
        raise ValueError(f"{name} takes contiguous float32 or bfloat16 "
                         "tensors on one CUDA device")
    return index


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _numels(tensors) -> ctypes.Array:
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def global_norm_cuda(grads: Sequence[torch.Tensor],
                     grad_clip: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the norm over the leaves ``grads`` (float32 or bfloat16 each,
    contiguous, on one CUDA device): returns float32 0-d tensors (the
    global norm, the clip scale ``min(grad_clip / max(norm, 1e-9), 1)``,
    or 1 when ``grad_clip`` is 0), views of the one scratch tensor the
    call allocates (its partial sums, then those two).  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when the launch
    is refused."""
    dev = _check("adamw_norm", grads)
    n = partials(grads)
    scratch = torch.empty(n + 2, dtype=torch.float32, device=grads[0].device)
    norm, scale = scratch[n], scratch[n + 1]
    if fake.modelled(grads[0]):
        fake.record("adamw_norm", cost.adamw_norm(
            sum(g.numel() for g in grads),
            sum(g.numel() * g.element_size() for g in grads)))
        return norm, scale
    codes = (ctypes.c_int * len(grads))(
        *(_launch.DTYPE_CODES[g.dtype] for g in grads))
    _launch.launch("adamw_norm", _NORM_ARGS, dev, _ptrs(grads),
                   _numels(grads), codes, len(grads), scratch.data_ptr(), n,
                   grad_clip, library="adamw")
    global_norm_cuda.launches += 1
    return norm, scale


#: C entry calls since the last reset (``global_norm_cuda.launches = 0``)
global_norm_cuda.launches = 0


def adamw_update_cuda(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                      scale: torch.Tensor, cfg) -> None:
    """One AdamW step in place over the leaves ``params``, ``grads`` and
    the moments ``ms``, ``vs`` (same shapes leaf by leaf; each role float32
    or bfloat16, contiguous, all on one CUDA device), with the float32 0-d
    device scalars ``lr``, ``bc1``, ``bc2`` (the bias corrections) and
    ``scale`` (the clip scale) and ``cfg``'s ``b1``, ``b2``, ``eps`` and
    ``weight_decay``: one launch per combination of the leaves' (param,
    grad, state) dtypes, in the order they first appear.  Raises
    ``ValueError`` on any other input and ``RuntimeError`` when a launch
    is refused."""
    scalars = (lr, bc1, bc2, scale)
    dev = _check("adamw_update", [*params, *grads, *ms, *vs, *scalars])
    if not len(params) == len(grads) == len(ms) == len(vs) or any(
            not p.shape == g.shape == m.shape == v.shape
            for p, g, m, v in zip(params, grads, ms, vs)):
        raise ValueError("adamw_update takes params, grads and moments of "
                         "the same shapes, leaf by leaf")
    if any(s.dtype != torch.float32 or s.numel() != 1 for s in scalars):
        raise ValueError("adamw_update takes lr, bc1, bc2 and scale as "
                         "float32 scalars")
    groups: Dict[Tuple[torch.dtype, ...], List[Tuple]] = {}
    for p, g, m, v in zip(params, grads, ms, vs):
        if m.dtype != v.dtype:
            raise ValueError(f"adamw_update: m is {m.dtype}, v {v.dtype}")
        groups.setdefault((p.dtype, g.dtype, m.dtype), []).append(
            (p, g, m, v))
    for (pd, gd, sd), group in groups.items():
        p, g, m, v = zip(*group)
        if fake.modelled(p[0]):
            fake.record("adamw", cost.adamw(
                sum(t.numel() for t in p), p[0].element_size(),
                g[0].element_size(), m[0].element_size()))
            continue
        _launch.launch(
            "adamw", _ARGS, dev, _ptrs(p), _ptrs(g), _ptrs(m), _ptrs(v),
            _numels(p), len(p), *(s.data_ptr() for s in scalars), cfg.b1,
            1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
            _launch.DTYPE_CODES[pd], _launch.DTYPE_CODES[gd],
            _launch.DTYPE_CODES[sd])
        adamw_update_cuda.launches += 1


#: C entry calls since the last reset (``adamw_update_cuda.launches = 0``)
adamw_update_cuda.launches = 0
