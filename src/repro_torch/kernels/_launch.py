"""What every kernel wrapper of the port shares: loading a library with its
C signature, launching on PyTorch's current stream and raising on a refused
launch; and, for the language-model kernels, checking operands.

A kernel's C entry is ``<name>_launch(..., void* stream)`` and returns
``cudaGetLastError()``; ``<name>_error_string(code)`` names the error.  The
language-model kernels take float32 or bfloat16, named by a dtype code
(:data:`DTYPE_CODES`) just before the stream.  Importing this module needs
no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build

#: the dtype code of the C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ready: Dict[str, ctypes.CDLL] = {}


def library(name: str, argtypes: Sequence) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its entry's signature
    (``argtypes`` excludes the trailing stream)."""
    if name in _ready:
        return _ready[name]
    lib = _build.load(name)
    entry = getattr(lib, f"{name}_launch")
    entry.argtypes = list(argtypes) + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _ready[name] = lib
    return lib


def check_operands(name: str, operands: Dict[str, torch.Tensor]) -> int:
    """Raise ``ValueError`` unless every operand lies on one CUDA device,
    is contiguous and has one dtype the kernel takes; returns its code."""
    first = next(iter(operands.values()))
    dev, dtype = first.device, first.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {dtype}")
    for arg, t in operands.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} lies on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return DTYPE_CODES[dtype]


def launch(name: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call ``<name>_launch(*args, stream)`` (C signature ``argtypes`` plus
    the stream) on ``device``'s current stream; raise ``RuntimeError`` if
    the launch was refused."""
    lib = library(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
