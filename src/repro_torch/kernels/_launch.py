"""What every kernel wrapper of the port shares: binding a library's C
entry once, launching on PyTorch's current stream and raising on a refused
launch; and, for the language-model kernels and ``motif_pcu``, checking
operands.

A kernel's C entry is ``<name>_launch(..., int device, void* stream)``: it
makes ``device`` current for the launch (``csrc/device_guard.cuh``) and
returns ``cudaGetLastError()``; ``<name>_error_string(code)`` names the
error.  The language-model kernels take float32 or bfloat16, named by a
dtype code (:data:`DTYPE_CODES`) just before the device.  The host path of
a launch is lean: the entry is resolved once, the checks build nothing per
call, and the stream is PyTorch's current raw stream for the device index.
Importing this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build, fake

#: the dtype code of the C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: each kernel's bound C entry and its error-string function
_entries: Dict[str, Tuple[Callable[..., int], Callable[[int], bytes]]] = {}


def entry(name: str, argtypes: Sequence, library: str = ""):
    """The C entry ``<name>_launch`` of ``csrc/<library>.cu`` (``library``
    defaults to ``name``; a backward entry lives beside its forward) and
    the library's ``<library>_error_string``, with their signatures set
    (``argtypes`` excludes the trailing device and stream); built, loaded
    and bound at first use, then cached."""
    bound = _entries.get(name)
    if bound is None:
        library = library or name
        lib = _build.load(library)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{library}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        bound = _entries[name] = (fn, err)
    return bound


def check_operands(name: str, names: Sequence[str],
                   *tensors) -> Tuple[int, int]:
    """Raise ``ValueError`` unless every tensor (called ``names[i]`` in the
    messages) lies on the first one's CUDA device, has its dtype, one the
    kernel takes, and is contiguous.  Per tensor, in order: device, dtype,
    contiguity.  Returns (dtype code, device index).  Fake tensors that
    stand for the card's (:func:`repro_torch.kernels.fake.modelled`) pass
    as CUDA tensors."""
    first = tensors[0]
    if not (first.is_cuda or fake.modelled(first)):
        raise ValueError(f"{name} needs CUDA tensors, got {first.device}")
    dtype = first.dtype
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"{name} takes float32 or bfloat16, got {dtype}")
    index = first.get_device()
    for i, t in enumerate(tensors):
        if not (t.is_cuda or fake.modelled(t)) or t.get_device() != index:
            raise ValueError(f"{name}: {names[i]} lies on {t.device}, not "
                             f"{first.device}")
        if t.dtype is not dtype:
            raise ValueError(f"{name}: {names[i]} is {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {names[i]} must be contiguous")
    return code, index


def launch(name: str, argtypes: Sequence, index: int, *args,
           library: str = "") -> None:
    """Call ``<name>_launch(*args, index, stream)`` (C signature
    ``argtypes`` plus the device and the stream, in ``csrc/<library>.cu``,
    by default ``<name>.cu``) on CUDA device ``index``'s current stream;
    raise ``RuntimeError`` if the launch was refused.  The stream is the
    lookup PyTorch's own Triton launcher makes: a raw handle, no
    ``torch.cuda.Stream`` object."""
    fn, err = _entries.get(name) or entry(name, argtypes, library)
    rc = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
