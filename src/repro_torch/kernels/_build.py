"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, then loaded with ``ctypes`` —
no PyTorch headers and no ``ninja``, so a build takes seconds.  Libraries
go to ``build/repro_torch/`` at the root of the checkout, named by a hash
of the source, the shared headers and the flags, so an edited source is
never served a stale library.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_KERNELS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_KERNELS, "csrc")
#: <checkout>/build/repro_torch (the package lives at <checkout>/src/repro_torch)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _KERNELS))), "build", "repro_torch")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path(name: str, csrc: str = CSRC,
                 build_dir: str = BUILD_DIR) -> str:
    """Where the library of ``<csrc>/<name>.cu`` goes: named by a hash of
    the source, every shared header (``*.cuh``) of ``csrc`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in [f"{name}.cu", *sorted(f for f in os.listdir(csrc)
                                     if f.endswith(".cuh"))]:
        with open(os.path.join(csrc, fn), "rb") as f:
            digest.update(fn.encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path.  nvcc's output (registers, shared memory and spills from
    ``-Xptxas=-v``) is kept beside it as ``<library>.log``.  Raises
    ``RuntimeError`` with that output on failure."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(f"{lib}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
