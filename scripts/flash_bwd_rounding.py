#!/usr/bin/env python3
"""Whether the tensor-core flash backward needs P and dS split into a bf16
value and its bf16 remainder: the train shape's gradients of four
backward forms held against the plain gradient under
``chip_smoke.PATH_TOL``, each timed.

    python3 scripts/flash_bwd_rounding.py      # on one card

At (96, 4096, 128) causal ``kv_group`` 3 in bf16 (``chip_smoke``'s train
shape and seeds), with the plain gradient autograd of
``ref.flash_attention`` in float32:

- ``split``: ``csrc/flash_attention.cu`` as built by the port (the
  products of P and dS run on the rounded value and on its remainder);
- ``single``: the same source built with ``-DFLASH_BWD_SPLIT=0`` (P and dS
  rounded to bf16 once, as cuDNN and FlashAttention-2 round them), delta
  from the training forward's float32 output;
- ``single, bf16 o``: the single build with delta from the bf16 output,
  the standard design throughout;
- ``sdpa``: the backward of ``F.scaled_dot_product_attention``.

Prints, per form and gradient, the largest share of the tolerance
(``|got - want| / (atol + rtol |want|)``, 1.0 at the edge), the elements
past it and the relative L2 error, then each form's time (CUDA events, in
turns).  Exit 0 whatever the shares; 2 without a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_OFF = "-DFLASH_BWD_SPLIT=0"


def build_single() -> str:
    """The library of ``csrc/flash_attention.cu`` built with
    :data:`SPLIT_OFF`, beside the port's own builds."""
    from repro_torch.kernels import _build

    lib = _build.library_path("flash_attention").replace(
        ".so", "-single.so")
    if not os.path.exists(lib):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = os.path.join(_build.CSRC, "flash_attention.cu")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               SPLIT_OFF, "-o", lib, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SPLIT_OFF} failed:\n{proc.stderr}")
    return lib


def bwd_entry(path: str):
    """The ``flash_attention_bwd`` entry and error string of the library at
    ``path``, bound as ``_launch.entry`` binds the port's."""
    from repro_torch.kernels.flash_attention import _BWD_ARGS

    lib = ctypes.CDLL(path)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = list(_BWD_ARGS) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


@contextlib.contextmanager
def routed(bound):
    """``flash_attention_bwd_cuda`` launching ``bound`` (an entry from
    :func:`bwd_entry`; the wrapper's checks, buffers and launch stay the
    port's)."""
    from repro_torch.kernels import _launch

    saved = _launch._entries.get("flash_attention_bwd")
    _launch._entries["flash_attention_bwd"] = bound
    try:
        yield
    finally:
        if saved is None:
            _launch._entries.pop("flash_attention_bwd")
        else:
            _launch._entries["flash_attention_bwd"] = saved


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    with ThreadPoolExecutor(2) as pool:
        single = pool.submit(build_single)
        pool.submit(_build.build, "flash_attention").result()
        single = single.result()

    bf = torch.bfloat16
    B, T = cs.TRAIN_SHAPE
    H, Hkv, d = 96, 32, 128
    g = H // Hkv
    q = cs._randn((H, T, d), bf, 66)
    k, v = (cs._randn((Hkv, T, d), bf, i) for i in (67, 68))
    dout = cs._randn((H, T, d), bf, 69)
    out, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True)
    out_bf = out.float()
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_sdpa = F.scaled_dot_product_attention(
        ql[None], kl[None], vl[None], is_causal=True, enable_gqa=True)[0]

    single = bwd_entry(single)

    def ours(o32, bound=None):
        def call():
            with routed(bound) if bound else contextlib.nullcontext():
                return flash_attention_bwd_cuda(q, k, v, o32, dout, lse,
                                                kv_group=g)
        return call

    forms = {
        "split": ours(out32),
        "single": ours(out32, single),
        "single, bf16 o": ours(out_bf, single),
        "sdpa": lambda: torch.autograd.grad(y_sdpa, (ql, kl, vl), dout,
                                            retain_graph=True),
    }
    want = cs._flash_plain_grads(q, k, v, dout, g, dict(causal=True))
    tol = cs.PATH_TOL
    print(f"flash backward at ({H},{T},{d}) causal kv_group {g} bf16 on "
          f"{torch.cuda.get_device_name(0)}, against autograd of "
          f"ref.flash_attention; tolerance rtol {tol['rtol']} atol "
          f"{tol['atol']}")
    for name, call in forms.items():
        got = call()
        for gname, u, w in zip(("dq", "dk", "dv"), got, want):
            diff = (u.float() - w.float()).abs()
            limit = tol["atol"] + tol["rtol"] * w.float().abs()
            share = (diff / limit).max().item()
            past = int((diff > limit).sum())
            rel = (diff.norm() / w.float().norm()).item()
            print(f"rounding: {name}: {gname} {share:.4f} of the tolerance, "
                  f"{past} of {diff.numel()} elements past it, relative L2 "
                  f"{rel:.4g}, max abs diff {diff.max().item():.6g}")
        del got
    turns = {name: [] for name in forms}
    for _ in range(2):
        for name, call in forms.items():
            turns[name].append(cs.cuda_ms(call, 5))
    for name, ms in turns.items():
        print(f"rounding: {name}: {sum(ms) / len(ms):.6f} ms (turns "
              f"{' / '.join(f'{t:.6f}' for t in ms)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
