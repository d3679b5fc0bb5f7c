#!/usr/bin/env python3
"""The tuning choices of the two train-path backward kernels, each timed
against its neighbours on the card.

    python3 scripts/bwd_design_probes.py      # on one card

``flash_attention_bwd`` at (96, 4096, 128) causal ``kv_group`` 3 in bf16
(``chip_smoke``'s train shape and seeds), ``csrc/flash_attention.cu``
built four ways:

- ``lead 1``: the port's build (a stage refilled one tile after its use);
- ``lead 2``, ``lead 3``: built with ``-DFLASH_BWD_WG_LEAD=2`` / ``3``;
- ``bound 384``: built with ``-DFLASH_BWD_WG_BOUND=384``, so ptxas sizes
  the wgmma kernels' registers for a 384-thread block (65536 / 384 a
  thread), the block of a producer warpgroup beside the two consumers,
  without ``setmaxnreg``; the launch stays 256 threads.

Prints each build's ptxas registers and spills for the two wgmma kernels
at d 128, holds every build's gradients bitwise against the port's, and
times them in turns (CUDA events).

``rmsnorm_bwd`` at (16384, 3072) in bf16 (``chip_smoke``'s rows, RMS 0.1
to 10, and seeds) with ``BWD_MAX_BLOCKS`` 132 (the port's), 264 and 528:
dx held bitwise against the port's, dscale's largest difference printed
(its partial rows are summed in another grouping), then timed in turns.

Exit 0 whatever the times; 1 if a build fails or a gradient differs; 2
without a card.
"""
from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build tag -> the extra nvcc flags of that build of flash_attention.cu
FLASH_BUILDS = {"lead 2": ("-DFLASH_BWD_WG_LEAD=2",),
                "lead 3": ("-DFLASH_BWD_WG_LEAD=3",),
                "bound 384": ("-DFLASH_BWD_WG_BOUND=384",)}
RMSNORM_BLOCKS = (132, 264, 528)


def build_variant(tag: str, flags) -> str:
    """The library of ``csrc/flash_attention.cu`` built with ``flags``,
    beside the port's own builds, its nvcc output kept as ``<lib>.log``."""
    from repro_torch.kernels import _build

    lib = _build.library_path("flash_attention").replace(
        ".so", "-" + tag.replace(" ", "") + ".so")
    if not os.path.exists(lib):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = os.path.join(_build.CSRC, "flash_attention.cu")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               *flags, "-o", lib, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {' '.join(flags)} failed:\n"
                               f"{proc.stderr}")
        with open(f"{lib}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
    return lib


def wgmma_registers(log_path: str):
    """(kernel, registers, spill text) for the d-128 wgmma kernels in a
    build's ptxas output."""
    out, entry, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or "wgmma_kernel" not in entry \
                    or "ILi128E" not in entry:
                continue
            if "spill" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                name = "dkdv" if "dkdv" in entry else "dq"
                out.append((name, int(m.group(1)), spill))
                entry = None
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import flash_bwd_rounding as fr
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    with ThreadPoolExecutor(len(FLASH_BUILDS) + 2) as pool:
        port = pool.submit(_build.build, "flash_attention")
        pool.submit(_build.build, "rmsnorm").result()
        libs = {tag: pool.submit(build_variant, tag, flags)
                for tag, flags in FLASH_BUILDS.items()}
        libs = {"lead 1": port.result(),
                **{tag: f.result() for tag, f in libs.items()}}
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"probes on {name} ({smi})")
    for tag, lib in libs.items():
        for kern, regs, spill in wgmma_registers(f"{lib}.log"):
            print(f"probe: flash {tag}: {kern} wgmma d 128: {regs} "
                  f"registers; {spill}")

    bf = torch.bfloat16
    B, T = cs.TRAIN_SHAPE
    H, Hkv, d = 96, 32, 128
    g = H // Hkv
    q = cs._randn((H, T, d), bf, 66)
    k, v = (cs._randn((Hkv, T, d), bf, i) for i in (67, 68))
    dout = cs._randn((H, T, d), bf, 69)
    _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True)
    bound = {tag: fr.bwd_entry(lib) for tag, lib in libs.items()}

    def flash(tag):
        def call():
            ctx = contextlib.nullcontext() if tag == "lead 1" \
                else fr.routed(bound[tag])
            with ctx:
                return flash_attention_bwd_cuda(q, k, v, out32, dout, lse,
                                                kv_group=g)
        return call

    ok = True
    want = flash("lead 1")()
    for tag in FLASH_BUILDS:
        same = all(torch.equal(u, w) for u, w in zip(flash(tag)(), want))
        print(f"probe: flash {tag}: gradients "
              f"{'equal to' if same else 'DIFFER from'} lead 1's, bitwise")
        ok &= same
    del want
    turns = {tag: [] for tag in libs}
    for _ in range(2):
        for tag in libs:
            turns[tag].append(cs.cuda_ms(flash(tag), 5))
    for tag, ms in turns.items():
        print(f"probe: flash ({H},{T},{d}) causal kv_group {g} bf16, {tag}: "
              f"{sum(ms) / len(ms):.6f} ms (turns "
              f"{' / '.join(f'{t:.6f}' for t in ms)})")

    M, D = B * T, 3072
    x = cs._randn((M, D), bf, 60, np.geomspace(0.1, 10.0, M)[:, None])
    s, dy = cs._randn((D,), bf, 61), cs._randn((M, D), bf, 62)

    def norm(blocks):
        def call():
            saved = rn.BWD_MAX_BLOCKS
            rn.BWD_MAX_BLOCKS = blocks
            try:
                return rn.rmsnorm_bwd_cuda(x, s, dy)
            finally:
                rn.BWD_MAX_BLOCKS = saved
        return call

    dx0, ds0 = norm(RMSNORM_BLOCKS[0])()
    for blocks in RMSNORM_BLOCKS[1:]:
        dx, ds = norm(blocks)()
        same = torch.equal(dx, dx0)
        diff = (ds.float() - ds0.float()).abs().max().item()
        print(f"probe: rmsnorm_bwd {blocks} blocks: dx "
              f"{'equal to' if same else 'DIFFERS from'} 132 blocks', "
              f"bitwise; dscale max abs diff {diff:.6g}")
        ok &= same
    turns = {b: [] for b in RMSNORM_BLOCKS}
    for _ in range(2):
        for b in RMSNORM_BLOCKS:
            turns[b].append(cs.cuda_ms(norm(b), 50))
    for b, ms in turns.items():
        print(f"probe: rmsnorm_bwd ({M},{D}) bf16, {b} blocks: "
              f"{sum(ms) / len(ms):.6f} ms (turns "
              f"{' / '.join(f'{t:.6f}' for t in ms)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
