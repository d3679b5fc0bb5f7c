#!/usr/bin/env python3
"""The tuning choices of the two train-path backward kernels, each timed
against its neighbours on the card, and the flash backward against
another checkout's build.

    python3 scripts/bwd_design_probes.py [--other OTHER_ROOT]   # one card

``flash_attention_bwd`` at (96, 4096, 128) causal ``kv_group`` 3 in bf16
(``chip_smoke``'s train shape and seeds): the port's build of
``csrc/flash_attention.cu``, its ptxas registers and spills for the two
wgmma kernels at d 128.  With ``--other``, the same source of
``OTHER_ROOT`` (another checkout, for example the parent commit unpacked
with ``git archive``) is built with the port's flags beside it, its
registers printed too; its gradients are held bitwise against this
build's at the train shape, at each trained model's flash shape and at
``chip_smoke.BWD_SKIP_CASES``; and the two are timed in turns (other,
this, this, other; CUDA events and the profiler's device time, in all
and by kernel).

``rmsnorm_bwd`` at (16384, 3072) in bf16 (``chip_smoke``'s rows, RMS 0.1
to 10, and seeds) with ``BWD_MAX_BLOCKS`` 132 (the port's), 264 and 528:
dx held bitwise against the port's, dscale's largest difference printed
(its partial rows are summed in another grouping), then timed in turns;
then the port's against the backward of ``F.rms_norm`` there, in turns,
each with its device time.

Exit 0 whatever the times; 1 if a build fails or a gradient differs; 2
without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSNORM_BLOCKS = (132, 264, 528)
#: the trained models' flash backward shapes (H, S, d, kv_group) at batch
#: 4 x 4096, causal: granite, zamba2, whisper, qwen2_vl
MODEL_SHAPES = ((64, 4096, 64, 2), (128, 4096, 64, 1), (24, 4096, 64, 1),
                (256, 4096, 128, 8))


def build_other(root: str) -> str:
    """The library of ``<root>``'s ``csrc/flash_attention.cu`` built with
    the port's flags, beside the port's own builds, its nvcc output kept
    as ``<lib>.log``."""
    from repro_torch.kernels import _build

    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    lib = _build.library_path("flash_attention", csrc).replace(
        ".so", "-other.so")
    if not os.path.exists(lib):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = os.path.join(csrc, "flash_attention.cu")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               "-o", lib, src], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(f"{lib}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
    return lib


def wgmma_registers(log_path: str):
    """(kernel, registers, spill text) for the d-128 wgmma kernels in a
    build's ptxas output (``fwd``: the forward's two forms)."""
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
                name = next(k for k in ("dkdv", "dq", "fwd") if k in entry)
                out.append((name, int(m.group(1)), spill))
                entry = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout whose flash backward "
                    "is held bitwise against this one's and timed in turns")
    a = ap.parse_args(argv)
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

    with ThreadPoolExecutor(3) as pool:
        port = pool.submit(_build.build, "flash_attention")
        norm_lib = pool.submit(_build.build, "rmsnorm")
        other = pool.submit(build_other, os.path.abspath(a.other)) \
            if a.other else None
        libs = {"this": port.result()}
        norm_lib.result()
        if other is not None:
            libs["other"] = other.result()
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
    other = fr.bwd_entry(libs["other"]) if a.other else None

    def case(H, S, d, g, kw, seed):
        q = cs._randn((H, S, d), bf, seed)
        k, v = (cs._randn((H // g, S, d), bf, seed + i) for i in (1, 2))
        dout = cs._randn((H, S, d), bf, seed + 3)
        _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g,
                                             train=True, **kw)

        def flash(tag):
            def call():
                with fr.routed(other) if tag == "other" \
                        else contextlib.nullcontext():
                    return flash_attention_bwd_cuda(q, k, v, out32, dout,
                                                    lse, kv_group=g, **kw)
            return call
        return flash

    ok = True
    H, Hkv, d = 96, 32, 128
    g = H // Hkv
    train = case(H, T, d, g, dict(causal=True), 66)
    if a.other:
        shapes = [(H, T, d, g, dict(causal=True), 66)] + [
            (*sh, dict(causal=True), 70) for sh in MODEL_SHAPES] + [
            (*sh, 84) for sh in cs.BWD_SKIP_CASES]
        for sh in shapes:
            flash = case(*sh)
            same = all(torch.equal(u, w) for u, w in
                       zip(flash("other")(), flash("this")()))
            print(f"probe: flash backward {sh[:4]} {sh[4]}: this build's "
                  f"gradients {'equal to' if same else 'DIFFER from'} the "
                  f"other's, bitwise")
            ok &= same
    order = ["other", "this", "this", "other"] * 2 if a.other else \
        ["this"] * 2
    turns = {tag: [] for tag in libs}
    devs = {tag: [] for tag in libs}
    for tag in order:
        turns[tag].append(cs.cuda_ms(train(tag), 5))
        devs[tag].append(cs.device_ms(train(tag), 5, by_kernel=True))
    for tag in libs:
        total = [None if p is None else sum(p.values()) for p in devs[tag]]
        split = {}  # the turns' mean device ms of each kernel
        for p in devs[tag]:
            for key, ms in (p or {}).items():
                name = re.search(r"flash_bwd_\w+", key)
                name = name.group(0) if name else key[:40]
                split[name] = split.get(name, 0.0) + ms / len(devs[tag])
        print(f"probe: flash ({H},{T},{d}) causal kv_group {g} bf16, {tag}: "
              f"{sum(turns[tag]) / len(turns[tag]):.6f} ms (turns "
              f"{cs._turns_txt(turns[tag])}); device "
              f"{cs._device_txt(cs._mean(total))} (turns "
              f"{cs._turns_txt(total)})" + ("" if None in total else
                                            "; by kernel " + ", ".join(
                                                f"{k} {v:.6f} ms"
                                                for k, v in split.items())))

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
    # the yardstick: the backward of F.rms_norm alone, in turns with the
    # port's kernel, each with its device time from whole traces
    xs, ss = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xs, (D,), ss, 1e-6)
    calls = {"rmsnorm_bwd": norm(RMSNORM_BLOCKS[0]),
             "F.rms_norm backward": lambda: torch.autograd.grad(
                 y, (xs, ss), dy, retain_graph=True)}
    expect = {"rmsnorm_bwd": cs.BWD_KERNEL_NAMES["rmsnorm_bwd"],
              "F.rms_norm backward": cs.LIB_KERNEL_NAMES["rmsnorm_bwd"]}
    turns = {k: [] for k in calls}
    devs = {k: [] for k in calls}
    for _ in range(2):
        for k, call in calls.items():
            turns[k].append(cs.cuda_ms(call, 50))
            devs[k].append(cs.device_ms(call, 50, expect[k]))
    for k in calls:
        print(f"probe: {k} ({M},{D}) bf16: "
              f"{sum(turns[k]) / len(turns[k]):.6f} ms (turns "
              f"{cs._turns_txt(turns[k])}); "
              f"{cs._device_txt(cs._mean(devs[k]))} (turns "
              f"{cs._turns_txt(devs[k])})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
