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
and by kernel).  Each build runs on its own checkout's route rule
(``bwd_route`` of its ``flash_attention.py``); a shape the two rules send
to different routes is held against the plain gradient instead of
bitwise.  ``--shape H,S,d,kv_group[,window=W]`` (repeatable, causal)
takes the place of the train shape in the timed turns, and each such
shape is also printed with both builds' largest difference from the plain
gradient (autograd of ``ref.flash_attention``, ``PLAIN_FLASH_HEADS`` query
heads at a time), the plain version's time, the bound and the design
floor (``chip_smoke.flash_bwd_products``) and the device time of SDPA's
backward on the same inputs (k and v repeated to the query heads, a
boolean mask where a window is set; the kernels it runs are named), and
the ``rmsnorm_bwd`` probes below are left out.

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
    """(kernel, registers, spill text) for the wgmma kernels in a build's
    ptxas output, by head dim (``fwd``: the forward's two forms)."""
    out, entry, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or "wgmma_kernel" not in entry:
                continue
            if "spill" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                name = next(k for k in ("dkdv_split", "dkdv", "dq", "fwd")
                            if k in entry)
                dp = re.search(r"ILi(\d+)E", entry).group(1)
                out.append((f"{name} d {dp}", int(m.group(1)), spill))
                entry = None
    return out


@contextlib.contextmanager
def routed_rule(rule):
    """``flash_attention_bwd_cuda`` on the route rule ``rule`` (another
    checkout's ``bwd_route``)."""
    from repro_torch.kernels import flash_attention as fa

    saved = fa.bwd_route
    fa.bwd_route = rule
    try:
        yield
    finally:
        fa.bwd_route = saved


def parse_shape(text: str):
    """``H,S,d,kv_group[,window=W]`` as (H, S, d, kv_group, mask)."""
    parts = text.split(",")
    H, S, d, g = (int(p) for p in parts[:4])
    kw = dict(causal=True)
    for p in parts[4:]:
        if not p.startswith("window="):
            raise argparse.ArgumentTypeError(f"unknown shape field {p!r}")
        kw["window"] = int(p.split("=", 1)[1])
    return H, S, d, g, kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout whose flash backward "
                    "is held bitwise against this one's and timed in turns")
    ap.add_argument("--shape", action="append", type=parse_shape,
                    help="H,S,d,kv_group[,window=W] (repeatable)")
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
    import fwd_design_probes as fp
    from repro_torch.kernels import _build, cost
    from repro_torch.kernels import flash_attention as fa
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
            print(f"probe: flash {tag}: {kern} wgmma: {regs} registers; "
                  f"{spill}")

    bf = torch.bfloat16
    B, T = cs.TRAIN_SHAPE
    other = fr.bwd_entry(libs["other"]) if a.other else None
    other_rule = fp.route_rules(os.path.abspath(a.other)).bwd_route \
        if a.other else fa.bwd_route

    def case(H, S, d, g, kw, seed):
        q = cs._randn((H, S, d), bf, seed)
        k, v = (cs._randn((H // g, S, d), bf, seed + i) for i in (1, 2))
        dout = cs._randn((H, S, d), bf, seed + 3)
        _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g,
                                             train=True, **kw)

        def flash(tag):
            def call():
                if tag != "other":
                    return flash_attention_bwd_cuda(q, k, v, out32, dout,
                                                    lse, kv_group=g, **kw)
                with fr.routed(other), routed_rule(other_rule):
                    return flash_attention_bwd_cuda(q, k, v, out32, dout,
                                                    lse, kv_group=g, **kw)
            return call
        flash.inputs = (q, k, v, dout)
        return flash

    ok = True
    H, Hkv, d = 96, 32, 128
    g = H // Hkv
    if a.other:
        shapes = [(H, T, d, g, dict(causal=True), 66)] + [
            (*sh, dict(causal=True), 70) for sh in MODEL_SHAPES] + [
            (*sh, 84) for sh in cs.BWD_SKIP_CASES]
        for sh in shapes:
            routes = (other_rule(bf, sh[2]), fa.bwd_route(bf, sh[2]))
            if routes[0] != routes[1]:
                print(f"probe: flash backward {sh[:4]} {sh[4]}: routes "
                      f"{fa.ROUTE_NAMES[routes[0]]} (other) and "
                      f"{fa.ROUTE_NAMES[routes[1]]} (this) differ: held "
                      f"against plain, not bitwise")
                continue
            flash = case(*sh)
            same = all(torch.equal(u, w) for u, w in
                       zip(flash("other")(), flash("this")()))
            print(f"probe: flash backward {sh[:4]} {sh[4]}: this build's "
                  f"gradients {'equal to' if same else 'DIFFER from'} the "
                  f"other's, bitwise")
            ok &= same
            del flash
    timed = a.shape or [(H, T, d, g, dict(causal=True))]
    order = ["other", "this", "this", "other"] * 2 if a.other else \
        ["this"] * 2
    for H, S, d, g, kw in timed:
        flash = case(H, S, d, g, kw, 66)
        label = (f"({H},{S},{d}) causal"
                 f"{' window ' + str(kw['window']) if 'window' in kw else ''}"
                 f" kv_group {g} bf16")
        if a.shape:
            q, k, v, dout = flash.inputs
            want = cs._flash_plain_grads(q, k, v, dout, g, kw)
            for tag in libs:
                errs = [(u.float() - w.float()).abs().max().item()
                        for u, w in zip(flash(tag)(), want)]
                print(f"probe: flash backward {label}, {tag} build (route "
                      f"{fa.ROUTE_NAMES[(other_rule if tag == 'other' else fa.bwd_route)(bf, d)]}"
                      f"): max abs err vs plain dq {errs[0]:.6g}, dk "
                      f"{errs[1]:.6g}, dv {errs[2]:.6g}")
            del want
            p_ms = cs.cuda_ms(lambda: cs._flash_plain_grads(
                q, k, v, dout, g, kw), 1)
            ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
            y = fp.sdpa_call(ql, kl, vl, g, kw.get("window", 0))()
            lib = lambda: torch.autograd.grad(  # noqa: E731
                y, (ql, kl, vl), dout, retain_graph=True)
            l_dev = [cs.device_ms(lib, 3) for _ in range(2)]
            names = sorted(n[:60] for n in cs._traced_names(lib, ()))
            bound, by = cs._bound(*cost.flash_attention_bwd(
                H, H // g, S, d, 2, **kw))
            print(f"probe: flash backward {label}: plain {p_ms:.6f} ms; "
                  f"bound {bound:.6f} ms ({by}); design floor "
                  f"{bound * cs.flash_bwd_products(d) / 5:.6f} ms "
                  f"({cs.flash_bwd_products(d)} products); SDPA backward "
                  f"device {cs._turns_txt(l_dev)} ms, runs "
                  f"{', '.join(names)}")
            del ql, kl, vl, y
        turns = {tag: [] for tag in libs}
        devs = {tag: [] for tag in libs}
        reps = max(2, min(5, int(200.0 / max(cs.cuda_ms(flash("this"), 1),
                                             1e-3))))
        for tag in order:
            turns[tag].append(cs.cuda_ms(flash(tag), reps))
            devs[tag].append(cs.device_ms(flash(tag), reps, by_kernel=True))
        for tag in libs:
            total = [None if p is None else sum(p.values())
                     for p in devs[tag]]
            split = {}  # the turns' mean device ms of each kernel
            for p in devs[tag]:
                for key, ms in (p or {}).items():
                    name = re.search(r"flash_bwd_\w+", key)
                    name = name.group(0) if name else key[:40]
                    split[name] = split.get(name, 0.0) + ms / len(devs[tag])
            print(f"probe: flash {label}, {tag}: "
                  f"{sum(turns[tag]) / len(turns[tag]):.6f} ms (turns "
                  f"{cs._turns_txt(turns[tag])}); device "
                  f"{cs._device_txt(cs._mean(total))} (turns "
                  f"{cs._turns_txt(total)})" + (
                      "" if None in total else "; by kernel " + ", ".join(
                          f"{k} {v:.6f} ms" for k, v in split.items())))
        del flash
        torch.cuda.empty_cache()
    if a.shape:  # flash's shapes alone
        return 0 if ok else 1

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
