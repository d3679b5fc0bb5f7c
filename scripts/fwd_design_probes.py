#!/usr/bin/env python3
"""The flash forward's two bf16 routes timed against each other on the
card, and the serve shape's waves; or this build against another
checkout's, in turns, at chosen shapes.

    python3 scripts/fwd_design_probes.py      # on one card
    python3 scripts/fwd_design_probes.py --other OTHER_ROOT \\
        --shape 32,4600,120,4,window=4096 --shape 128,4096,160,4,train

``flash_attention`` in bf16 at the shapes the main paths give it:
llama3_2_3b's serve prefill (96, 500, 128) and train step (96, 4096, 128,
the training form), both causal with ``kv_group`` 3, and
granite_moe_1b_a400m's (64, 500, 64) and (64, 4096, 64) with
``kv_group`` 2 (``chip_smoke``'s seeds).  At each, the ``wgmma`` route of
``csrc/flash_attention.cu`` (the route rule's choice) and its ``mma.sync``
route (the rule forced to it), which the rule sends these shapes to if it
is faster: the two outputs' largest difference is printed, then both are
timed in turns (device time from the profiler, ``chip_smoke.device_ms``,
and CUDA events).  Then the serve shape's waves: (H, 500, 128) causal
with H 33, 66, 96 and 99 (132, 264, 384 and 396 blocks of 128 queries:
1, 2, 2.91 and 3 waves of one block an SM), so the time of the last,
partial wave shows.  Prints ptxas's registers and spills for each
``wgmma`` forward.

``--shape H,S,d,kv_group[,window=W][,train]`` (repeatable, causal) takes
the place of those shapes and of the waves.  With ``--other``, the same
source of ``OTHER_ROOT`` (another checkout, for example the parent commit
unpacked with ``git archive``) is built with the port's flags and each
build runs on its own checkout's route rule (``fwd_route`` of its
``flash_attention.py``); at each shape the two are timed in turns (other,
this, this, other, twice), each printed with its route, its output's
largest difference from the plain version's (``PLAIN_FLASH_HEADS`` query
heads at a time) and from the other build's, the plain version's time,
the bound (``kernels.cost``) and SDPA's device time on the same inputs
(k and v repeated to the query heads, a boolean mask where a window is
set; the kernels it runs are named).

Exit 0 whatever the times; 1 if a build fails; 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: query heads of the waves probe (kv_group 3)
WAVE_HEADS = (33, 66, 96, 99)
#: (label, H, S, d, kv_group, training form)
SHAPES = [("llama serve", 96, 500, 128, 3, False),
          ("llama train", 96, 4096, 128, 3, True),
          ("granite serve", 64, 500, 64, 2, False),
          ("granite train", 64, 4096, 64, 2, True)]


def parse_shape(text: str):
    """``H,S,d,kv_group[,window=W][,train]`` as (H, S, d, kv_group,
    window, train)."""
    parts = text.split(",")
    H, S, d, g = (int(p) for p in parts[:4])
    window, train = 0, False
    for p in parts[4:]:
        if p == "train":
            train = True
        elif p.startswith("window="):
            window = int(p.split("=", 1)[1])
        else:
            raise argparse.ArgumentTypeError(f"unknown shape field {p!r}")
    return H, S, d, g, window, train


def fwd_registers(log_path: str):
    """(kernel, registers, spill text) of each ``wgmma`` forward in a
    build's ptxas output."""
    out, entry, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or "flash_fwd_wgmma_kernel" not in entry:
                continue
            if "spill" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                dp, train = re.search(r"ILi(\d+)ELb(\d)E", entry).groups()
                out.append((f"<{dp}, {'true' if train == '1' else 'false'}>",
                            int(m.group(1)), spill))
                entry = None
    return out


def route_rules(root: str):
    """The ``flash_attention.py`` of checkout ``root`` as a module, for its
    route rules (``fwd_route``, ``bwd_route``)."""
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "flash_attention.py")
    spec = importlib.util.spec_from_file_location("other_flash_attention",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fwd_entry(path: str):
    """The ``flash_attention`` entry and error string of the library at
    ``path``, bound as ``_launch.entry`` binds the port's."""
    from repro_torch.kernels.flash_attention import _ARGS

    lib = ctypes.CDLL(path)
    fn = lib.flash_attention_launch
    fn.argtypes = list(_ARGS) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


@contextlib.contextmanager
def routed(rule, entry=None):
    """``flash_attention_cuda`` on the route rule ``rule`` (``fwd_route``'s
    signature), launching ``entry`` (an entry from :func:`fwd_entry`) where
    given; the wrapper's checks, buffers and launch stay the port's."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels import flash_attention as fa

    saved_rule = fa.fwd_route
    saved_entry = _launch._entries.get("flash_attention")
    fa.fwd_route = rule
    if entry is not None:
        _launch._entries["flash_attention"] = entry
    try:
        yield
    finally:
        fa.fwd_route = saved_rule
        if entry is not None:
            if saved_entry is None:
                _launch._entries.pop("flash_attention")
            else:
                _launch._entries["flash_attention"] = saved_entry


def sdpa_call(q, k, v, g: int, window: int):
    """SDPA on (q, k, v) causal, k and v repeated to the query heads, with
    a boolean mask where ``window`` is set (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    S = q.shape[1]
    kr, vr = (t.repeat_interleave(g, dim=0)[None] for t in (k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            q[None], kr, vr, is_causal=True)[0]
    pos = torch.arange(S, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda: F.scaled_dot_product_attention(q[None], kr, vr,
                                                  attn_mask=mask)[0]


def compare_builds(shapes, other_lib: str, other_root: str) -> None:
    """This build and the other, each on its own route rule, at each of
    ``shapes``, in turns (see the module note)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    entry = fwd_entry(other_lib)
    other_rule = route_rules(other_root).fwd_route
    for H, S, d, g, window, train in shapes:
        kw = dict(causal=True, window=window)
        q = cs._randn((H, S, d), bf, 66)
        k, v = (cs._randn((H // g, S, d), bf, i) for i in (67, 68))

        def call(tag):
            def run():
                with routed(other_rule, entry) if tag == "other" \
                        else contextlib.nullcontext():
                    out = fa.flash_attention_cuda(q, k, v, kv_group=g,
                                                  train=train, **kw)
                return out[0] if train else out
            return run

        def plain():
            step = cs.PLAIN_FLASH_HEADS
            return torch.cat([ref.flash_attention(
                q[h0:h0 + step], k[h0 // g:(h0 + step) // g],
                v[h0 // g:(h0 + step) // g], kv_group=g, **kw)
                for h0 in range(0, H, step)])

        calls = {"other": call("other"), "this": call("this")}
        routes = {"other": fa.ROUTE_NAMES[other_rule(bf, d)],
                  "this": fa.ROUTE_NAMES[fa.fwd_route(bf, d)]}
        outs = {tag: fn() for tag, fn in calls.items()}
        want = plain()
        p_ms = cs.cuda_ms(plain, 1)
        errs = {tag: (o.float() - want.float()).abs().max().item()
                for tag, o in outs.items()}
        between = (outs["other"].float() - outs["this"].float()).abs().max(
        ).item()
        del outs, want
        reps = max(3, min(200, int(20.0 / max(cs.cuda_ms(calls["this"], 1),
                                              1e-3))))
        turns = {tag: ([], []) for tag in calls}
        for tag in ["other", "this", "this", "other"] * 2:
            turns[tag][0].append(cs.device_ms(calls[tag], reps))
            turns[tag][1].append(cs.cuda_ms(calls[tag], reps))
        lib = sdpa_call(q, k, v, g, window)
        l_dev = [cs.device_ms(lib, reps) for _ in range(2)]
        names = sorted(n[:60] for n in cs._traced_names(lib, ()))
        bound, by = cs._bound(*cost.flash_attention(
            H, H // g, S, d, 2, causal=True, window=window, train=train))
        label = (f"({H},{S},{d}) causal{f' window {window}' if window else ''}"
                 f" kv_group {g}{' training form' if train else ''} bf16")
        for tag, (dev, ev) in turns.items():
            print(f"probe: flash forward {label}, {tag} build (route "
                  f"{routes[tag]}): device {cs._turns_txt(dev)} ms (mean "
                  f"{cs._device_txt(cs._mean(dev))}), events "
                  f"{cs._turns_txt(ev)} ms; max abs err vs plain "
                  f"{errs[tag]:.6g}")
        print(f"probe: flash forward {label}: builds differ by {between:.6g} "
              f"(max abs); plain {p_ms:.6f} ms; bound {bound:.6f} ms ({by}); "
              f"SDPA device {cs._turns_txt(l_dev)} ms, runs "
              f"{', '.join(names)}")
        del q, k, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout whose flash forward "
                    "is timed in turns with this one's")
    ap.add_argument("--shape", action="append", type=parse_shape,
                    help="H,S,d,kv_group[,window=W][,train] (repeatable)")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import bwd_design_probes as bp
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    try:
        with ThreadPoolExecutor(2) as pool:
            port = pool.submit(_build.build, "flash_attention")
            other = pool.submit(bp.build_other, os.path.abspath(a.other)) \
                if a.other else None
            libs = {"this": port.result()}
            if other is not None:
                libs["other"] = other.result()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"probes on {torch.cuda.get_device_name(0)} ({smi})")
    for tag, lib in libs.items():
        for kern, regs, spill in fwd_registers(f"{lib}.log"):
            print(f"probe: flash forward {tag}: flash_fwd_wgmma_kernel{kern}"
                  f": {regs} registers; {spill}")
    if a.other:
        compare_builds(a.shape or [(H, S, d, g, 0, t)
                                   for _, H, S, d, g, t in SHAPES],
                       libs["other"], os.path.abspath(a.other))
        return 0

    bf = torch.bfloat16
    shapes = SHAPES if not a.shape else [
        (f"shape {i}", H, S, d, g, t) for i, (H, S, d, g, w, t)
        in enumerate(a.shape)]
    windows = {} if not a.shape else {
        f"shape {i}": w for i, (_, _, _, _, w, _) in enumerate(a.shape)}
    for label, H, S, d, g, train in shapes:
        w = windows.get(label, 0)
        q = cs._randn((H, S, d), bf, 66)
        k, v = (cs._randn((H // g, S, d), bf, i) for i in (67, 68))

        def call(route):
            def run():
                with routed(lambda *a: route):
                    out = fa.flash_attention_cuda(q, k, v, kv_group=g,
                                                  causal=True, window=w,
                                                  train=train)
                return out[0] if train else out
            return run

        calls = {"wgmma": call(fa.WGMMA), "mma.sync": call(fa.MMA_SYNC)}
        err = (calls["mma.sync"]().float() - calls["wgmma"]().float()
               ).abs().max().item()
        print(f"probe: flash forward {label}: mma.sync output within "
              f"{err:.6g} of wgmma's (max abs)")
        reps = max(3, min(200, int(20.0 / max(cs.cuda_ms(calls["wgmma"], 1),
                                              1e-3))))
        turns = {tag: ([], []) for tag in calls}
        for _ in range(2):
            for tag, fn in calls.items():
                turns[tag][0].append(cs.device_ms(fn, reps))
                turns[tag][1].append(cs.cuda_ms(fn, reps))
        for tag, (dev, ev) in turns.items():
            print(f"probe: flash forward {label} ({H},{S},{d}) causal"
                  f"{f' window {w}' if w else ''} kv_group {g}"
                  f"{' training form' if train else ''} bf16, "
                  f"{tag}: device {cs._turns_txt(dev)} ms, events "
                  f"{cs._turns_txt(ev)} ms")
    if a.shape:
        return 0
    # the serve shape's waves: 4 q tiles a head, one block an SM
    for H in WAVE_HEADS:
        q = cs._randn((H, 500, 128), bf, 66)
        k, v = (cs._randn((H // 3, 500, 128), bf, i) for i in (67, 68))
        fn = lambda q=q, k=k, v=v: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, kv_group=3, causal=True)
        dev = [cs.device_ms(fn, 50) for _ in range(2)]
        print(f"probe: flash forward waves ({H},500,128) causal kv_group 3 "
              f"bf16, {H * 4} blocks ({H * 4 / 132:.2f} waves of 132): "
              f"device {cs._turns_txt(dev)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
