#!/usr/bin/env python3
"""The flash forward's two bf16 routes timed against each other on the
card, and the serve shape's waves.

    python3 scripts/fwd_design_probes.py      # on one card

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

Exit 0 whatever the times; 1 if the build fails; 2 without a card.
"""
from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: query heads of the waves probe (kv_group 3)
WAVE_HEADS = (33, 66, 96, 99)
#: (label, H, S, d, kv_group, training form)
SHAPES = [("llama serve", 96, 500, 128, 3, False),
          ("llama train", 96, 4096, 128, 3, True),
          ("granite serve", 64, 500, 64, 2, False),
          ("granite train", 64, 4096, 64, 2, True)]


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


@contextlib.contextmanager
def routed(route):
    """``flash_attention_cuda`` on ``route`` (the route rule forced); the
    wrapper's checks, buffers and launch stay the port's."""
    from repro_torch.kernels import flash_attention as fa

    saved_rule = fa.fwd_route
    fa.fwd_route = lambda *a: route
    try:
        yield
    finally:
        fa.fwd_route = saved_rule


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    try:
        lib = _build.build("flash_attention")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"probes on {torch.cuda.get_device_name(0)} ({smi})")
    for kern, regs, spill in fwd_registers(f"{lib}.log"):
        print(f"probe: flash forward: flash_fwd_wgmma_kernel{kern}: {regs} "
              f"registers; {spill}")

    bf = torch.bfloat16
    for label, H, S, d, g, train in SHAPES:
        q = cs._randn((H, S, d), bf, 66)
        k, v = (cs._randn((H // g, S, d), bf, i) for i in (67, 68))

        def call(route):
            def run():
                with routed(route):
                    out = fa.flash_attention_cuda(q, k, v, kv_group=g,
                                                  causal=True, train=train)
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
            print(f"probe: flash forward {label} ({H},{S},{d}) causal "
                  f"kv_group {g}{' training form' if train else ''} bf16, "
                  f"{tag}: device {cs._turns_txt(dev)} ms, events "
                  f"{cs._turns_txt(ev)} ms")
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
