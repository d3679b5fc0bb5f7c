#!/usr/bin/env python3
"""End-to-end walls of two checkouts of the port, in turns on one card.

    python3 scripts/torch_ab_walls.py OTHER_ROOT [--cell CELL ...]

``OTHER_ROOT`` is another checkout of this repository (for example the
parent commit unpacked with ``git archive``); this script's own checkout
is the second.  Each cell runs in a fresh process against one
checkout's ``repro_torch`` (``PYTHONPATH=<root>/src``, its kernels built
under ``<root>/build``), in the order other, this, this, other for each
of two rounds, so that a drift of the host over the call falls on both
alike.  The cells are the main paths' own entry points at
``chip_smoke.py``'s shapes:

- train steps: ``repro_torch.launch.train`` at batch 4 x 4096 on
  llama3_2_3b, zamba2_1_2b (13 layers), falcon_mamba_7b (4 layers) and
  whisper_tiny, 6 steps; the reading is its median step after the
  first;
- a served prefill: ``repro_torch.launch.serve`` on granite_moe_1b_a400m
  at 4 x 500 (32 new tokens), run twice in the process; the reading is
  the second run's prefill (the first pays for the card's warm-up).

``--cell`` (repeatable) runs only the cells named (keys of ``CELLS``).
Both checkouts' kernels are built first, all at once.  Prints every
reading and, per cell, both checkouts' readings and means; writes
nothing.  Exit 0 whatever the times; 1 if a build or a run fails; 2
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
ROUNDS = 2
TRAIN = ["--batch", "4", "--seq", "4096", "--ckpt-every", "0",
         "--device", "cuda"]
#: cell -> (entry, its arguments)
CELLS = {
    "llama3_2_3b train step": ("train", ["--arch", "llama3_2_3b"]),
    "zamba2_1_2b train step, 13 layers": (
        "train", ["--arch", "zamba2_1_2b", "--layers", "13"]),
    "falcon_mamba_7b train step, 4 layers": (
        "train", ["--arch", "falcon_mamba_7b", "--layers", "4"]),
    "whisper_tiny train step": ("train", ["--arch", "whisper_tiny"]),
    "granite_moe_1b_a400m prefill": (
        "serve", ["--arch", "granite_moe_1b_a400m", "--batch", "4",
                  "--prompt-len", "500", "--new-tokens", "32",
                  "--device", "cuda"]),
}


def child_build() -> int:
    """Build every kernel of the checkout on ``PYTHONPATH``, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    return 0


def child_run(entry: str, args) -> float:
    """One reading of a cell, in seconds, against the checkout on
    ``PYTHONPATH``."""
    import contextlib
    import io

    if entry == "train":
        from repro_torch.launch.train import run

        with tempfile.TemporaryDirectory() as ckpt, \
                contextlib.redirect_stdout(io.StringIO()):
            out = run(args + TRAIN + ["--steps", str(STEPS), "--ckpt-dir",
                                      ckpt])
        return out["step_s_median"]
    from repro_torch.launch.serve import run

    with contextlib.redirect_stdout(io.StringIO()):
        run(args)
        out = run(args)
    return out["info"]["prefill_s"]


def in_checkout(root: str, argv, timeout: float):
    """This script's child mode with ``argv`` against ``root``'s package;
    returns the completed process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run([sys.executable, os.path.abspath(__file__),
                           *argv], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--child", nargs=2, metavar=("ENTRY", "ARGS_JSON"))
    ap.add_argument("--child-build", action="store_true")
    ap.add_argument("--cell", action="append", choices=sorted(CELLS),
                    help="only this cell (repeatable; all by default)")
    a = ap.parse_args(argv)
    if a.child_build:
        return child_build()
    if a.child:
        secs = child_run(a.child[0], json.loads(a.child[1]))
        print(json.dumps({"s": secs}))
        return 0
    if a.other is None:
        ap.error("OTHER_ROOT is required")
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    roots = {"other": os.path.abspath(a.other), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ab: {torch.cuda.get_device_name(0)} ({smi}); other = "
          f"{roots['other']}, this = {roots['this']}")
    t0 = time.perf_counter()
    env = {tag: dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
           for tag, root in roots.items()}
    builds = {tag: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child-build"],
        cwd=root, env=env[tag], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for tag, root in roots.items()}
    for tag, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"ab: the {tag} checkout's build failed:\n{out}",
                  file=sys.stderr)
            return 1
    print(f"ab: both checkouts built in {time.perf_counter() - t0:.3f} s")
    order = ["other", "this", "this", "other"] * ROUNDS
    for cell, (entry, args) in CELLS.items():
        if a.cell and cell not in a.cell:
            continue
        readings = {"other": [], "this": []}
        for tag in order:
            proc = in_checkout(roots[tag], ["--child", entry,
                                            json.dumps(args)], 900)
            if proc.returncode != 0:
                print(f"ab: {cell} on the {tag} checkout failed "
                      f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            secs = json.loads(proc.stdout.strip().splitlines()[-1])["s"]
            readings[tag].append(secs)
            print(f"ab: {cell}, {tag}: {secs:.6f} s", flush=True)
        mean = {tag: sum(v) / len(v) for tag, v in readings.items()}
        print(f"ab: {cell}: other {[round(v, 6) for v in readings['other']]}"
              f" mean {mean['other']:.6f} s; this "
              f"{[round(v, 6) for v in readings['this']]} mean "
              f"{mean['this']:.6f} s; this / other "
              f"{mean['this'] / mean['other']:.4f}", flush=True)
    print(f"ab: done in {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
