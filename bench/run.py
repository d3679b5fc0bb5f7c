"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cells, their configurations, traffic mixes, limits and
per-layer metrics are data (``BENCHMARK.json``, ``bench/``).  Prints each
compared number beside its limit as the last lines of standard error and
one JSON object as the last line of standard output.  Exits 2 without a
result where CUDA is missing or has too few cards, and 3 where the
process holds JAX or the JAX package once the window has closed."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# cuBLAS reads its workspace setting when it first runs in a process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

#: top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import cells, runner

    cell = cells.load_cell(args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad}", file=sys.stderr)
        return 3
    print(f"bench: {args.workload} seed {args.seed}: "
          + ", ".join(f"{k} {v}" for k, v in out.pop("e2e").items())
          + f"; {out['device'].get('power', '')}", file=sys.stderr)
    if "groups_s" in out:
        print("bench: device seconds by group: " + ", ".join(
            f"{k} {v}" for k, v in out.pop("groups_s").items()),
            file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
