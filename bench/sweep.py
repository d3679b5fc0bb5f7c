"""The highest rate a prefill cell's program sustains, found once by a
sweep (not run by the benchmark's own runs):

    python3 bench/sweep.py --workload <cell> --seed 1 --seconds 30 \\
        --fractions 0.6,0.7,0.8,0.9,1.0

in one process on the card: first a window with every batch due at its
start (the capacity in batches a second), then a window at each fraction
of that rate, each with its 95th-percentile time to first token and how
late its last batch started (a lateness that grows with the window is a
backlog the program does not clear)."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    args = ap.parse_args(argv)

    from bench.harness import cells

    cell = cells.load_cell(args.workload)
    r = cells.entry_module(cell).Run(cell, args.seed, "cuda")
    r.mix["rate_batches_per_s"] = None
    out = r.window(args.seconds)
    cap = r.next_batch / args.seconds
    print(json.dumps({"rate": None, "batches": r.next_batch,
                      "capacity_batches_per_s": cap, **out}), flush=True)
    for frac in [float(f) for f in args.fractions.split(",")]:
        r.mix["rate_batches_per_s"] = frac * cap
        out = r.window(args.seconds)
        print(json.dumps({"fraction": frac, "rate": frac * cap,
                          "batches": r.next_batch, "last_late_s":
                          r.last_late_s, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
