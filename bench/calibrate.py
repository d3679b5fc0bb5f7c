"""The readings that the comparison limits are set from (not run by the
benchmark's own runs):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--seconds 8]

in one process on the card: for each seed a run of the program with its
comparison, for each control seed the control (the reference in float8 in
the program's place), and for each fault seed a run with each fault the
cell can have planted in the program.  Prints one JSON line a reading."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="",
                    help="the faults to plant (default: every one the "
                    "cell can have)")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--test", action="store_true",
                    help="the CPU tests' small widths")
    args = ap.parse_args(argv)

    from bench.harness import cells, faults

    cell = cells.load_cell(args.workload)
    entry = cells.entry_module(cell)

    def say(kind, seed, **kw):
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          **kw}), flush=True)

    def program_run(kind, seed):
        t0 = time.perf_counter()
        out = entry.run(cell, seed, args.seconds, False, args.device,
                        args.test)
        say(kind, seed, numbers=out["numbers"], e2e=out["e2e"],
            attempted=out["attempted"], failed=out["failed"],
            seconds=time.perf_counter() - t0)

    for seed in args.seeds:
        program_run("program", seed)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        say("control", seed, numbers=entry.control(cell, seed, args.device,
                                                   args.test),
            seconds=time.perf_counter() - t0)
    for seed in args.fault_seeds:
        for fault in (args.faults.split(",") if args.faults
                      else entry.FAULTS):
            with faults.planted(fault):
                program_run(fault, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
