"""``python -m repro_torch verify`` — batch-verify stored artifacts on the
card (port of ``plaid-compile verify``, ``repro/compiler/cli.py``).

    python -m repro_torch verify PATHS... [--iterations 3] [--parity]
                                         [--device cuda|cpu]

Every mapping of every artifact (files, or directories of them) is proven
in one call of the batched simulator.  The command prints one
``OK``/``FAIL``/``SKIP`` line per artifact and the cold (lower + pack +
run) and warm (rerun on the prepared batch) mappings/s.  ``--parity``
also runs the scalar oracle on every mapping.

Exit codes, as ``plaid-compile verify``: 0 every artifact verified or
skipped, 1 a verification failed (or nothing to verify), 2 no such device
(``cuda`` is the default and there is no fallback to the CPU), 10 the
batched verdicts diverged from the scalar oracle under ``--parity``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from repro_torch.compiler.artifact import (
    ARTIFACT_SCHEMA,
    SUPPORTED_SCHEMAS,
    CompileResult,
)

#: the evaluation grid ``{job: (arch, mapper)}`` of the JAX package's
#: mapper registrations (``repro.compiler.pipeline.job_grid()``)
JOB_GRID = {
    "plaid": ("plaid2x2", "hierarchical"),
    "plaid3x3": ("plaid3x3", "hierarchical"),
    "plaid_ml": ("plaid_ml", "hierarchical"),
    "st": ("st4x4", "node_greedy"),
    "node_on_plaid": ("plaid2x2", "node_greedy"),
    "pf_on_plaid": ("plaid2x2", "pathfinder"),
    "spatial": ("spatial4x4", "spatial"),
}

#: exit code of a verdict divergence under ``--parity`` (the JAX
#: package's ``CompileError``)
EXIT_PARITY = 10

#: what a failed rebuild of a stored record raises (``VERIFY_FAILURES``
#: of the JAX package)
VERIFY_FAILURES = (AssertionError, ValueError, KeyError, TypeError,
                   IndexError, AttributeError)


def _job_of(artifact: CompileResult) -> str:
    """Grid job name for an artifact's (arch, mapper) pair; falls back to a
    ``mapper@arch`` label for off-grid combinations."""
    rev = {am: job for job, am in JOB_GRID.items()}
    return rev.get((artifact.arch, artifact.mapper),
                   f"{artifact.mapper}@{artifact.arch}")


def _is_artifact(path: str) -> bool:
    try:
        with open(path) as f:
            return json.load(f).get("schema") in SUPPORTED_SCHEMAS
    except (OSError, ValueError):
        return False


def _gather_artifacts(paths: List[str]) -> List[tuple]:
    """``(label, CompileResult)`` pairs from artifact files or
    directories of them."""
    out: List[tuple] = []
    for path in paths:
        files = ([os.path.join(path, fn) for fn in sorted(os.listdir(path))
                  if fn.endswith(".json")]
                 if os.path.isdir(path) else [path])
        for fp in files:
            if not _is_artifact(fp):
                print(f"note {fp}: not a {ARTIFACT_SCHEMA} artifact "
                      "(skipped)")
                continue
            art = CompileResult.load(fp)
            out.append((f"{art.key}/{_job_of(art)}", art))
    return out


def _cmd_verify(args) -> int:
    from repro_torch.device import resolve_device
    from repro_torch.sim.batch import prepare_batch, simulate_batch
    from repro_torch.sim.check import scalar_verdict

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    arts = _gather_artifacts(args.paths)
    if not arts:
        print("no artifacts found to verify", file=sys.stderr)
        return 1

    mappings: List[object] = []
    owners: List[tuple] = []          # (artifact row, segment index)
    rows: List[Dict] = []             # per-artifact verdict accumulator
    for label, art in arts:
        row = {"label": label, "segments": 0, "fail": None, "skip": None}
        rows.append(row)
        if not art.mappings:
            row["skip"] = "no stored mapping (unmapped / analytic spatial)"
            continue
        try:
            ms = art.rebuild_mappings()
        except VERIFY_FAILURES as e:
            # mangled record: rebuilding IS part of verification
            row["fail"] = f"unloadable mapping ({type(e).__name__}: {e})"
            continue
        row["segments"] = len(ms)
        for s, m in enumerate(ms):
            mappings.append(m)
            owners.append((row, s))

    # cold = lower + pack + run; warm = rerun on the prepared batch
    t0 = time.perf_counter()
    cold = simulate_batch(mappings, iterations=args.iterations, device=device)
    t_cold = time.perf_counter() - t0
    prepared = prepare_batch(mappings, iterations=args.iterations,
                             device=device)
    t0 = time.perf_counter()
    simulate_batch(mappings, iterations=args.iterations, device=device,
                   prepared=prepared)
    t_warm = time.perf_counter() - t0
    for (row, s), v in zip(owners, cold):
        if not v.ok and row["fail"] is None:
            row["fail"] = f"segment {s}: {v.reason}"

    rc = 0
    for row in rows:
        if row["skip"]:
            print(f"SKIP  {row['label']:34s} {row['skip']}")
        elif row["fail"]:
            print(f"FAIL  {row['label']:34s} {row['fail']}")
            rc = 1
        else:
            print(f"OK    {row['label']:34s} "
                  f"{row['segments']} mapping(s) verified")

    n = len(mappings)
    cold_mps = n / t_cold if t_cold > 0 else 0.0
    warm_mps = n / t_warm if t_warm > 0 else 0.0
    print(f"batched[{cold.backend}]: {n} mappings, "
          f"{cold.n_buckets} bucket(s), "
          f"{cold.n_scalar_fallback} scalar fallback(s); "
          f"cold {cold_mps:.0f} mappings/s, warm {warm_mps:.0f} mappings/s")

    if args.parity:
        t0 = time.perf_counter()
        divergent = 0
        for i, (m, v) in enumerate(zip(mappings, cold)):
            ok, _values, reason = scalar_verdict(m,
                                                 iterations=args.iterations)
            if ok != v.ok:
                row, s = owners[i]
                print(f"PARITY MISMATCH  {row['label']} segment {s}: "
                      f"scalar {'ok' if ok else f'FAIL ({reason})'} vs "
                      f"batched {'ok' if v.ok else f'FAIL ({v.reason})'}",
                      file=sys.stderr)
                divergent += 1
        t_scalar = time.perf_counter() - t0
        scalar_mps = n / t_scalar if t_scalar > 0 else 0.0
        speedup = warm_mps / scalar_mps if scalar_mps else 0.0
        print(f"scalar oracle: {scalar_mps:.0f} mappings/s -> batched warm "
              f"speedup {speedup:.1f}x; verdict parity on {n - divergent}"
              f"/{n} mappings")
        if divergent:
            print(f"error: CompileError: batched simulator diverged from "
                  f"the scalar oracle on {divergent}/{n} mappings",
                  file=sys.stderr)
            return EXIT_PARITY
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Plaid CGRA toolchain, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify",
                       help="batch-verify artifacts on the card "
                            "(repro_torch.sim)")
    v.add_argument("paths", nargs="+",
                   help="artifact files or directories of artifacts")
    v.add_argument("--iterations", type=int, default=3)
    v.add_argument("--parity", action="store_true",
                   help="also run the scalar oracle on every mapping; "
                        f"verdict divergence exits with code {EXIT_PARITY}")
    v.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the cycle loop runs (default cuda; there is "
                        "no fallback when it is absent)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"verify": _cmd_verify}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
