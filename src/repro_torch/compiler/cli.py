"""``python -m repro_torch`` — the verify front door of the toolchain on the
card (port of ``verify`` and ``store ls|put|gc`` of ``plaid-compile``,
``repro/compiler/cli.py``).

    python -m repro_torch verify [PATHS...] [--dir STORE] [--iterations 3]
                                 [--parity] [--device cuda|cpu]
                                 [--backend numpy]
                                 [--bench-out PATH [--bench-note TAG]]
    python -m repro_torch store ls|put|gc --dir STORE ...

``verify``: every mapping of every artifact (files, directories of them,
and the entries of an artifact store under ``--dir``, scanned read-only)
is rebuilt, validated against its fabric and proven in one call of the
batched simulator.  The command prints one ``OK``/``FAIL``/``SKIP`` line
per artifact and the cold (lower + pack + run) and warm (rerun on the
prepared batch) mappings/s; ``--bench-out`` appends them to a bench
trajectory as a ``sim_throughput`` entry.  ``--parity`` also runs the
scalar oracle on every mapping.  The cycle loop runs on ``--device``
(``cuda`` by default, with no fallback to the CPU); ``--backend numpy``
asks for the float64 host loop instead.

``store``: list, insert and garbage-collect the content-addressed artifact
store (:mod:`repro_torch.compiler.store`), which the JAX package's
``plaid-compile store`` reads and writes alike.  ``store get|warm`` compile
on a miss and wait for the mapper's port.

Exit codes, as ``plaid-compile``: 0 every artifact verified or skipped, 1
a verification failed (or nothing to verify), 2 usage error or no such
device, and the taxonomy's codes 10+ (:mod:`repro_torch.compiler.errors`;
10 when the batched verdicts diverge from the scalar oracle under
``--parity``).
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
from repro_torch.compiler.errors import (
    VERIFY_FAILURES,
    CompileError,
    exit_code_for,
)
from repro_torch.compiler.registry import RegistryError
from repro_torch.compiler.store import ArtifactStore, CompileKey, key_for

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


def _gather_artifacts(paths: List[str],
                      store_dir: Optional[str] = None) -> List[tuple]:
    """``(label, CompileResult)`` pairs from ``store_dir`` (an artifact
    store, scanned read-only) and/or ``paths`` (artifact files or
    directories of them)."""
    out: List[tuple] = []
    if store_dir:
        store = ArtifactStore(store_dir)
        for key, art in store.iter_artifacts():
            out.append((key.describe(), art))
        if store.counters.rejected:
            print(f"note: {store.counters.rejected} corrupt store entr"
                  f"{'y' if store.counters.rejected == 1 else 'ies'} "
                  "skipped", file=sys.stderr)
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
    from repro_torch.sim.batch import (prepare_batch, select_backend,
                                       simulate_batch)
    from repro_torch.sim.check import scalar_verdict

    try:
        backend = select_backend(args.backend, args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    device = args.device
    arts = _gather_artifacts(args.paths, args.dir)
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
    cold = simulate_batch(mappings, iterations=args.iterations,
                          device=device, backend=backend)
    t_cold = time.perf_counter() - t0
    prepared = prepare_batch(mappings, iterations=args.iterations,
                             device=device, backend=backend)
    t0 = time.perf_counter()
    simulate_batch(mappings, iterations=args.iterations, device=device,
                   backend=backend, prepared=prepared)
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

    scalar_mps = None
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
            raise CompileError(
                f"batched simulator diverged from the scalar oracle on "
                f"{divergent}/{n} mappings")

    if args.bench_out:
        from repro_torch.core.collect import _append_bench

        entry = {
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "sim_throughput": {
                "backend": cold.backend,
                "mappings": n,
                "buckets": cold.n_buckets,
                "scalar_fallbacks": cold.n_scalar_fallback,
                "iterations": args.iterations,
                "cold_mappings_per_s": round(cold_mps, 1),
                "warm_mappings_per_s": round(warm_mps, 1),
            },
        }
        if scalar_mps is not None:
            entry["sim_throughput"]["scalar_mappings_per_s"] = round(
                scalar_mps, 1)
            entry["sim_throughput"]["speedup_warm"] = round(
                warm_mps / scalar_mps, 1) if scalar_mps else None
        if args.bench_note:
            entry["note"] = args.bench_note
        _append_bench(args.bench_out, entry)
        print(f"sim_throughput entry appended to {args.bench_out}")
    return rc


# -- store subcommands -------------------------------------------------------


def _open_store(args) -> ArtifactStore:
    return ArtifactStore(args.dir, max_bytes=getattr(args, "max_bytes", None))


def _cmd_store_put(args) -> int:
    store = _open_store(args)
    rc = 0
    for path in args.artifacts:
        try:
            res = CompileResult.load(path)
        # the bounded not-a-loadable-artifact list: structurally mangled
        # JSON surfaces as KeyError/AttributeError/TypeError/IndexError
        # from from_json, unreadable files as OSError, bad schemas as
        # ValueError (incl. ArtifactError) — each means "skip this file,
        # keep going".  Anything else is a real bug and propagates.
        except (OSError, ValueError, KeyError, TypeError, AttributeError,
                IndexError) as e:
            print(f"{path}: not a loadable artifact "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
            rc = 1
            continue
        digest = store.put(res, key=key_for(res))
        print(f"{path}: stored as {digest[:16]}… ({key_for(res).describe()})")
    return rc


def _cmd_store_ls(args) -> int:
    store = _open_store(args)
    rows = store.ls()
    if not rows:
        print("store is empty")
        return 0
    header = ("key", "ii", "cycles", "size", "hits", "verified")
    table = [header]
    for r in rows:
        tag = CompileKey.from_json(r["key"]).describe()
        table.append((tag, str(r.get("ii")), str(r.get("cycles")),
                      str(r.get("size")), str(r.get("hits", 0)),
                      str(bool(r.get("verified")))))
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    for i, row in enumerate(table):
        print("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
        if i == 0:
            print("  ".join("-" * w for w in widths))
    print(f"{len(rows)} entr{'y' if len(rows) == 1 else 'ies'}, "
          f"{store.total_bytes()} bytes")
    return 0


def _cmd_store_gc(args) -> int:
    store = _open_store(args)
    evicted = store.gc(max_bytes=args.max_bytes)
    print(f"gc: evicted {evicted} entr{'y' if evicted == 1 else 'ies'}; "
          f"{len(store.ls())} left, {store.total_bytes()} bytes")
    return 0


def _cmd_store(args) -> int:
    return {
        "put": _cmd_store_put,
        "ls": _cmd_store_ls,
        "gc": _cmd_store_gc,
    }[args.store_cmd](args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Plaid CGRA toolchain, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify",
                       help="batch-verify artifacts on the card "
                            "(repro_torch.sim)")
    v.add_argument("paths", nargs="*",
                   help="artifact files or directories of artifacts")
    v.add_argument("--dir", default=None, metavar="STORE",
                   help="artifact store to verify (read-only scan; "
                        "combinable with positional paths)")
    v.add_argument("--iterations", type=int, default=3)
    v.add_argument("--parity", action="store_true",
                   help="also run the scalar oracle on every mapping; "
                        "verdict divergence exits with code 10 "
                        "(CompileError)")
    v.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the cycle loop runs (default cuda; there is "
                        "no fallback when it is absent)")
    v.add_argument("--backend", default=None, choices=("numpy",),
                   help="run numpy's float64 host loop instead of the "
                        "float32 tensor loop on --device (takes no --device "
                        "but cpu)")
    v.add_argument("--bench-out", default=None, metavar="PATH",
                   help="append a sim_throughput entry to this bench "
                        "trajectory JSON (flock-bounded)")
    v.add_argument("--bench-note", default="",
                   help="tag recorded with the bench entry")

    s = sub.add_parser("store",
                       help="content-addressed mapping store (serving tier)")
    ssub = s.add_subparsers(dest="store_cmd", required=True)

    def _dir_arg(p):
        p.add_argument("--dir", default="artifacts/store",
                       help="store root directory (default artifacts/store)")

    p = ssub.add_parser("put", help="insert existing artifact files")
    _dir_arg(p)
    p.add_argument("artifacts", nargs="+")

    ls = ssub.add_parser("ls", help="list stored entries (MRU first)")
    _dir_arg(ls)

    gc = ssub.add_parser("gc", help="LRU-evict down to --max-bytes; drop "
                                    "corrupt entries")
    _dir_arg(gc)
    gc.add_argument("--max-bytes", type=int, default=None,
                    help="size cap (default: keep everything, still drops "
                         "corrupt entries)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    """Exit codes: 0 success, 1 generic failure (verify failed), 2 usage
    error or no such device; taxonomy failures map to their own codes 10+
    (:func:`~repro_torch.compiler.errors.exit_code_for`).  Anything else
    — a device fault above all — propagates, as in the JAX package."""
    args = build_parser().parse_args(argv)
    handler = {"verify": _cmd_verify, "store": _cmd_store}[args.cmd]
    try:
        return handler(args)
    except CompileError as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        for k, val in (e.to_json().get("details") or {}).items():
            print(f"  {k}: {val}", file=sys.stderr)
        return exit_code_for(e)
    except RegistryError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
