"""``python -m repro_torch`` — the toolchain CLI of the port (port of
``plaid-compile``, ``repro/compiler/cli.py``).

    python -m repro_torch list
    python -m repro_torch compile WORKLOAD [-u U] [--arch A --mapper M |
                                  --job J | --all-jobs] [--verify]
                                  [--device cuda|cpu] [--store DIR]
                                  [--remote SOCKET] [--deadline-s S]
                                  [--fallback-mapper M]
                                  [--out PATH | --out-dir DIR]
    python -m repro_torch inspect ARTIFACT... [--verify] [--device cuda|cpu]
    python -m repro_torch diff A B | diff --golden GOLDEN PATHS...
    python -m repro_torch verify [PATHS...] [--dir STORE] [--iterations 3]
                                 [--parity] [--device cuda|cpu]
                                 [--backend numpy]
                                 [--bench-out PATH [--bench-note TAG]]
    python -m repro_torch store get|put|ls|gc|warm --dir STORE ...
    python -m repro_torch serve --dir STORE --socket PATH [--workers N]
                                [--queue-limit N] [--deadline-s S]
                                [--retries N] [--start-method M]
                                [--device cuda|cpu]

``list``: the registered mappers, fabrics and the evaluation grid.
``compile``: place & route one workload (:func:`repro_torch.compiler.
pipeline.compile`) into an artifact; ``--all-jobs`` sweeps the grid into
``--out-dir``, ``--verify`` proves each mapping on ``--device`` (``cuda``
by default, refused before place & route when there is none), ``--store``
makes each compile cache-first, ``--remote`` sends a cache miss to a farm
daemon (a local compile when it cannot be reached).  ``inspect``:
summarize artifacts, ``--verify`` re-simulates them without place &
route.  ``diff``: two
artifacts, or artifacts against a golden II file (exit 1 on a
regression).

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

``store``: fetch (no place & route), insert, list, garbage-collect and
warm (compile a workload x job grid into it) the content-addressed
artifact store (:mod:`repro_torch.compiler.store`), which the JAX
package's ``plaid-compile store`` reads and writes alike.

``serve``: the compile-farm daemon (:mod:`repro_torch.serve_farm`) over a
Unix socket, on ``--device`` (``cuda`` by default, refused when there is
none): cache-first, in-flight dedup, load-shedding, a drain on SIGTERM.
Either package's client talks to it.

Exit codes, as ``plaid-compile``: 0 success, 1 a verification failed, a
golden regression, a store miss (or nothing to verify), 2 usage error or
no such device, and the taxonomy's codes 10+
(:mod:`repro_torch.compiler.errors`; 10 when the batched verdicts diverge
from the scalar oracle under ``--parity``, 12 a ``--deadline-s`` timeout,
17 a farm that shed the request, 18 a farm that cannot be reached).
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
from repro_torch.compiler.pipeline import (
    compile_key,
    compile_workload,
    job_grid,
    list_archs,
    list_mappers,
)
from repro_torch.compiler.registry import MAPPERS, RegistryError
from repro_torch.compiler.store import (
    VERIFY_POLICIES,
    ArtifactStore,
    CompileKey,
    key_for,
)


# -- golden II diffing -------------------------------------------------------


def diff_ii_maps(
    results: Dict[str, Dict[str, Optional[int]]],
    golden: Dict[str, Dict[str, Optional[int]]],
    *,
    require_all: bool = True,
) -> int:
    """Compare ``{workload key: {job: ii}}`` maps; returns the number of
    regressions (higher II, or unmapped where the golden run mapped) and
    prints a per-cell diff table for every difference.  ``require_all=False``
    skips golden workloads absent from ``results`` (partial runs / single
    artifacts)."""
    bad = better = same = skipped = 0
    rows: List[tuple] = []  # (workload, job, golden, got, status)
    for key, want_ii in sorted(golden.items()):
        rec = results.get(key)
        if rec is None:
            if require_all:
                rows.append((key, "*", "-", "missing", "MISSING"))
                bad += 1
            else:
                skipped += 1
            continue
        for job, want in sorted(want_ii.items()):
            if job not in rec:
                if require_all:
                    # a full results cache must cover every golden job
                    rows.append((key, job, want, "missing", "MISSING"))
                    bad += 1
                else:
                    skipped += 1  # partial artifact view: job not exercised
                continue
            got = rec[job]
            if want is None:
                same += 1  # golden found nothing; anything is no worse
            elif got is None:
                rows.append((key, job, want, "None", "REGRESSION"))
                bad += 1
            elif got > want:
                rows.append((key, job, want, got, "REGRESSION"))
                bad += 1
            elif got < want:
                rows.append((key, job, want, got, "improved"))
                better += 1
            else:
                same += 1
    if rows:
        header = ("workload", "job", "golden II", "got II", "status")
        table = [header] + [tuple(str(c) for c in r) for r in rows]
        widths = [max(len(r[i]) for r in table) for i in range(len(header))]
        for i, r in enumerate(table):
            print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
            if i == 0:
                print("  ".join("-" * w for w in widths))
    for key, rec in sorted(results.items()):
        extra = [j for j in rec if key not in golden or j not in golden[key]]
        for j in extra:
            print(f"note {key}/{j}: no golden entry (skipped)")
    print(f"ii-diff: {same} identical, {better} improved, {bad} regressed, "
          f"{skipped} skipped")
    return bad


def _job_of(artifact: CompileResult) -> str:
    """Grid job name for an artifact's (arch, mapper) pair; falls back to a
    ``mapper@arch`` label for off-grid combinations."""
    rev = {am: job for job, am in job_grid().items()}
    return rev.get((artifact.arch, artifact.mapper),
                   f"{artifact.mapper}@{artifact.arch}")


def load_ii_results(path: str) -> Dict[str, Dict[str, Optional[int]]]:
    """Build a ``{workload key: {job: ii}}`` map from any supported source:
    a directory of artifacts, a single artifact, or a collect results
    cache (``{key: {"ii": {job: ii}}}``, or a bare golden-format map)."""
    if os.path.isdir(path):
        out: Dict[str, Dict[str, Optional[int]]] = {}
        for fn in sorted(os.listdir(path)):
            fp = os.path.join(path, fn)
            if not fn.endswith(".json"):
                continue
            if not _is_artifact(fp):
                print(f"note {fp}: not a {ARTIFACT_SCHEMA} artifact (skipped)")
                continue
            _merge_artifact(out, fp)
        return out
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") in SUPPORTED_SCHEMAS:
        out = {}
        _merge_artifact(out, path)
        return out
    return {
        key: dict(rec["ii"]) if "ii" in rec else dict(rec)
        for key, rec in data.items()
        if isinstance(rec, dict)
    }


def _merge_artifact(out: Dict[str, Dict[str, Optional[int]]], path: str):
    art = CompileResult.load(path)
    out.setdefault(art.key, {})[_job_of(art)] = art.ii


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


# -- compile / inspect / diff ------------------------------------------------


def _device_error(args) -> Optional[str]:
    """Why ``args.device`` cannot run the cycle loop (no card, a misnamed
    device), or ``None``: a verifying subcommand refuses before any
    place & route."""
    from repro_torch.sim.batch import select_backend

    try:
        select_backend(None, args.device)
    except (RuntimeError, ValueError) as e:
        return str(e)
    return None


def _cmd_list(args) -> int:
    grid = job_grid()
    print("mappers:")
    for name in list_mappers():
        desc = MAPPERS.meta(name).get("description", "")
        print(f"  {name:14s} {desc}")
    print("architectures:")
    for name in list_archs():
        print(f"  {name}")
    print("job grid (job: arch x mapper):")
    for job, (arch, mapper) in grid.items():
        print(f"  {job:14s} {arch} x {mapper}")
    return 0


def _compile_one(args, arch: str, mapper: str, job: Optional[str],
                 store: Optional[ArtifactStore] = None) -> CompileResult:
    t0 = time.perf_counter()
    res = compile_workload(
        args.workload,
        arch=arch,
        mapper=mapper,
        seed=args.seed,
        budget=args.budget,
        unroll=args.unroll,
        iterations=args.iterations,
        verify=args.verify,
        store=store,
        remote=args.remote,
        deadline_s=args.deadline_s,
        fallback_mapper=args.fallback_mapper,
        device=args.device,
    )
    tag = job or f"{mapper}@{arch}"
    status = f"II={res.ii}" if res.ii is not None else "UNMAPPED"
    if res.degraded:
        status += (f" DEGRADED({res.degraded['reason']} -> "
                   f"{res.degraded['fallback']})")
    if res.spatial:
        status += f" segments={res.spatial['segments']}"
    if res.verified is not None:
        status += " verified" if res.verified else " VERIFY-FAILED"
    if res.store_hit is not None:
        status += " [store hit]" if res.store_hit else " [store miss]"
    # THIS invocation's wall time: on a store hit, res.timings carries the
    # original compile's P&R time, which is not what just happened here
    print(f"{res.key:16s} {tag:14s} {status} "
          f"cycles={res.cycles} ({time.perf_counter() - t0:.2f}s)")
    return res


def _cmd_compile(args) -> int:
    if args.verify:
        why = _device_error(args)
        if why:
            print(f"error: {why}", file=sys.stderr)
            return 2
    grid = job_grid()
    store = (ArtifactStore(args.store, device=args.device) if args.store
             else None)
    if args.all_jobs:
        if args.out:
            print("--out is per-artifact; use --out-dir with --all-jobs",
                  file=sys.stderr)
            return 2
        out_dir = args.out_dir or "artifacts"
        rc = 0
        for job, (arch, mapper) in grid.items():
            res = _compile_one(args, arch, mapper, job, store)
            res.save(os.path.join(out_dir, f"{res.key}__{job}.json"))
            if res.verified is False:
                rc = 1
        return rc
    if args.job is not None:
        if args.job not in grid:
            print(f"unknown job {args.job!r}; grid jobs: "
                  + ", ".join(grid), file=sys.stderr)
            return 2
        arch, mapper = grid[args.job]
    else:
        arch, mapper = args.arch, args.mapper
    res = _compile_one(args, arch, mapper, args.job, store)
    if args.out:
        res.save(args.out)
    elif args.out_dir:
        job = args.job or _job_of(res)
        res.save(os.path.join(args.out_dir, f"{res.key}__{job}.json"))
    return 1 if res.verified is False else 0


def _stage_line(art: CompileResult) -> Optional[str]:
    """One-line place/route/negotiate split + per-pass breakdown +
    route-cache hit rate, for artifacts that recorded them."""
    tm = art.timings
    if "place" not in tm and not art.route_cache and not art.pass_stats:
        return None  # no split recorded
    parts = []
    for stage in ("place", "route", "negotiate"):
        if stage in tm:
            parts.append(f"{stage}={tm[stage]:.3f}s")
    if art.pass_stats:
        parts.append("passes[" + " ".join(
            f"{p['name']}={p.get('wall_s', 0.0):.3f}s"
            f"/{p.get('calls', 0)}x" for p in art.pass_stats) + "]")
    if art.route_cache:
        rc_ = art.route_cache
        parts.append(
            f"route-cache {100.0 * rc_.get('hit_rate', 0.0):.1f}% hits "
            f"({rc_.get('hits_exact', 0)} exact + "
            f"{rc_.get('hits_scoped', 0)} scoped / "
            f"{rc_.get('misses', 0)} misses)"
        )
        fo = rc_.get("fanout")
        if fo and fo.get("edges"):
            layers = fo.get("layers_built", 0) + fo.get("layers_reused", 0)
            parts.append(
                f"fanout {fo['edges']} edges/{fo.get('batches', 0)} batches"
                f" (layers {fo.get('layers_reused', 0)}/{layers} shared)"
            )
    return "  ".join(parts)


def _cmd_inspect(args) -> int:
    if args.verify:
        why = _device_error(args)
        if why:
            print(f"error: {why}", file=sys.stderr)
            return 2
    rc = 0
    for path in args.artifacts:
        art = CompileResult.load(path)
        print(json.dumps(art.summary(), indent=1))
        stages = _stage_line(art)
        if stages:
            print(f"{path}: {stages}")
        if args.verify:
            if not art.mappings:
                print(f"{path}: no stored mapping to verify")
                rc = 1
                continue
            try:
                art.simulate(iterations=args.iterations, device=args.device)
                print(f"{path}: re-simulated {len(art.mappings)} mapping(s) "
                      "against the DFG oracle OK (no P&R re-run)")
            except VERIFY_FAILURES as e:
                # the taxonomy's bounded disproven-mapping list; a device
                # fault (SimulationFault) is not on it and propagates
                print(f"{path}: VERIFY FAILED: {type(e).__name__}: {e}")
                rc = 1
    return rc


def _cmd_diff(args) -> int:
    if args.golden:
        with open(args.golden) as f:
            golden = json.load(f)
        results: Dict[str, Dict[str, Optional[int]]] = {}
        for path in args.paths:
            for key, jobs in load_ii_results(path).items():
                results.setdefault(key, {}).update(jobs)
        if golden and not results:
            print("no artifacts/results found to diff against the golden "
                  "file — refusing to pass an empty comparison",
                  file=sys.stderr)
            return 1
        require_all = any(
            not os.path.isdir(p) and not _is_artifact(p) for p in args.paths
        )
        bad = diff_ii_maps(results, golden, require_all=require_all)
        return 1 if bad else 0
    if len(args.paths) != 2:
        print("diff needs exactly two artifacts (or --golden)", file=sys.stderr)
        return 2
    a = CompileResult.load(args.paths[0])
    b = CompileResult.load(args.paths[1])
    diffs: List[str] = []
    for fld in ("key", "arch", "mapper", "seed", "ii", "cycles", "makespan"):
        va, vb = getattr(a, fld), getattr(b, fld)
        if va != vb:
            diffs.append(f"{fld}: {va} != {vb}")
    for i, (ra, rb) in enumerate(zip(a.mappings, b.mappings)):
        for fld in ("place", "time", "routes"):
            if ra[fld] != rb[fld]:
                diffs.append(f"mapping[{i}].{fld} differs")
    if len(a.mappings) != len(b.mappings):
        diffs.append(f"segments: {len(a.mappings)} != {len(b.mappings)}")
    if diffs:
        for d in diffs:
            print(d)
        return 1
    print("artifacts identical (mapping, II, cycles)")
    return 0


# -- batched verification ----------------------------------------------------


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
    return ArtifactStore(
        args.dir,
        verify=getattr(args, "verify_policy", None) or "never",
        max_bytes=getattr(args, "max_bytes", None),
        device=getattr(args, "device", None),
    )


def _key_from_args(args):
    if getattr(args, "job", None):
        grid = job_grid()
        if args.job not in grid:
            raise KeyError(f"unknown job {args.job!r}; grid jobs: "
                           + ", ".join(grid))
        arch, mapper = grid[args.job]
    else:
        arch, mapper = args.arch, args.mapper
    return compile_key(
        args.workload, arch=arch, mapper=mapper, seed=args.seed,
        budget=args.budget, unroll=args.unroll,
        iterations=getattr(args, "iterations", None),
    )


def _cmd_store_get(args) -> int:
    if args.verify_policy != "never":
        why = _device_error(args)
        if why:
            print(f"error: {why}", file=sys.stderr)
            return 2
    store = _open_store(args)
    try:
        key = _key_from_args(args)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    res = store.get(key)
    if res is None:
        why = ("integrity/verification check failed — entry quarantined"
               if store.counters.rejected or store.counters.verify_failures
               else "not in store")
        print(f"MISS  {key.describe()}  ({why})", file=sys.stderr)
        return 1
    print(f"HIT   {key.describe()}  II={res.ii} cycles={res.cycles} "
          f"(served without P&R)")
    if args.out:
        res.save(args.out)
        print(f"wrote {args.out}")
    return 0


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


def _cmd_store_warm(args) -> int:
    """Batch-compile a workload x job grid into the store.  Already-stored
    cells are hits (no P&R), so re-warming after adding a mapper or
    workload only compiles the new cells."""
    from repro_torch.core.workloads import (TABLE2, quick_workloads,
                                            workloads_by_keys)

    store = _open_store(args)
    table = quick_workloads() if args.quick else TABLE2
    if args.workloads:
        try:
            table = workloads_by_keys(table, args.workloads.split(","))
        except KeyError as e:
            print(str(e), file=sys.stderr)
            return 2
    grid = job_grid()
    if args.job:
        if args.job not in grid:
            print(f"unknown job {args.job!r}; grid jobs: " + ", ".join(grid),
                  file=sys.stderr)
            return 2
        grid = {args.job: grid[args.job]}
    for w in table:
        for job, (arch, mapper) in grid.items():
            res = compile_workload(w, arch=arch, mapper=mapper,
                                   seed=args.seed, store=store)
            state = "hit " if res.store_hit else "warm"
            print(f"{state}  {w.name}_u{w.unroll:<3} {job:14s} II={res.ii} "
                  f"cycles={res.cycles}", flush=True)
    c = store.counters
    print(f"warm done: {c.puts} compiled+stored, {c.hits} already present, "
          f"{c.evictions} evicted")
    return 0


def _cmd_serve(args) -> int:
    """Run the compile-farm daemon (blocks until SIGTERM/SIGINT drain);
    refused, exit 2, when ``--device`` cannot run the cycle loop."""
    from repro_torch.serve_farm.daemon import serve

    why = _device_error(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    return serve(
        args.dir, args.socket,
        workers=args.workers,
        queue_limit=args.queue_limit,
        default_deadline_s=args.deadline_s,
        retries=args.retries,
        start_method=args.start_method,
        device=args.device,
    )


def _cmd_store(args) -> int:
    return {
        "get": _cmd_store_get,
        "put": _cmd_store_put,
        "ls": _cmd_store_ls,
        "gc": _cmd_store_gc,
        "warm": _cmd_store_warm,
    }[args.store_cmd](args)


def _is_artifact(path: str) -> bool:
    try:
        with open(path) as f:
            return json.load(f).get("schema") in SUPPORTED_SCHEMAS
    except (OSError, ValueError):
        return False


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Plaid CGRA toolchain, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _device_arg(p, what):
        p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                       help=f"where {what} runs the cycle loop (default "
                            "cuda; refused, with no fallback, when there is "
                            "no card)")

    sub.add_parser("list", help="registered mappers/arches and the job grid")

    c = sub.add_parser("compile", help="compile one workload to an artifact")
    c.add_argument("workload", help="TABLE2 workload name, e.g. atax")
    c.add_argument("-u", "--unroll", type=int, default=None)
    c.add_argument("--arch", default="plaid2x2")
    c.add_argument("--mapper", default="hierarchical")
    c.add_argument("--job", default=None,
                   help="pick (arch, mapper) from the evaluation grid")
    c.add_argument("--all-jobs", action="store_true",
                   help="sweep every grid job into --out-dir")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--budget", type=int, default=None,
                   help="SA/negotiation step budget (default: mapper default)")
    c.add_argument("--iterations", type=int, default=None,
                   help="loop trip count for cycle totals")
    c.add_argument("--verify", action="store_true",
                   help="cycle-accurately simulate the mapping after P&R")
    _device_arg(c, "--verify")
    c.add_argument("--out", default=None, help="artifact output path")
    c.add_argument("--out-dir", default=None,
                   help="directory for artifacts (name derived from key/job)")
    c.add_argument("--store", default=None, metavar="DIR",
                   help="artifact store: serve a cached mapping without "
                        "P&R, insert on miss")
    c.add_argument("--remote", default=None, metavar="SOCKET",
                   help="python -m repro_torch serve socket: offload cache "
                        "misses to the farm daemon (retries with backoff; "
                        "falls back to a local compile when unreachable)")
    c.add_argument("--deadline-s", type=float, default=None, metavar="S",
                   help="wall-clock P&R deadline; exceeding it raises "
                        "CompileTimeout (exit code 12) unless "
                        "--fallback-mapper is given")
    c.add_argument("--fallback-mapper", default=None, metavar="NAME",
                   help="degrade gracefully: on timeout/infeasibility, "
                        "re-run with this mapper and stamp the artifact "
                        "as degraded instead of failing")

    i = sub.add_parser("inspect", help="summarize (and optionally re-verify)")
    i.add_argument("artifacts", nargs="+")
    i.add_argument("--verify", action="store_true",
                   help="re-simulate the stored mapping (no P&R re-run)")
    i.add_argument("--iterations", type=int, default=3)
    _device_arg(i, "--verify")

    d = sub.add_parser("diff", help="artifact vs artifact, or vs --golden")
    d.add_argument("paths", nargs="+",
                   help="artifacts, artifact dirs, or a collect results.json")
    d.add_argument("--golden", default=None, help="golden II JSON file")
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

    g = ssub.add_parser("get", help="fetch one mapping (no P&R)")
    _dir_arg(g)
    g.add_argument("workload")
    g.add_argument("-u", "--unroll", type=int, default=None)
    g.add_argument("--arch", default="plaid2x2")
    g.add_argument("--mapper", default="hierarchical")
    g.add_argument("--job", default=None,
                   help="pick (arch, mapper) from the evaluation grid")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--budget", type=int, default=None)
    g.add_argument("--iterations", type=int, default=None,
                   help="loop trip count the artifact was compiled with "
                        "(part of the key; default: workload default)")
    g.add_argument("--verify-policy", choices=VERIFY_POLICIES,
                   default="never",
                   help="re-simulate the served mapping: never/first/always")
    _device_arg(g, "a verifying get")
    g.add_argument("--out", default=None, help="write the artifact here")

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

    wm = ssub.add_parser("warm", help="batch-compile a workload grid into "
                                      "the store")
    _dir_arg(wm)
    wm.add_argument("--quick", action="store_true",
                    help="quick_workloads() slice instead of full TABLE2")
    wm.add_argument("--workloads", default=None,
                    help="comma-separated <name>_u<unroll> keys")
    wm.add_argument("--job", default=None, help="restrict to one grid job")
    wm.add_argument("--seed", type=int, default=0)

    sv = sub.add_parser("serve",
                        help="compile-farm daemon over a Unix socket "
                             "(cache-first, dedup, load-shedding, "
                             "SIGTERM drain)")
    sv.add_argument("--dir", default="artifacts/store",
                    help="artifact store the farm serves from and compiles "
                         "into (default artifacts/store)")
    sv.add_argument("--socket", required=True, metavar="PATH",
                    help="Unix-domain socket path to listen on")
    sv.add_argument("--workers", type=int, default=2,
                    help="supervised compile worker threads (default 2)")
    sv.add_argument("--queue-limit", type=int, default=8,
                    help="max queued+running jobs before load-shedding "
                         "with ServiceOverloaded (default 8)")
    sv.add_argument("--deadline-s", type=float, default=600.0, metavar="S",
                    help="per-request compile deadline when the client "
                         "sends none (default 600)")
    sv.add_argument("--retries", type=int, default=1,
                    help="re-attempts for crashed compile workers "
                         "(default 1)")
    sv.add_argument("--start-method", default=None,
                    choices=("fork", "spawn", "forkserver"),
                    help="worker multiprocessing start method (default: "
                         "platform; forkserver when --device is a card)")
    _device_arg(sv, "the farm (verifying hits and its workers' compiles)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    """Exit codes: 0 success, 1 generic failure (verify failed, regression,
    miss), 2 usage error or no such device; taxonomy failures map to their own codes 10+
    (:func:`~repro_torch.compiler.errors.exit_code_for`).  Anything else
    — a device fault above all — propagates, as in the JAX package."""
    args = build_parser().parse_args(argv)
    handler = {
        "list": _cmd_list,
        "compile": _cmd_compile,
        "inspect": _cmd_inspect,
        "diff": _cmd_diff,
        "verify": _cmd_verify,
        "store": _cmd_store,
        "serve": _cmd_serve,
    }[args.cmd]
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
