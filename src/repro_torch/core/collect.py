"""The paper's evaluation sweep: every TABLE2 workload x job-grid cell into
one JSON results cache (port of ``repro/core/collect.py``).

Run:  PYTHONPATH=src python -m repro_torch.core.collect --out PATH
          [--device cuda|cpu]

Per workload: II + cycles on Plaid 2x2 / ST 4x4 / spatial 4x4 (Figs. 12,
14, 15), Plaid 3x3 (Fig. 17), mapper comparison on Plaid (Fig. 18:
PathFinder / node-level / hierarchical), ML-specialized variants (Fig. 19),
motif coverage (Table 2), and the per-mapping simulator verification of
the ``plaid`` and ``st`` cells on ``device`` (``cuda`` unless the caller
asks for the CPU; one ``sim_loop`` launch a verifying cell on a card).

Each cell is dispatched through the **supervised runner**
(:class:`repro_torch.core.runner.SupervisedRunner`, ``--jobs`` worker
slots, default = CPU count): every cell attempt runs in its own process, a
cell past ``--cell-timeout`` is terminated and recorded, a worker that
dies is detected and retried, and a cell that exhausts its attempts lands
in the workload record as a **structured failure**
(``rec["failures"][job]``) instead of aborting the sweep.  Workers on a
card start from a ``forkserver``, never forked from a process that holds a
CUDA context (:func:`repro_torch.core.runner.start_method_for`).  Every
mapper runs at a fixed seed, so the records are the JAX package's, field
for field, but for wall time.

Resume-from-JSON is failure-aware: complete workloads in ``--out`` are
skipped, workloads with recorded failures re-attempt **only the failed
cells**, and the cache is rewritten atomically after each workload.
``--out`` has no default and ``--bench-out`` none either: a run's
wall-clock entry is appended only to a trajectory the caller names,
under a bounded lock (a dead lock-holder strands the entry into a
``*.stranded-*`` sidecar, and the next successful locked append merges
any sidecars back).

``--remote <socket>`` offloads cache misses to a ``python -m repro_torch
serve`` farm daemon (:mod:`repro_torch.serve_farm`): cells are served
from the farm's store when warm, compiled farm-side when cold, and fall
back to local compiles when the farm is unreachable.  Farm throughput
(served cells/sec, daemon counters) rides in the bench entry under
``farm``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler import faultinject
from repro_torch.compiler.errors import LockTimeout
from repro_torch.compiler.fsio import (
    atomic_write_json,
    load_json_or_quarantine,
    locked,
)
from repro_torch.compiler.pipeline import compile_workload, job_grid
from repro_torch.compiler.registry import MAPPERS
from repro_torch.core.motifs import (
    generate_motifs,
    motif_cover_stats,
    validate_cover,
)
from repro_torch.core.runner import SupervisedRunner
from repro_torch.core.workloads import (
    TABLE2,
    build_workload,
    quick_workloads,
    workload_by_name,
    workloads_by_keys,
)
from repro_torch.device import resolve_device

#: bounded wait for the bench-trajectory lock (a finished run must not
#: hang forever behind a dead lock-holder; see _append_bench)
BENCH_LOCK_TIMEOUT_S = 10.0
#: comma-separated module names every worker imports before compiling —
#: the spawn-safe registration channel (see _ensure_registrations)
PLUGINS_VAR = "REPRO_PLUGINS"

# The evaluation grid is derived from the mapper registry (``jobs``
# metadata on each registered mapper), not hard-coded: ``collect()`` and
# ``run_job`` re-derive it at call time, so registrations made after this
# module is imported are still swept.  Workers re-derive registrations
# under EVERY start method: built-ins register when the worker imports the
# pipeline, and runtime registrations travel through ``REPRO_PLUGINS`` —
# a comma-separated module list each worker imports first (under ``fork``
# inherited registrations make this redundant; under ``spawn`` and
# ``forkserver`` it is the only channel).  "spatial" keeps its dedicated
# results slot; "motifs" is an analysis pass, not a mapper job.


def _ensure_registrations():
    """Populate the mapper/arch registries inside a worker process.

    Importing the pipeline registers every built-in; modules named in
    ``REPRO_PLUGINS`` are imported afterwards so runtime registrations
    (plug-in mappers/arches) exist under ``spawn`` and ``forkserver`` too,
    where workers do not inherit the parent's interpreter state.
    """
    import repro_torch.compiler.pipeline  # noqa: F401  (registers built-ins)

    for mod in os.environ.get(PLUGINS_VAR, "").split(","):
        mod = mod.strip()
        if mod:
            importlib.import_module(mod)


def _spatial_jobs() -> Dict[str, Tuple[str, str]]:
    """Grid jobs whose mapper is marked ``result="spatial"`` in the registry
    (classified by metadata, not by job-name string)."""
    return {
        job: pair for job, pair in job_grid().items()
        if MAPPERS.meta(pair[1]).get("result") == "spatial"
    }


def mapper_jobs() -> Dict[str, Tuple[str, str]]:
    sp = _spatial_jobs()
    return {job: pair for job, pair in job_grid().items() if job not in sp}


class ResultsSchemaError(RuntimeError):
    """The registered job grid cannot be represented in the results.json
    schema (e.g. a second spatial-style mapper)."""


def job_names():
    sp = list(_spatial_jobs())
    # the results.json schema has exactly one dedicated "spatial" slot
    # (paper Figs. 12/15); fail loudly rather than misfile a second
    # spatial-style mapper's cells under the modulo-mapper columns (a
    # real exception: asserts vanish under `python -O`)
    if sp != ["spatial"]:
        raise ResultsSchemaError(
            f"results schema supports exactly one spatial job named "
            f"'spatial'; registered spatial-style jobs: {sp}"
        )
    return ["motifs", "spatial"] + list(mapper_jobs())


VERIFY_JOBS = ("plaid", "st")  # functional verification of headline mappings


def _cell_key(wname: str, unroll: int) -> str:
    return f"{wname}_u{unroll}"


def run_job(task: Tuple[str, int, str, Optional[str], Optional[str],
                        Optional[str]]):
    """One grid cell: compile one workload with one registered mapper/arch
    pair (or run the motif analysis).  Returns a small picklable payload.

    ``task`` is ``(workload, unroll, job, store path, remote socket,
    device)``: the device travels with the task, and the verifying cells
    prove their mapping there (a card that cannot be reached raises: the
    cell's failure, never a compile on the CPU).

    Runs inside a supervised worker process: registrations are re-derived
    first (start-method independent, see :func:`_ensure_registrations`)
    and the fault-injection ``worker`` site fires here, so chaos tests
    can crash/hang exactly one labelled cell.

    A non-``None`` store path makes every compile cache-first: a warm
    store serves the mapping without place & route, and the payload's
    ``store_hit`` records which way the cell went (the motif analysis is
    pure graph analytics and carries no flag).
    """
    wname, unroll, job = task[0], task[1], task[2]
    store_path = task[3] if len(task) > 3 else None
    remote = task[4] if len(task) > 4 else None
    device = task[5] if len(task) > 5 else None
    _ensure_registrations()
    faultinject.check("worker", f"{_cell_key(wname, unroll)}/{job}")
    store = None
    if store_path is not None:
        from repro_torch.compiler.store import ArtifactStore

        store = ArtifactStore(store_path, device=device)
    w = workload_by_name(wname, unroll)
    t0 = time.time()
    out: Dict[str, object] = {}
    if job == "motifs":
        g = build_workload(w)
        motifs, standalone = generate_motifs(g, seed=1)
        validate_cover(g, motifs, standalone)
        out["motifs"] = motif_cover_stats(g, motifs)
        strict, _ = generate_motifs(g, seed=1, feasibility="strict")
        out["motifs_strict_covered"] = motif_cover_stats(g, strict)["covered"]
    elif job in _spatial_jobs():
        arch_name, mapper_name = job_grid()[job]
        res = compile_workload(w, arch=arch_name, mapper=mapper_name, seed=0,
                               store=store, remote=remote, device=device)
        out["spatial"] = res.spatial
        out["cycles"] = res.cycles
    else:
        arch_name, mapper_name = mapper_jobs()[job]
        res = compile_workload(
            w, arch=arch_name, mapper=mapper_name, seed=0,
            verify=job in VERIFY_JOBS, store=store, remote=remote,
            device=device,
        )
        out["ii"] = res.ii
        out["cycles"] = res.cycles
        if res.route_cache:
            out["route_cache"] = res.route_cache
        if job in VERIFY_JOBS:
            out["verified"] = bool(res.verified)
    if (store is not None or remote is not None) and job != "motifs":
        out["store_hit"] = bool(res.store_hit)
    out["wall_s"] = time.time() - t0
    return _cell_key(w.name, w.unroll), job, out


def _task_label(task) -> str:
    return f"{_cell_key(task[0], task[1])}/{task[2]}"


def _finalize(w, parts: Dict[str, Dict], grid_jobs,
              failures: Optional[Dict[str, Dict]] = None) -> Dict:
    """Assemble one workload record from its per-job parts.

    Tolerates failed/missing parts: every schema slot a missing job would
    have filled holds ``None`` (``ii``/``cycles`` keep a key per grid job
    so golden diffs see an explicit regression, not a hole), and the
    per-cell failure records ride along under ``"failures"``.
    """
    failures = failures or {}
    motifs = parts.get("motifs")
    sp = parts.get("spatial")
    rec = {
        "domain": w.domain,
        "iterations": w.iterations,
        "total": w.total,
        "compute": w.compute,
        "covered_paper": w.covered_paper,
        "motifs": motifs["motifs"] if motifs else None,
        "motifs_strict_covered":
            motifs["motifs_strict_covered"] if motifs else None,
        "ii": {j: (parts[j]["ii"] if j in parts else None)
               for j in grid_jobs},
        "cycles": {j: (parts[j]["cycles"] if j in parts else None)
                   for j in grid_jobs},
        "spatial": sp["spatial"] if sp else None,
        "verified": {j: parts[j]["verified"]
                     for j in VERIFY_JOBS if j in parts},
        "wall_s": round(
            sum(p["wall_s"] for p in parts.values())
            + sum(f.get("wall_s", 0.0) for f in failures.values()), 1),
    }
    rec["cycles"]["spatial"] = sp["cycles"] if sp else None
    hits = sum(
        p["route_cache"]["hits_exact"] + p["route_cache"]["hits_scoped"]
        for p in parts.values() if "route_cache" in p
    )
    misses = sum(
        p["route_cache"]["misses"]
        for p in parts.values() if "route_cache" in p
    )
    if hits or misses:
        rec["route_cache"] = {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4),
        }
    st_hits = sum(1 for p in parts.values() if p.get("store_hit") is True)
    st_miss = sum(1 for p in parts.values() if p.get("store_hit") is False)
    if st_hits or st_miss:
        rec["store"] = {"hits": st_hits, "misses": st_miss}
    if failures:
        rec["failures"] = failures
    return rec


def _append_bench(bench_path: str, entry: Dict,
                  lock_timeout_s: float = BENCH_LOCK_TIMEOUT_S):
    """Append one run entry to the bench trajectory.

    Concurrent appenders (a ``collect`` run racing ``scripts/ci.sh``'s
    perf smoke, or two collects) serialize on an exclusive ``flock`` so
    the read-modify-write cannot lose entries; the write itself is atomic
    (temp file + ``os.replace``), and a truncated/corrupt trajectory file
    is quarantined and restarted instead of raising ``JSONDecodeError``
    after a full collect run.

    The lock wait is **bounded**: a lock-holder that died (or hung) mid-
    append must not strand a finished run forever.  On timeout the entry
    is written to a ``<bench>.stranded-<pid>-<ts>.json`` sidecar with a
    warning — recoverable data beats an indefinite hang.  The next
    successful locked append **reclaims** any sidecars: their runs merge
    back into the trajectory (exact-duplicate entries are skipped, so a
    crash between merge and unlink cannot double-count) and the sidecar
    files are removed.
    """
    try:
        with locked(bench_path, timeout_s=lock_timeout_s):
            data = load_json_or_quarantine(bench_path, {"runs": []})
            if not isinstance(data, dict):
                data = {"runs": []}
            runs = data.setdefault("runs", [])
            reclaimed = _reclaim_stranded(bench_path, runs)
            runs.append(entry)
            atomic_write_json(bench_path, data, indent=1)
            for sidecar in reclaimed:
                try:
                    os.unlink(sidecar)
                except OSError:
                    pass
            if reclaimed:
                print(f"bench: reclaimed {len(reclaimed)} stranded "
                      f"sidecar(s) into {bench_path}", flush=True)
    except LockTimeout:
        sidecar = f"{bench_path}.stranded-{os.getpid()}-{int(time.time())}.json"
        atomic_write_json(sidecar, {"runs": [entry]}, indent=1)
        print(
            f"warning: bench lock on {bench_path} not acquired within "
            f"{lock_timeout_s}s (dead lock-holder?); entry preserved in "
            f"{sidecar}", flush=True,
        )


def _reclaim_stranded(bench_path: str, runs: List[Dict]) -> List[str]:
    """Merge ``<bench>.stranded-*.json`` sidecars (orphaned by an earlier
    bench-lock timeout) into ``runs``; returns the sidecar paths to
    unlink once the merged trajectory is safely written.  Unreadable
    sidecars are left in place for inspection."""
    import glob

    reclaimed: List[str] = []
    for sidecar in sorted(glob.glob(glob.escape(bench_path)
                                    + ".stranded-*.json")):
        try:
            with open(sidecar) as f:
                side = json.load(f)
        except (OSError, ValueError):
            continue
        side_runs = side.get("runs") if isinstance(side, dict) else None
        if not isinstance(side_runs, list):
            continue
        for run in side_runs:
            if run not in runs:
                runs.append(run)
        reclaimed.append(sidecar)
    return reclaimed


def _batch_verify_store(store_path: str, iterations: int = 3,
                        device=None) -> Dict:
    """Post-sweep verification sweep: pull every mapped artifact out of
    the store and re-verify the whole collection through one
    :func:`repro_torch.sim.batch.simulate_batch` call on ``device`` (one
    ``sim_loop`` launch a bucket on a card), returning summary stats for
    the bench entry.  A failed verdict here means a corrupt or
    miscompiled artifact survived the sweep — it is reported per artifact,
    not raised; a device fault propagates."""
    from repro_torch.compiler.store import ArtifactStore
    from repro_torch.sim.batch import simulate_batch

    store = ArtifactStore(store_path, device=device)
    mappings, labels = [], []
    for key, art in store.iter_artifacts():
        if not art.mappings:
            continue
        try:
            ms = art.rebuild_mappings()
        except Exception as e:
            print(f"batch-verify: {key.describe()}: unloadable mapping "
                  f"({type(e).__name__}: {e})", flush=True)
            continue
        for s, m in enumerate(ms):
            mappings.append(m)
            labels.append(f"{key.describe()}[{s}]")
    if not mappings:
        return {"mappings": 0, "failed": 0}
    result = simulate_batch(mappings, iterations=iterations, device=device)
    failed = 0
    for label, v in zip(labels, result):
        if not v.ok:
            failed += 1
            print(f"batch-verify FAIL {label}: {v.reason}", flush=True)
    print(f"batch-verify[{result.backend}]: {len(mappings)} mapping(s), "
          f"{failed} failure(s), "
          f"{result.mappings_per_s:.0f} mappings/s", flush=True)
    return {
        "backend": result.backend,
        "mappings": len(mappings),
        "failed": failed,
        "scalar_fallbacks": result.n_scalar_fallback,
        "mappings_per_s": round(result.mappings_per_s, 1),
    }


def collect(out_path: str, quick: bool = False, jobs: int = 0,
            bench_path: Optional[str] = None, bench_note: str = "",
            store_path: Optional[str] = None,
            workloads: Optional[List[str]] = None,
            cell_timeout_s: Optional[float] = None,
            retries: int = 1,
            start_method: Optional[str] = None,
            plugins: Optional[List[str]] = None,
            batch_verify: bool = False,
            remote: Optional[str] = None,
            device=None):
    """Run the (workload x job) grid; see module docstring.

    ``device`` is where the verifying cells and ``batch_verify`` run the
    cycle loop: ``cuda`` unless the caller passes ``"cpu"``, resolved
    before anything runs (:func:`repro_torch.device.resolve_device` raises
    when there is no card).  ``bench_path`` names the trajectory the run's
    entry is appended to (``None``: none is written).

    ``store_path`` routes every compile through the artifact store at that
    path (cache-first: a warm store serves the whole grid with **zero**
    place & route; hit/miss counts land in each record and in the bench
    entry).  ``workloads`` restricts the sweep to the named
    ``<name>_u<unroll>`` keys.  ``batch_verify`` re-verifies every stored
    mapping after the sweep through one ``simulate_batch`` call (requires
    ``store_path``); its stats land in the bench entry under
    ``sim_verify``.  ``remote`` (a farm daemon's socket path) offloads
    cache misses to the farm.

    Supervision knobs: ``cell_timeout_s`` is the hard wall-clock limit per
    cell (``None`` = unlimited), ``retries`` bounds re-attempts of crashed
    workers / transient errors, ``start_method`` picks the multiprocessing
    start method (``None`` = the platform default, ``forkserver`` when the
    device is a card), and ``plugins`` names modules every worker imports
    first so runtime mapper/arch registrations survive ``spawn``.  A cell
    that exhausts its attempts becomes a structured failure record in its
    workload's results entry (``rec["failures"][job]``); the sweep itself
    always completes, and a later run against the same ``out_path``
    re-attempts exactly the failed cells.
    """
    device = str(resolve_device(device))
    if plugins:
        os.environ[PLUGINS_VAR] = ",".join(plugins)
        _ensure_registrations()  # the parent derives the grid from them too
    # resume: a torn cache from an interrupted run is quarantined and the
    # sweep restarts, instead of dying on JSONDecodeError
    results = load_json_or_quarantine(out_path, {})
    if not isinstance(results, dict):
        results = {}
    table = quick_workloads() if quick else TABLE2
    if workloads is not None:
        table = workloads_by_keys(table, workloads)
    grid_jobs = mapper_jobs()  # call-time: sweeps late registrations too
    names = job_names()

    # failure-aware resume: complete records are skipped; records carrying
    # failures re-attempt only the jobs whose parts are missing, seeding
    # the merge with the successful parts stored alongside the failures
    pending: List = []
    pending_jobs: Dict[str, List[str]] = {}
    seed_parts: Dict[str, Dict[str, Dict]] = {}
    for w in table:
        key = _cell_key(w.name, w.unroll)
        rec = results.get(key)
        if isinstance(rec, dict) and not rec.get("failures"):
            continue  # complete
        parts = {}
        if isinstance(rec, dict):
            parts = {j: p for j, p in (rec.get("partial_parts") or {}).items()
                     if j in names}
        todo = [j for j in names if j not in parts]
        if not todo:
            continue
        pending.append(w)
        pending_jobs[key] = todo
        if parts:
            seed_parts[key] = parts
    tasks = [
        (w.name, w.unroll, j, store_path, remote, device)
        for w in pending for j in pending_jobs[_cell_key(w.name, w.unroll)]
    ]
    by_key = {_cell_key(w.name, w.unroll): w for w in pending}
    n_jobs = max(1, jobs or os.cpu_count() or 1)
    t_start = time.time()
    n_failures = 0

    def consume(stream):
        nonlocal n_failures
        partial: Dict[str, Dict[str, Dict]] = dict(seed_parts)
        failed: Dict[str, Dict[str, Dict]] = {}
        for task, status, payload in stream:
            if status == "ok":
                key, job, out = payload
                partial.setdefault(key, {})[job] = out
            else:  # structured cell failure — the sweep continues
                key = _cell_key(task[0], task[1])
                job = task[2]
                failed.setdefault(key, {})[job] = payload.to_json()
                n_failures += 1
                print(f"{key:14s} {job}: FAILED "
                      f"({payload.error}: {payload.message}; "
                      f"{payload.attempts} attempt(s))", flush=True)
            parts = partial.setdefault(key, {})
            fails = failed.get(key, {})
            if len(parts) + len(fails) < len(names):
                continue
            rec = _finalize(by_key[key], parts, grid_jobs, failures=fails)
            if fails:
                # raw successful parts ride along so a resume re-attempts
                # ONLY the failed cells and merges without recompiling
                rec["partial_parts"] = partial.pop(key)
                failed.pop(key, None)
            else:
                partial.pop(key)
            results[key] = rec
            store_note = ""
            if "store" in rec:
                store_note = (f" store={rec['store']['hits']}h/"
                              f"{rec['store']['misses']}m")
            if rec.get("failures"):
                print(f"{key:14s} PARTIAL: {len(rec['failures'])} failed "
                      f"cell(s) {sorted(rec['failures'])} recorded "
                      f"({rec['wall_s']}s cpu){store_note}", flush=True)
            else:
                segs = rec["spatial"]["segments"] if rec["spatial"] else None
                print(
                    f"{key:14s} plaid={rec['ii']['plaid']} "
                    f"st={rec['ii']['st']} spatial_segs={segs} "
                    f"verified={rec['verified']} ({rec['wall_s']}s cpu)"
                    f"{store_note}",
                    flush=True,
                )
            # atomic rewrite: a crash mid-dump must not corrupt the
            # resume cache the next run would load
            atomic_write_json(out_path, results, indent=1)

    if tasks:
        runner = SupervisedRunner(
            run_job,
            jobs=min(n_jobs, len(tasks)),
            timeout_s=cell_timeout_s,
            retries=retries,
            start_method=start_method,
            label=_task_label,
            device=device,
        )
        consume(runner.run(tasks))
        cells = [results[k] for k in by_key if k in results]
        hits = sum(c.get("route_cache", {}).get("hits", 0) for c in cells)
        misses = sum(c.get("route_cache", {}).get("misses", 0) for c in cells)
        entry = {
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "quick": quick,
            "jobs": n_jobs,
            "workloads_run": len(pending),
            "wall_s": round(time.time() - t_start, 1),
            "cpu_s": round(sum(c["wall_s"] for c in cells), 1),
        }
        if n_failures:
            entry["failed_cells"] = n_failures
        if hits or misses:
            entry["route_cache_hit_rate"] = round(hits / (hits + misses), 4)
        if store_path is not None or remote is not None:
            # remote-only sweeps hit the FARM's store; the hit/miss split
            # still lands here so the warm-pass gate can assert on it
            st_hits = sum(c.get("store", {}).get("hits", 0) for c in cells)
            st_miss = sum(c.get("store", {}).get("misses", 0) for c in cells)
            entry["store"] = {
                "hits": st_hits,
                "misses": st_miss,
                "hit_rate": (round(st_hits / (st_hits + st_miss), 4)
                             if st_hits + st_miss else None),
            }
            if store_path is not None:
                entry["store"]["path"] = store_path
                print(f"store: {st_hits} hit(s), {st_miss} miss(es) "
                      f"({store_path})", flush=True)
        if remote is not None:
            served = sum(
                (c.get("store", {}).get("hits", 0)
                 + c.get("store", {}).get("misses", 0)) for c in cells)
            wall = max(time.time() - t_start, 1e-9)
            farm: Dict[str, object] = {
                "addr": remote,
                "served": served,
                "served_per_s": round(served / wall, 2),
            }
            try:
                from repro_torch.serve_farm.client import farm_status

                status = farm_status(remote)
                farm["daemon"] = {
                    "uptime_s": status.get("uptime_s"),
                    "counters": status.get("counters"),
                }
            except (ConnectionError, OSError):
                pass  # farm gone by bench time; local stats still recorded
            entry["farm"] = farm
            print(f"farm: {served} cell(s) via {remote} "
                  f"({farm['served_per_s']}/s)", flush=True)
        if batch_verify and store_path is not None:
            entry["sim_verify"] = _batch_verify_store(store_path,
                                                      device=device)
        if bench_note:
            entry["note"] = bench_note
        if bench_path is not None:
            _append_bench(bench_path, entry)
        if n_failures:
            print(
                f"collect: {n_failures} cell(s) recorded as structured "
                f"failures; re-run against {out_path} to re-attempt exactly "
                f"those cells", flush=True,
            )
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.collect",
        description="the TABLE2 x job-grid sweep, supervised")
    ap.add_argument("--out", required=True,
                    help="results JSON (resumed when it exists)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--jobs", type=int, default=0,
                    help="worker processes (default: CPU count; 1 = serial)")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="append the run's entry to this trajectory JSON "
                         "(default: none)")
    ap.add_argument("--bench-note", default="",
                    help="tag recorded with the bench entry (e.g. CI smoke)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="artifact store directory: serve cached mappings "
                         "without P&R, insert fresh compiles")
    ap.add_argument("--workloads", default=None,
                    help="comma-separated <name>_u<unroll> keys to restrict "
                         "the sweep (e.g. atax_u2)")
    ap.add_argument("--cell-timeout", type=float, default=None, metavar="S",
                    help="hard wall-clock limit per grid cell; a cell past "
                         "it is killed and recorded as a failure")
    ap.add_argument("--retries", type=int, default=1,
                    help="extra attempts for crashed workers / transient "
                         "errors (default 1)")
    ap.add_argument("--start-method", default=None,
                    choices=("fork", "spawn", "forkserver"),
                    help="multiprocessing start method (default: platform; "
                         "forkserver when --device is a card)")
    ap.add_argument("--plugins", default=None,
                    help="comma-separated modules each worker imports first "
                         "(registers plug-in mappers/arches under spawn)")
    ap.add_argument("--remote", default=None, metavar="SOCKET",
                    help="python -m repro_torch serve socket: offload cache "
                         "misses to the farm daemon (falls back to local "
                         "compiles when unreachable)")
    ap.add_argument("--batch-verify", action="store_true",
                    help="after the sweep, re-verify every stored mapping "
                         "through one batched simulate_batch call "
                         "(requires --store)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero if any cell ended as a structured "
                         "failure (default: record failures, exit 0)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the verifying cells run the cycle loop "
                         "(default cuda; refused, with no fallback, when "
                         "there is no card)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    res = collect(
        args.out, args.quick, jobs=args.jobs, bench_path=args.bench_out,
        bench_note=args.bench_note, store_path=args.store,
        workloads=(args.workloads.split(",") if args.workloads else None),
        cell_timeout_s=args.cell_timeout, retries=args.retries,
        start_method=args.start_method,
        plugins=(args.plugins.split(",") if args.plugins else None),
        batch_verify=args.batch_verify, remote=args.remote,
        device=args.device,
    )
    if args.strict and any(
            isinstance(r, dict) and r.get("failures") for r in res.values()):
        return 1
    return 0


if __name__ == "__main__":
    # through the module's own name, so the workers unpickle
    # repro_torch.core.collect.run_job (the forkserver's preload), not
    # __main__.run_job.  Without a spec, a spawn or forkserver worker
    # prepares this script by its path, which a forkserver has already
    # run, instead of re-running the module its server imported
    sys.modules["__main__"].__spec__ = None
    from repro_torch.core.collect import main as _main

    sys.exit(_main())
