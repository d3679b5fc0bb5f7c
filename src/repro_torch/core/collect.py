"""The bench trajectory writer of the collect sweep (port of
``_append_bench`` and ``_reclaim_stranded`` of ``repro/core/collect.py``;
the rest of that module is the mapper sweep, which waits for the mapper's
port).

``python -m repro_torch verify --bench-out PATH`` appends its
``sim_throughput`` entry here, in the JAX package's trajectory format
(``{"runs": [...]}``), under a bounded lock: a dead lock-holder strands
the entry into a ``*.stranded-*`` sidecar instead of hanging a finished
run, and the next successful locked append merges any sidecars back.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List

from repro_torch.compiler.errors import LockTimeout
from repro_torch.compiler.fsio import (
    atomic_write_json,
    load_json_or_quarantine,
    locked,
)

#: bounded wait for the bench-trajectory lock (a finished run must not
#: hang forever behind a dead lock-holder; see _append_bench)
BENCH_LOCK_TIMEOUT_S = 10.0


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
