#!/usr/bin/env python
"""Place-pass wall-time bench of the port's global analytic placer.

Usage:  python scripts/torch_bench_place.py [--top 8] [--bench-out PATH]
                                            [--note "..."] [--max-ratio 1.25]
                                            [--skip-cold]

The counterpart of ``scripts/bench_place.py`` over ``repro_torch.mapping``
(same arguments, measurements and entry schema; it imports neither
``jax`` nor ``repro``, so it runs on a card machine).  Two measurements on
the plaid3x3 fabric, largest TABLE2 workloads first, all on the host:

1. **Warm re-map (fixed II)** — the feasible II is already known
   (incremental recompiles, store-backed sweeps, design-space re-runs) and
   the mapper re-places at that II.  ``hierarchical`` is timed against
   ``hierarchical + global_seed`` via ``map_at_ii``; the per-pass
   ``place`` row is compared per workload.  When the analytic seed holds,
   the seeded attempt replaces the multi-start scan loop; when it goes
   stale the attempt aborts on a stale budget, so the downside is bounded.

2. **Cold full sweep** — ``pathfinder`` vs ``pathfinder_global`` from
   scratch (II sweep from mii).  The seeded extra restart pays overhead at
   infeasible IIs, so cold wall time may go up, in exchange for
   strictly-no-worse II: the run fails if any II gets worse.

The summary is appended as a ``place_bench`` entry to the trajectory file
that ``--bench-out`` names (nothing is written without it).
``--max-ratio`` is the CI guard: the warm seeded/unseeded total place
ratio must stay under it (default 1.25).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from datetime import datetime, timezone

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def place_row(mapper) -> float:
    stats = mapper.engine_stats()["passes"]
    return next((r["wall_s"] for r in stats if r["name"] == "place"), 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=8,
                    help="number of largest TABLE2 workloads to measure")
    ap.add_argument("--bench-out", default=None,
                    help="append a place_bench entry to this trajectory")
    ap.add_argument("--note", default="place bench")
    ap.add_argument("--max-ratio", type=float, default=1.25,
                    help="fail if warm seeded/unseeded total place exceeds")
    ap.add_argument("--skip-cold", action="store_true",
                    help="warm re-map comparison only (the CI gate)")
    args = ap.parse_args(argv)

    from repro_torch.core.arch import make_arch
    from repro_torch.core.workloads import all_workloads
    from repro_torch.mapping.mappers import (
        HierarchicalMapper,
        PathFinderGlobalMapper,
        PathFinderMapper2,
    )

    arch = make_arch("plaid3x3")
    picks = sorted(all_workloads(), key=lambda p: -p[0].total)[:args.top]

    print(f"== warm re-map at known II: hierarchical vs +global_seed "
          f"(top {args.top}) ==")
    warm_rows = []
    tot0 = tot1 = 0.0
    for w, g in picks:
        probe = HierarchicalMapper(arch, seed=0)
        res = probe.map(g)
        if res is None:
            continue
        ii = res.ii
        m0 = HierarchicalMapper(arch, seed=0)
        r0 = m0.map_at_ii(g, ii)
        m1 = HierarchicalMapper(arch, seed=0, global_seed=True)
        r1 = m1.map_at_ii(g, ii)
        assert r0 is not None and r1 is not None, (w.name, ii)
        p0, p1 = place_row(m0), place_row(m1)
        tot0 += p0
        tot1 += p1
        key = f"{w.name}_u{w.unroll}"
        warm_rows.append({"workload": key, "ii": ii,
                          "place_ms": round(p0 * 1000, 1),
                          "place_seeded_ms": round(p1 * 1000, 1)})
        print(f"  {key:<14} ii={ii:<3} place {p0 * 1000:7.1f}ms -> "
              f"{p1 * 1000:7.1f}ms  ({p1 / p0 if p0 else 1:.2f}x)")
    ratio = tot1 / tot0 if tot0 else 1.0
    print(f"  TOTAL place {tot0 * 1000:.0f}ms -> {tot1 * 1000:.0f}ms "
          f"({ratio:.2f}x, gate {args.max_ratio}x)")

    cold_rows = []
    cold = {}
    if not args.skip_cold:
        print("== cold full sweep: pathfinder vs pathfinder_global ==")
        w0 = w1 = 0.0
        worse = better = 0
        for w, g in picks:
            t = time.perf_counter()
            r0 = PathFinderMapper2(arch, seed=0).map(g)
            t0 = time.perf_counter() - t
            t = time.perf_counter()
            r1 = PathFinderGlobalMapper(arch, seed=0).map(g)
            t1 = time.perf_counter() - t
            i0 = r0.ii if r0 else None
            i1 = r1.ii if r1 else None
            worse += (i1 or 99) > (i0 or 99)
            better += (i1 or 99) < (i0 or 99)
            w0 += t0
            w1 += t1
            key = f"{w.name}_u{w.unroll}"
            cold_rows.append({"workload": key, "ii": i0, "ii_global": i1,
                              "wall_s": round(t0, 3),
                              "wall_global_s": round(t1, 3)})
            print(f"  {key:<14} ii {i0}->{i1}  wall {t0:.2f}s -> {t1:.2f}s")
        cold = {"rows": cold_rows, "wall_s": round(w0, 2),
                "wall_global_s": round(w1, 2),
                "ii_worse": worse, "ii_better": better}
        print(f"  TOTAL wall {w0:.1f}s -> {w1:.1f}s  "
              f"(II worse {worse} / better {better})")
        if worse:
            print("bench-place: FAIL — pathfinder_global regressed II "
                  f"on {worse} cell(s)")
            return 1

    if args.bench_out:
        from repro_torch.core.collect import _append_bench
        entry = {
            "utc": datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
            "note": args.note,
            "place_bench": {
                "arch": "plaid3x3",
                "top": args.top,
                "warm": {"rows": warm_rows,
                         "place_ms": round(tot0 * 1000, 1),
                         "place_seeded_ms": round(tot1 * 1000, 1),
                         "ratio": round(ratio, 3)},
                **({"cold": cold} if cold else {}),
            },
        }
        _append_bench(args.bench_out, entry)
        print(f"bench-place: appended place_bench entry to {args.bench_out}")

    if ratio > args.max_ratio:
        print(f"bench-place: FAIL — warm seeded place ratio {ratio:.2f}x "
              f"exceeds {args.max_ratio}x")
        return 1
    print("bench-place: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
