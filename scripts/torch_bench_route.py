#!/usr/bin/env python
"""Route-phase wall-time bench of the port's route-search engine.

Usage:  python scripts/torch_bench_route.py [--top 6] [--bench-out PATH]
                                            [--note "..."] [--min-speedup 1.5]

The counterpart of ``scripts/bench_route.py`` over ``repro_torch.mapping``
(same arguments, helpers, assertion and entry schema; it imports neither
``jax`` nor ``repro``, so it runs on a card machine).  Cold full-sweep
``pathfinder`` runs on the plaid3x3 fabric, largest TABLE2 workloads
first: every workload is mapped twice at fixed seed, once with
``route_engine="legacy"`` (the scalar DP oracle) and once with the default
``"auto"`` hybrid (array-DP core on every long-span search).  The two
cores are bit-identical by construction, and the bench *asserts* it — II,
placement, schedule and every route must match — so the per-workload
``route_s`` ratio is a pure engine speedup, not a search-trajectory
artifact.  The mapper runs on the host: nothing here touches a card.

The summary is appended as a ``route_bench`` entry to the trajectory file
that ``--bench-out`` names (nothing is written without it);
``scripts/perf_smoke.py`` gates later runs against it.  ``--min-speedup``
is the CI guard: every workload's legacy/auto route-phase ratio must
reach it (default 1.5).  The ratio measures the host's CPU as much as the
code: read it beside the host's model and core count.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import datetime, timezone

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _run(mapper_cls, arch, g, engine):
    m = mapper_cls(arch, seed=0)
    m.route_engine = engine
    t = time.perf_counter()
    r = m.map(g)
    wall = time.perf_counter() - t
    st = m.engine_stats()
    traj = (
        None if r is None
        else (r.ii, dict(r.place), dict(r.time), dict(r.routes))
    )
    return traj, wall, st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=6,
                    help="number of largest TABLE2 workloads to measure")
    ap.add_argument("--bench-out", default=None,
                    help="append a route_bench entry to this trajectory")
    ap.add_argument("--note", default="route bench")
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="fail if any per-workload route speedup is below")
    args = ap.parse_args(argv)

    from repro_torch.core.arch import make_arch
    from repro_torch.core.workloads import all_workloads
    from repro_torch.mapping.mappers import PathFinderMapper2

    arch = make_arch("plaid3x3")
    picks = sorted(all_workloads(), key=lambda p: -p[0].total)[:args.top]

    print(f"== cold pathfinder sweep: legacy vs auto route engine "
          f"(plaid3x3, top {args.top}) ==")
    rows = []
    tot_legacy = tot_auto = 0.0
    floor = None
    for w, g in picks:
        t0, wall0, st0 = _run(PathFinderMapper2, arch, g, "legacy")
        t1, wall1, st1 = _run(PathFinderMapper2, arch, g, "auto")
        key = f"{w.name}_u{w.unroll}"
        assert t0 == t1, f"{key}: engines diverged (bit-identity broken)"
        r0, r1 = st0["route_s"], st1["route_s"]
        tot_legacy += r0
        tot_auto += r1
        speedup = r0 / r1 if r1 else float("inf")
        floor = speedup if floor is None else min(floor, speedup)
        fo = st1["route_cache"]["fanout"]
        rows.append({
            "workload": key,
            "ii": t0[0] if t0 else None,
            "route_legacy_ms": round(r0 * 1000, 1),
            "route_auto_ms": round(r1 * 1000, 1),
            "speedup": round(speedup, 2),
            "wall_legacy_s": round(wall0, 3),
            "wall_auto_s": round(wall1, 3),
            "fanout_batches": fo["batches"],
            "layers_reused": fo["layers_reused"],
        })
        print(f"  {key:<14} ii={t0[0] if t0 else '-':<3} "
              f"route {r0 * 1000:7.1f}ms -> {r1 * 1000:7.1f}ms "
              f"({speedup:.2f}x)  wall {wall0:.2f}s -> {wall1:.2f}s")
    total = tot_legacy / tot_auto if tot_auto else float("inf")
    print(f"  TOTAL route {tot_legacy * 1000:.0f}ms -> "
          f"{tot_auto * 1000:.0f}ms ({total:.2f}x; per-workload floor "
          f"{floor:.2f}x, gate {args.min_speedup}x)")

    if args.bench_out:
        from repro_torch.core.collect import _append_bench
        entry = {
            "utc": datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
            "note": args.note,
            "route_bench": {
                "arch": "plaid3x3",
                "mapper": "pathfinder",
                "top": args.top,
                "rows": rows,
                "route_legacy_ms": round(tot_legacy * 1000, 1),
                "route_auto_ms": round(tot_auto * 1000, 1),
                "speedup": round(total, 3),
                "speedup_floor": round(floor, 3) if floor else None,
            },
        }
        _append_bench(args.bench_out, entry)
        print(f"bench-route: appended route_bench entry to {args.bench_out}")

    if floor is not None and floor < args.min_speedup:
        print(f"bench-route: FAIL — per-workload route speedup floor "
              f"{floor:.2f}x below {args.min_speedup}x")
        return 1
    print("bench-route: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
