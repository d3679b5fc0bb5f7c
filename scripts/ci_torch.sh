#!/usr/bin/env bash
# Tier-1 CI of the PyTorch/CUDA port: every gate of scripts/ci.sh, in the
# same order and with the same thresholds, through repro_torch (python -m
# repro_torch ..., python -m repro_torch.core.collect ..., repro_torch
# imports), so it runs on a card machine, which has no JAX.  scripts/ci.sh
# stays the JAX package's CI.
#
#   CI_DEVICE     where every verifying or compiling step runs the cycle
#                 loop: cuda (default) or cpu.  The script never picks it:
#                 without a card, cuda fails at the first verifying step,
#                 as the port raises.
#   CI_BENCH_OUT  the trajectory every bench entry lands in (default
#                 build/ci_torch/BENCH_mapper_torch.json); the script
#                 writes no tracked file
#   CI_BUDGET_S   per-phase timeout in seconds (default 900)
#   CI_FULL_TESTS set to 1 to run the suite at full SA budgets (no --quick)
#
# Two parts of ci.sh have no counterpart: the dev-extras install (neither
# this repo's runners nor the card machine have a network, and the card
# machine already has pytest and hypothesis) and the repro.core.mapper
# compat shim check (the shim is not ported: the port has no caller of it).
#
# The speed gates (route, place, perf smoke) measure the host as much as
# the code, so every gate runs even after an earlier one failed: each
# failed gate is named, the exit code is 1 if any failed, and "CI OK" is
# printed only when all pass.
#
#   bash scripts/ci_torch.sh                  # on a card machine
#   CI_DEVICE=cpu bash scripts/ci_torch.sh    # without a card
set -uo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
BUDGET="${CI_BUDGET_S:-900}"
CI_DEVICE="${CI_DEVICE:-cuda}"
CI_BENCH_OUT="${CI_BENCH_OUT:-build/ci_torch/BENCH_mapper_torch.json}"

#: the port's test files that import neither jax nor repro, the tier-1
#: tests on a card (tests/test_torch_ci.py holds the list to that rule)
CUDA_TESTS="tests/test_torch_adamw.py tests/test_torch_cuda.py
            tests/test_torch_examples.py tests/test_torch_imports.py
            tests/test_torch_launch.py tests/test_torch_tracing.py"

WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
ART_DIR="$WORK/artifacts"
OUT="$WORK/results.json"
GOUT="$WORK/global.json"
WOUT="$WORK/window.json"
STORE_DIR="$WORK/store"
S1="$WORK/store_r1.json"
S2="$WORK/store_r2.json"
S3="$WORK/store_r3.json"
SBENCH="$WORK/store_bench.json"
CHAOS_OUT="$WORK/chaos.json"
CHAOS_BENCH="$WORK/chaos_bench.json"
FARM_STORE="$WORK/farm_store"
FARM_SOCK="$WORK/farm.sock"
FARM_LOG="$WORK/farm.log"
G1="$WORK/farm_r1.json"
G2="$WORK/farm_r2.json"
G3="$WORK/farm_r3.json"
mkdir -p "$ART_DIR" "$STORE_DIR" "$FARM_STORE"

gate_tier1_tests() {
    echo "== tier-1 tests (budget ${BUDGET}s) =="
    local quick="--quick" files
    [ "${CI_FULL_TESTS:-0}" = "1" ] && quick=""
    if [ "$CI_DEVICE" = "cpu" ]; then
        files=$(ls tests/test_torch_*.py)
    else
        files=$CUDA_TESTS
    fi
    # shellcheck disable=SC2086
    timeout "$BUDGET" python -m pytest -x -q $quick $files
}

gate_imports() {
    echo "== repro_torch import boundary + repro_torch.mapping import-cycle gate =="
    # the port imports neither jax nor repro, and repro_torch.mapping stays
    # a DAG (no intra-package module-level import cycles)
    timeout "$BUDGET" python -m pytest -q tests/test_torch_imports.py
}

gate_cli_smoke() {
    echo "== compiler CLI smoke: every registered mapper on one workload =="
    timeout "$BUDGET" python -m repro_torch compile atax -u 2 --all-jobs \
        --device "$CI_DEVICE" --out-dir "$ART_DIR"
    # artifact IIs must match golden, and a loaded artifact must re-simulate
    # against the DFG oracle WITHOUT re-running place & route
    python -m repro_torch diff --golden tests/golden_ii_quick.json "$ART_DIR"
    python -m repro_torch inspect --verify --device "$CI_DEVICE" \
        "$ART_DIR"/atax_u2__plaid.json "$ART_DIR"/atax_u2__st.json \
        "$ART_DIR"/atax_u2__spatial.json
}

gate_collect_quick() {
    echo "== collect --quick (budget ${BUDGET}s) =="
    rm -f "$OUT"   # collect resumes from existing files; start fresh
    # perf-smoke entry lands in the trajectory so runs are comparable
    timeout "$BUDGET" python -m repro_torch.core.collect --quick --out "$OUT" \
        --device "$CI_DEVICE" --bench-out "$CI_BENCH_OUT" \
        --bench-note "ci perf smoke"
}

gate_ii_diff() {
    echo "== II diff vs golden =="
    # a results file: every golden workload must be present (require_all)
    python -m repro_torch diff --golden tests/golden_ii_quick.json "$OUT"
}

gate_global_placer() {
    echo "== global placer gate: pathfinder_global II-no-worse on quick grid =="
    rm -f "$GOUT"
    # run the seeded composition live over the quick grid (full budgets: the
    # golden was recorded without REPRO_QUICK) and hold it to its golden pin
    timeout "$BUDGET" python - "$GOUT" <<'EOF'
import json, sys
from repro_torch.core.arch import make_arch
from repro_torch.core.workloads import build_workload, quick_workloads
from repro_torch.mapping.mappers import PathFinderGlobalMapper

arch = make_arch("plaid3x3")
out = {}
for w in quick_workloads():
    r = PathFinderGlobalMapper(arch, seed=0).map(build_workload(w))
    out[f"{w.name}_u{w.unroll}"] = {"pathfinder_global": r.ii if r else None}
json.dump(out, open(sys.argv[1], "w"), indent=1)
EOF
    python -m repro_torch diff --golden tests/golden_ii_quick_global.json "$GOUT"
    # warm re-map place wall must stay measurably reduced (ratio gate, the
    # 1.25x ceiling of ci.sh) and the run lands in the bench trajectory
    timeout "$BUDGET" python scripts/torch_bench_place.py --skip-cold --top 4 \
        --bench-out "$CI_BENCH_OUT" --note "ci place gate"
}

gate_route_engine() {
    echo "== route engine gate: array-DP core bit-identical and faster =="
    # cold pathfinder sweep on the route-dominated cells, legacy vs auto: the
    # bench asserts full-trajectory bit-identity per workload and fails if
    # any per-workload route-phase speedup drops below 1.5x; the run lands
    # in the bench trajectory for perf_smoke to gate
    timeout "$BUDGET" python scripts/torch_bench_route.py --top 4 \
        --min-speedup 1.5 --bench-out "$CI_BENCH_OUT" --note "ci route gate"
}

gate_route_window() {
    echo "== route window gate: pathfinder_window II-no-worse on quick grid =="
    rm -f "$WOUT"
    # the top-K candidate window is trajectory-changing by design, so it holds
    # its own golden pin
    timeout "$BUDGET" python - "$WOUT" <<'EOF'
import json, sys
from repro_torch.core.arch import make_arch
from repro_torch.core.workloads import build_workload, quick_workloads
from repro_torch.mapping.mappers import PathFinderWindowMapper

arch = make_arch("plaid2x2")
out = {}
for w in quick_workloads():
    r = PathFinderWindowMapper(arch, seed=0).map(build_workload(w))
    out[f"{w.name}_u{w.unroll}"] = {"pf_on_plaid": r.ii if r else None}
json.dump(out, open(sys.argv[1], "w"), indent=1)
EOF
    python -m repro_torch diff --golden tests/golden_ii_quick_window.json "$WOUT"
}

gate_store_roundtrip() {
    echo "== store roundtrip: warm second pass must be a 100% hit =="
    rm -f "$S1" "$S2" "$SBENCH"
    # same cell twice through the artifact store: the first pass compiles and
    # inserts, the second must be served entirely from cache (zero P&R)
    timeout "$BUDGET" python -m repro_torch.core.collect --quick \
        --workloads atax_u2 --out "$S1" --store "$STORE_DIR" \
        --bench-out "$SBENCH" --device "$CI_DEVICE"
    timeout "$BUDGET" python -m repro_torch.core.collect --quick \
        --workloads atax_u2 --out "$S2" --store "$STORE_DIR" \
        --bench-out "$SBENCH" --device "$CI_DEVICE"
    python - "$S1" "$S2" "$SBENCH" <<'EOF'
import json, sys
r1, r2, bench = (json.load(open(p)) for p in sys.argv[1:4])
c1, c2 = r1["atax_u2"], r2["atax_u2"]
assert c1["ii"] == c2["ii"], f"II drifted on store hit: {c1['ii']} != {c2['ii']}"
assert c1["cycles"] == c2["cycles"], "cycles drifted on store hit"
last = bench["runs"][-1]["store"]
assert last["misses"] == 0 and last["hit_rate"] == 1.0, f"warm pass not 100% hits: {last}"
print(f"store roundtrip OK: {last['hits']} hits / 0 misses, II+cycles identical")
EOF
}

gate_batched_sim() {
    echo "== batched simulator gate: verdict parity vs the scalar oracle =="
    # every artifact the store-roundtrip pass produced re-verifies through one
    # simulate_batch call, and --parity diffs each verdict against the scalar
    # oracle (exit 10 on any divergence); the post-sweep --batch-verify
    # stage must agree that every stored mapping still verifies
    timeout "$BUDGET" python -m repro_torch verify --dir "$STORE_DIR" --parity \
        --device "$CI_DEVICE" --bench-out "$SBENCH" --bench-note "ci sim gate"
    rm -f "$S3"
    timeout "$BUDGET" python -m repro_torch.core.collect --quick \
        --workloads atax_u2 --out "$S3" --store "$STORE_DIR" \
        --bench-out "$SBENCH" --batch-verify --device "$CI_DEVICE"
    python - "$SBENCH" "$CI_DEVICE" <<'EOF'
import json, sys
runs = json.load(open(sys.argv[1]))["runs"]
sim = [r for r in runs if "sim_throughput" in r][-1]["sim_throughput"]
assert sim["mappings"] > 0, sim
# the cycle loop ran where CI_DEVICE says (cuda: one sim_loop launch a bucket)
assert sim["backend"] == sys.argv[2], sim
ver = [r for r in runs if "sim_verify" in r][-1]["sim_verify"]
assert ver["failed"] == 0, f"post-sweep batch verify found failures: {ver}"
print(f"sim gate OK: parity on {sim['mappings']} mappings on "
      f"{sim['backend']}, "
      f"warm {sim['warm_mappings_per_s']} mappings/s; "
      f"post-sweep batch verify {ver['mappings']} mappings, 0 failures")
EOF
}

gate_chaos() {
    echo "== chaos gate: injected crash+hang must record failures, then heal =="
    rm -f "$CHAOS_OUT" "$CHAOS_BENCH"
    # one worker crashes like an OOM kill (both attempts), one cell hangs past
    # its --cell-timeout: the sweep must still complete (exit 0) with both
    # cells recorded as structured failures instead of aborting
    REPRO_FAULTS='[{"mode": "crash", "site": "worker", "match": "atax_u2/plaid", "attempts": [0, 1]},
                   {"mode": "hang", "site": "worker", "match": "atax_u2/st", "seconds": 120}]' \
    timeout "$BUDGET" python -m repro_torch.core.collect --quick \
        --workloads atax_u2 --out "$CHAOS_OUT" --bench-out "$CHAOS_BENCH" \
        --cell-timeout 20 --jobs 2 --device "$CI_DEVICE"
    python - "$CHAOS_OUT" <<'EOF'
import json, sys
rec = json.load(open(sys.argv[1]))["atax_u2"]
f = rec["failures"]
assert f["plaid"]["error"] == "WorkerCrashed" and f["plaid"]["attempts"] == 2, f
assert f["st"]["error"] == "CompileTimeout", f
assert rec["ii"]["plaid"] is None and rec["ii"]["st"] is None, rec["ii"]
assert rec["partial_parts"], "successful cells must ride along for the resume"
print(f"chaos gate: {len(f)} injected failures recorded, sweep completed")
EOF
    # a clean re-run against the same --out re-attempts ONLY the failed cells
    # and must heal the record back to the golden IIs (strict: no failures left)
    timeout "$BUDGET" python -m repro_torch.core.collect --quick \
        --workloads atax_u2 --out "$CHAOS_OUT" --bench-out "$CHAOS_BENCH" \
        --strict --device "$CI_DEVICE"
    python - "$CHAOS_OUT" <<'EOF'
import json, sys
rec = json.load(open(sys.argv[1]))["atax_u2"]
assert "failures" not in rec and "partial_parts" not in rec, "record not healed"
golden = json.load(open("tests/golden_ii_quick.json"))["atax_u2"]
for job, want in golden.items():
    assert rec["ii"][job] == want, (job, rec["ii"][job], want)
assert rec["verified"] == {"plaid": True, "st": True}, rec["verified"]
print("chaos gate: torn grid healed bit-identically to golden")
EOF
}

wait_for_socket() {
    for _ in $(seq 100); do [ -S "$FARM_SOCK" ] && return 0; sleep 0.1; done
    return 1
}

gate_farm_chaos() {
    echo "== farm chaos gate: kill -9 the serve daemon mid-sweep, restart, heal =="
    FARM_PID="" SWEEP_PID=""
    # a gate that fails midway leaves no daemon or sweep behind
    trap 'kill -9 $FARM_PID $SWEEP_PID 2>/dev/null || true' EXIT
    rm -f "$G1" "$G2" "$G3"
    python -m repro_torch serve --dir "$FARM_STORE" --socket "$FARM_SOCK" \
        --workers 2 --device "$CI_DEVICE" >"$FARM_LOG" 2>&1 &
    FARM_PID=$!
    wait_for_socket || { echo "farm gate: daemon never bound its socket"; cat "$FARM_LOG"; return 1; }
    # cold sweep through the farm with the daemon murdered mid-flight: the
    # client's bounded retries + circuit breaker must degrade the remaining
    # cells to local compiles — the sweep completes with golden IIs either way
    timeout "$BUDGET" python -m repro_torch.core.collect --quick --out "$G1" \
        --remote "$FARM_SOCK" --device "$CI_DEVICE" &
    SWEEP_PID=$!
    sleep 1
    kill -9 "$FARM_PID" 2>/dev/null || true
    wait "$SWEEP_PID"
    python -m repro_torch diff --golden tests/golden_ii_quick.json "$G1"
    # restart over the stale socket + uncompacted journal: the journaled index
    # heals on open, and whatever the first daemon cached survived the kill -9
    python -m repro_torch serve --dir "$FARM_STORE" --socket "$FARM_SOCK" \
        --workers 2 --device "$CI_DEVICE" >"$FARM_LOG" 2>&1 &
    FARM_PID=$!
    wait_for_socket || { echo "farm gate: daemon did not restart over stale socket"; cat "$FARM_LOG"; return 1; }
    timeout "$BUDGET" python -m repro_torch.core.collect --quick --out "$G2" \
        --remote "$FARM_SOCK" --device "$CI_DEVICE"
    python -m repro_torch diff --golden tests/golden_ii_quick.json "$G2"
    # third pass: every cell must be served warm from the healed store; the
    # farm throughput entry lands in the bench trajectory
    timeout "$BUDGET" python -m repro_torch.core.collect --quick --out "$G3" \
        --remote "$FARM_SOCK" --device "$CI_DEVICE" \
        --bench-out "$CI_BENCH_OUT" --bench-note "ci farm gate (warm)"
    python -m repro_torch diff --golden tests/golden_ii_quick.json "$G3"
    python - "$G2" "$G3" "$CI_BENCH_OUT" <<'EOF'
import json, sys
r2, r3 = (json.load(open(p)) for p in sys.argv[1:3])
for w, rec in r3.items():
    assert rec["ii"] == r2[w]["ii"], (w, rec["ii"], r2[w]["ii"])
last = json.load(open(sys.argv[3]))["runs"][-1]
st = last["store"]
assert st["misses"] == 0 and st["hit_rate"] == 1.0, f"warm farm pass not 100% hits: {st}"
farm = last["farm"]
assert farm["served"] > 0 and farm["served_per_s"] > 0, farm
print(f"farm gate: healed bit-identically; {st['hits']} warm hits at "
      f"{farm['served_per_s']} served/s")
EOF
    # graceful drain: SIGTERM must finish in-flight work, compact the journal,
    # remove the socket, and exit 0
    kill -TERM "$FARM_PID"
    wait "$FARM_PID"
    [ ! -S "$FARM_SOCK" ] || { echo "farm gate: socket left behind after drain"; return 1; }
    python - "$FARM_STORE" <<'EOF'
import json, os, sys
store = sys.argv[1]
snap = json.load(open(os.path.join(store, "index.json")))
jsize = os.path.getsize(os.path.join(store, "journal.jsonl"))
assert snap["entries"], "drained store lost its entries"
assert jsize < 200, f"journal not compacted on drain ({jsize} bytes)"
print(f"farm gate: drained clean — {len(snap['entries'])} rows snapshotted, "
      f"journal {jsize}B")
EOF
}

gate_perf_smoke() {
    echo "== perf smoke: quick wall time vs last recorded run =="
    python scripts/perf_smoke.py "$CI_BENCH_OUT" --max-ratio 2.0
}

GATES="tier1_tests imports cli_smoke collect_quick ii_diff global_placer
       route_engine route_window store_roundtrip batched_sim chaos farm_chaos
       perf_smoke"

echo "ci_torch: device $CI_DEVICE; host $(nproc) cores," \
     "$(sed -n 's/^model name[[:space:]]*: //p' /proc/cpuinfo | head -n 1)"
if [ "$CI_DEVICE" = "cuda" ] && command -v nvidia-smi >/dev/null; then
    echo "ci_torch: card $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -n 1)"
fi

FAILED=""
SUMMARY=""
T_START=$(date +%s.%N)
for g in $GATES; do
    t0=$(date +%s.%N)
    ( set -euo pipefail; "gate_$g" )
    rc=$?
    dt=$(awk -v a="$t0" -v b="$(date +%s.%N)" 'BEGIN { printf "%.1f", b - a }')
    if [ "$rc" -eq 0 ]; then status=ok; else status="FAILED (exit $rc)"; FAILED="$FAILED $g"; fi
    echo "ci_torch: gate $g $status in ${dt}s"
    SUMMARY="$SUMMARY$g $status ${dt}s"$'\n'
done
TOTAL=$(awk -v a="$T_START" -v b="$(date +%s.%N)" 'BEGIN { printf "%.1f", b - a }')

echo "ci_torch: gate wall times (device $CI_DEVICE, total ${TOTAL}s):"
printf '%s' "$SUMMARY" | sed 's/^/  /'
echo "ci_torch: trajectory in $CI_BENCH_OUT"
if [ -n "$FAILED" ]; then
    echo "ci_torch: FAILED gates:$FAILED"
    exit 1
fi
echo "CI OK"
