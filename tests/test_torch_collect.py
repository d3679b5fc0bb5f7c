"""The port's sweep (``repro_torch.core.collect``) against the JAX package's
``repro.core.collect`` and its results file, on the CPU
(``device="cpu"``).  Tolerance: exact equality of every record field but
``wall_s`` (and the store's hit/miss counts, which a sweep on a store adds).

* ``collect(workloads=["atax_u2"], device="cpu")`` equals the JAX
  package's collect of the same cell and ``experiments/cgra/results.json``;
* a crashed and a hung cell become structured failure records, the sweep
  completes, and a clean re-run heals exactly those cells (the port of
  ``test_collect_survives_crash_and_hang_then_heals`` of
  ``tests/test_robustness.py``);
* runtime registrations reach ``spawn`` workers through ``REPRO_PLUGINS``;
* ``--batch-verify`` re-verifies every stored mapping on the CPU;
* the CLI refuses to run without ``--out``, and no default names a path:
  nothing of the repo is written unless the caller says so;
* no card: refused, with no fallback to the CPU.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.core.collect import collect as jax_collect
from repro_torch.compiler import faultinject
from repro_torch.core.collect import (
    PLUGINS_VAR,
    build_parser,
    collect,
    main,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "experiments", "cgra", "results.json")

with open(RESULTS) as _f:
    REFERENCE = json.load(_f)


@pytest.fixture(autouse=True)
def full_budget(monkeypatch):
    """The results file is a full-budget sweep: ``--quick`` must not
    clamp."""
    monkeypatch.delenv("REPRO_QUICK", raising=False)


def _fields(rec):
    return {k: v for k, v in rec.items() if k not in ("wall_s", "store")}


def test_atax_u2_equals_the_jax_sweep_and_the_results_file(tmp_path):
    port = collect(str(tmp_path / "port.json"), jobs=2,
                   bench_path=str(tmp_path / "port_bench.json"),
                   workloads=["atax_u2"], device="cpu")
    ref = jax_collect(str(tmp_path / "jax.json"), jobs=2,
                      bench_path=str(tmp_path / "jax_bench.json"),
                      workloads=["atax_u2"])
    assert list(port) == ["atax_u2"]
    rec = port["atax_u2"]
    assert "store" not in rec and "failures" not in rec
    assert _fields(rec) == _fields(ref["atax_u2"])
    assert _fields(rec) == _fields(REFERENCE["atax_u2"])
    assert rec["verified"] == {"plaid": True, "st": True}
    with open(tmp_path / "port_bench.json") as f:
        entry = json.load(f)["runs"][-1]
    with open(tmp_path / "jax_bench.json") as f:
        jax_entry = json.load(f)["runs"][-1]
    keep = ("quick", "jobs", "workloads_run", "route_cache_hit_rate")
    assert ({k: entry[k] for k in keep}
            == {k: jax_entry[k] for k in keep})


def test_collect_survives_crash_and_hang_then_heals(tmp_path):
    """The chaos contract end to end: a worker crash and a hung cell are
    recorded as structured failures (the sweep completes), and a clean
    re-run re-attempts exactly the failed cells, healing the record to
    the results file's."""
    out = str(tmp_path / "results.json")
    bench = str(tmp_path / "bench.json")
    with faultinject.inject(
        {"mode": "crash", "site": "worker", "match": "atax_u2/plaid",
         "attempts": [0, 1]},
        {"mode": "hang", "site": "worker", "match": "atax_u2/st",
         "seconds": 120},
    ):
        r1 = collect(out, jobs=2, bench_path=bench, workloads=["atax_u2"],
                     cell_timeout_s=15.0, retries=1, device="cpu")
    rec = r1["atax_u2"]
    crash = rec["failures"]["plaid"]
    assert crash["error"] == "WorkerCrashed"
    assert crash["attempts"] == 2  # crashes are retried; both were injected
    assert crash["exitcode"] == 137
    hang = rec["failures"]["st"]
    assert hang["error"] == "CompileTimeout"
    assert hang["attempts"] == 1  # timeouts are not retried by default
    assert rec["ii"]["plaid"] is None and rec["ii"]["st"] is None
    assert rec["ii"]["node_on_plaid"] is not None  # rest of the row landed
    assert "st" not in rec["partial_parts"]
    assert "node_on_plaid" in rec["partial_parts"]
    with open(bench) as f:
        assert json.load(f)["runs"][-1]["failed_cells"] == 2

    r2 = collect(out, jobs=2, bench_path=bench, workloads=["atax_u2"],
                 device="cpu")
    rec2 = r2["atax_u2"]
    assert "failures" not in rec2 and "partial_parts" not in rec2
    assert _fields(rec2) == _fields(REFERENCE["atax_u2"])
    # the ride-along parts were merged, not recompiled
    assert rec2["ii"]["node_on_plaid"] == rec["ii"]["node_on_plaid"]
    # a third run has nothing left to do (and appends no bench entry)
    r3 = collect(out, jobs=2, bench_path=bench, workloads=["atax_u2"],
                 device="cpu")
    assert r3["atax_u2"] == rec2
    with open(bench) as f:
        assert len(json.load(f)["runs"]) == 2


def test_spawn_workers_import_the_plugins(tmp_path):
    """Registrations must survive the ``spawn`` start method: built-ins
    re-register when the worker imports the pipeline, runtime plug-ins
    travel via ``REPRO_PLUGINS``."""
    sentinel = str(tmp_path / "plugin_imports.txt")
    (tmp_path / "rt_torch_plugmod.py").write_text(
        "import os\n"
        "with open(os.environ['RT_PLUG_SENTINEL'], 'a') as f:\n"
        "    f.write(str(os.getpid()) + '\\n')\n"
    )
    sys.path.insert(0, str(tmp_path))
    os.environ["RT_PLUG_SENTINEL"] = sentinel
    try:
        res = collect(str(tmp_path / "results.json"), jobs=2,
                      workloads=["atax_u2"], start_method="spawn",
                      plugins=["rt_torch_plugmod"], device="cpu")
        rec = res["atax_u2"]
        assert "failures" not in rec
        assert _fields(rec) == _fields(REFERENCE["atax_u2"])
        with open(sentinel) as f:
            pids = {int(line) for line in f if line.strip()}
        assert pids - {os.getpid()}, "no spawn worker imported the plugin"
    finally:
        sys.path.remove(str(tmp_path))
        os.environ.pop("RT_PLUG_SENTINEL", None)
        os.environ.pop(PLUGINS_VAR, None)
        sys.modules.pop("rt_torch_plugmod", None)


def test_batch_verify_on_the_cpu(tmp_path):
    bench = str(tmp_path / "bench.json")
    res = collect(str(tmp_path / "results.json"), jobs=2, bench_path=bench,
                  store_path=str(tmp_path / "store"), workloads=["atax_u2"],
                  batch_verify=True, device="cpu")
    rec = res["atax_u2"]
    assert rec["store"] == {"hits": 0, "misses": 7}
    assert _fields(rec) == _fields(REFERENCE["atax_u2"])
    with open(bench) as f:
        entry = json.load(f)["runs"][-1]
    assert entry["store"]["hits"] == 0 and entry["store"]["misses"] == 7
    sim = entry["sim_verify"]
    # atax_u2: one mapping a modulo job, six spatial segments
    assert sim["backend"] == "cpu" and sim["mappings"] == 12
    assert sim["failed"] == 0 and sim["scalar_fallbacks"] == 0
    # a warm re-run on a fresh --out serves every cell from the store
    warm = collect(str(tmp_path / "warm.json"), jobs=2,
                   store_path=str(tmp_path / "store"),
                   workloads=["atax_u2"], device="cpu")
    assert warm["atax_u2"]["store"] == {"hits": 7, "misses": 0}
    assert _fields(warm["atax_u2"]) == _fields(rec)


def test_cli_needs_out_and_defaults_to_no_path(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        main([])
    assert ei.value.code == 2
    assert "--out" in capsys.readouterr().err
    ap = build_parser()
    for action in ap._actions:
        if isinstance(action.default, str) and action.default:
            assert not os.path.exists(os.path.join(ROOT, action.default)), \
                action.dest
    assert ap.get_default("bench_out") is None
    assert ap.get_default("device") is None  # cuda, resolved at run time


def test_cli_runs_one_workload_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_QUICK", None)
    out = str(tmp_path / "r.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.collect", "--out", out,
         "--workloads", "atax_u2", "--jobs", "2", "--device", "cpu",
         "--strict"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "atax_u2" in proc.stdout and "verified=" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["r.json"]  # no bench file
    with open(out) as f:
        rec = json.load(f)["atax_u2"]
    assert _fields(rec) == _fields(REFERENCE["atax_u2"])


def test_no_card_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        collect(str(tmp_path / "r.json"), workloads=["atax_u2"])
    assert not os.path.exists(tmp_path / "r.json")
