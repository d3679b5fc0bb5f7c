"""The port's CI and mapper benches against the JAX package's.

``scripts/torch_bench_route.py`` and ``scripts/torch_bench_place.py`` give
the reference scripts' trajectories and bench entries (the reference
scripts are loaded by path, nothing of them changes), their gates can fail,
and ``scripts/ci_torch.sh`` runs ``scripts/ci.sh``'s gates through
``repro_torch`` with ``--device`` on every verifying or compiling call and
a card-side test list that imports neither ``jax`` nor ``repro``.
"""
import ast
import hashlib
import importlib.util
import json
import os
import re
import subprocess

import pytest

from repro.core import workloads as ref_workloads
from repro.core.arch import make_arch as ref_make_arch
from repro.mapping.mappers import PathFinderMapper2 as RefPathFinderMapper2
from repro_torch.core import workloads as torch_workloads
from repro_torch.core.arch import make_arch as torch_make_arch
from repro_torch.mapping.mappers import PathFinderMapper2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
CI_SH = os.path.join(SCRIPTS, "ci.sh")
CI_TORCH_SH = os.path.join(SCRIPTS, "ci_torch.sh")

#: the gate of ci.sh with no counterpart (no network for the install)
DROPPED_GATES = ("dev extras (hypothesis: fully randomized property tests)",)
#: ci.sh's shim + import-cycle gate keeps its import-cycle half only (the
#: repro.core.mapper shim is not ported)
RENAMED_GATES = {
    "repro.mapping compat shim + import-cycle gate":
        "repro_torch import boundary + repro_torch.mapping import-cycle gate",
}
#: the subcommands that verify or compile, each of which takes --device
DEVICE_SUBCOMMANDS = ("compile", "inspect", "verify", "serve")
#: the two smallest TABLE2 workloads and a mid-size one
PARITY_WORKLOADS = (("dwconv", 1), ("cholesky", 2), ("gemm", 2))
SMALLEST = (("dwconv", 1), ("cholesky", 2))


def _load(name, filename):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return {
        "route": (_load("bench_route", "bench_route.py"),
                  _load("torch_bench_route", "torch_bench_route.py")),
        "place": (_load("bench_place", "bench_place.py"),
                  _load("torch_bench_place", "torch_bench_place.py")),
    }


def _smallest(pkg):
    return lambda: [(w, pkg.build_workload(w)) for w in (
        pkg.workload_by_name(n, u) for n, u in SMALLEST)]


@pytest.mark.parametrize("engine", ("legacy", "auto"))
@pytest.mark.parametrize("name,unroll", PARITY_WORKLOADS,
                         ids=[f"{n}_u{u}" for n, u in PARITY_WORKLOADS])
def test_route_trajectory_equals_the_reference_script(benches, name, unroll,
                                                      engine):
    ref, port = benches["route"]
    want, _, _ = ref._run(
        RefPathFinderMapper2, ref_make_arch("plaid3x3"),
        ref_workloads.build_workload(
            ref_workloads.workload_by_name(name, unroll)), engine)
    got, _, st = port._run(
        PathFinderMapper2, torch_make_arch("plaid3x3"),
        torch_workloads.build_workload(
            torch_workloads.workload_by_name(name, unroll)), engine)
    assert want is not None
    assert got == want  # (II, place, time, routes)
    assert st["route_s"] > 0


def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_key_tree(v) for v in x]
    return None


def _run_main(monkeypatch, tmp_path, script, pkg, argv):
    """``script.main(argv)`` in ``tmp_path`` with TABLE2 cut to its two
    smallest workloads; returns the exit code and the files left there."""
    tmp_path.mkdir(exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pkg, "all_workloads", _smallest(pkg))
    rc = script.main(argv)
    monkeypatch.undo()
    return rc, sorted(os.listdir(tmp_path))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("kind,argv", [
    ("route", ["--min-speedup", "0"]),
    ("place", ["--max-ratio", "1e9"]),
], ids=["route", "place"])
def test_bench_writes_the_reference_entry_to_bench_out_only(
        benches, monkeypatch, tmp_path, kind, argv):
    before = _digest(os.path.join(ROOT, "BENCH_mapper.json"))
    ref, port = benches[kind]
    out = {}
    for side, script, pkg in (("ref", ref, ref_workloads),
                              ("port", port, torch_workloads)):
        d = tmp_path / side
        rc, files = _run_main(monkeypatch, d, script, pkg,
                              argv + ["--bench-out", "bench.json"])
        assert rc == 0
        with open(d / "bench.json") as f:
            runs = json.load(f)["runs"]
        assert len(runs) == 1
        out[side] = (files, runs[0])
    assert out["port"][0] == out["ref"][0]  # the same files, no other
    assert "bench.json" in out["port"][0]
    entry = out["port"][1]
    assert f"{kind}_bench" in entry
    assert _key_tree(entry) == _key_tree(out["ref"][1])
    assert _digest(os.path.join(ROOT, "BENCH_mapper.json")) == before


@pytest.mark.parametrize("kind,argv", [
    ("route", ["--min-speedup", "1e9"]),
    ("place", ["--max-ratio", "0", "--skip-cold"]),
], ids=["route", "place"])
def test_bench_gate_can_fail(benches, monkeypatch, tmp_path, kind, argv):
    rc, files = _run_main(monkeypatch, tmp_path, benches[kind][1],
                          torch_workloads, argv)
    assert rc == 1
    assert files == []  # no --bench-out, nothing written


def _gates(path):
    with open(path) as f:
        return re.findall(r'^\s*echo "== (.*) =="$', f.read(), re.M)


def test_ci_torch_has_every_gate_of_ci_sh_in_order():
    want = [RENAMED_GATES.get(g, g) for g in _gates(CI_SH)
            if g not in DROPPED_GATES]
    assert len(want) == 13
    assert _gates(CI_TORCH_SH) == want


def _script():
    with open(CI_TORCH_SH) as f:
        return f.read()


def _commands(text):
    """The script's logical lines (continuations joined), comments out."""
    return [line for line in text.replace("\\\n", " ").splitlines()
            if not line.lstrip().startswith("#")]


def test_ci_torch_is_sound():
    proc = subprocess.run(["bash", "-n", CI_TORCH_SH], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    text = _script()
    assert not re.search(r"python -m repro(\.|\s)", text)
    assert not re.search(r"^\s*(from|import) repro(\.|\s)", text, re.M)
    assert "BENCH_mapper.json" not in text
    calls = 0
    for line in _commands(text):
        m = re.search(r"python -m repro_torch(\.core\.collect|\s+(\w+))",
                      line)
        if m and (m.group(1) == ".core.collect"
                  or m.group(2) in DEVICE_SUBCOMMANDS):
            calls += 1
            assert '--device "$CI_DEVICE"' in line, line
    # compile, inspect, 9 collects, verify, 2 serves
    assert calls == 14


def _cuda_tests():
    m = re.search(r'^CUDA_TESTS="([^"]*)"', _script(), re.M)
    return m.group(1).split()


def _imports(path, everywhere=True):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    nodes = ast.walk(tree) if everywhere else tree.body
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "importorskip"):
            yield from (a.value for a in node.args
                        if isinstance(a, ast.Constant))


def _clean(path, seen=()):
    """Whether ``path`` and the test helpers it imports load neither jax
    nor repro."""
    for name in _imports(path):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            return False
        helper = os.path.join(ROOT, "tests", top + ".py")
        if (os.path.exists(helper) and helper not in seen
                and not _clean(helper, seen + (path,))):
            return False
    return True


def test_the_card_side_test_list_imports_neither_jax_nor_repro():
    listed = _cuda_tests()
    assert "tests/test_torch_cuda.py" in listed
    tests = os.path.join(ROOT, "tests")
    clean = sorted(
        f"tests/{f}" for f in os.listdir(tests)
        if f.startswith("test_torch_") and f.endswith(".py")
        and _clean(os.path.join(tests, f)))
    assert sorted(listed) == clean
    # conftest loads on the card too: its module level (the reference's
    # fixtures import it lazily, and the listed files use none of them)
    assert not [n for n in _imports(os.path.join(tests, "conftest.py"),
                                    everywhere=False)
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
