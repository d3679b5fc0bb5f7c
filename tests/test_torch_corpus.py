"""The TABLE2 verification corpus shipped inside ``repro_torch``.

``src/repro_torch/corpus/table2/`` holds one artifact per (TABLE2 workload
x ``job_grid()`` job), compiled by the JAX package at seed 0 and full
budgets with ``verify=True`` (so each carries its ``compiled_sim`` forms),
plus ``MANIFEST.json``: the generating command, ``repro_version``, each
file's sha256 and the JAX package's own ``plaid-compile verify`` verdict.

Run this file as a script to (re)write the corpus::

    PYTHONPATH=src python tests/test_torch_corpus.py [--workers 6]
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORPUS = os.path.join(ROOT, "src", "repro_torch", "corpus", "table2")
MANIFEST = os.path.join(CORPUS, "MANIFEST.json")
GEN_COMMAND = "PYTHONPATH=src python tests/test_torch_corpus.py"


# -- generator ---------------------------------------------------------------


def _compile_cell(cell):
    """One (workload, unroll, job) cell -> artifact file name."""
    name, unroll, job, arch, mapper = cell
    from repro.compiler import compile

    res = compile(name, unroll=unroll, arch=arch, mapper=mapper, seed=0,
                  verify=True)
    fn = f"{res.key}__{job}.json"
    res.save(os.path.join(CORPUS, fn))
    return fn


def _jax_verify_verdicts(iterations: int = 3):
    """The JAX package's ``plaid-compile verify`` verdict per artifact:
    ``{file: {"verdict", "segments", "reason"}}``."""
    from repro.compiler.artifact import CompileResult
    from repro.compiler.cli import _job_of, main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["verify", CORPUS, "--iterations", str(iterations)])
    by_label = {}
    for line in buf.getvalue().splitlines():
        word = line[:6].strip()
        if word not in ("OK", "FAIL", "SKIP"):
            continue
        label = line[6:6 + 34].strip()
        by_label[label] = (word, line[6 + 35:].strip())
    out = {}
    for fn in sorted(os.listdir(CORPUS)):
        if not fn.endswith(".json") or fn == "MANIFEST.json":
            continue
        art = CompileResult.load(os.path.join(CORPUS, fn))
        word, text = by_label[f"{art.key}/{_job_of(art)}"]
        out[fn] = {
            "verdict": word,
            "segments": len(art.mappings),
            "reason": None if word == "OK" else text,
        }
    return rc, out


def generate(workers: int) -> None:
    os.environ.pop("REPRO_QUICK", None)
    from repro.compiler.artifact import REPRO_VERSION
    from repro.compiler.pipeline import job_grid
    from repro.core.workloads import TABLE2

    os.makedirs(CORPUS, exist_ok=True)
    for fn in os.listdir(CORPUS):
        if fn.endswith(".json"):
            os.unlink(os.path.join(CORPUS, fn))
    cells = [(w.name, w.unroll, job, arch, mapper)
             for w in TABLE2 for job, (arch, mapper) in job_grid().items()]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        for fn in ex.map(_compile_cell, cells):
            print(fn, flush=True)
    rc, verdicts = _jax_verify_verdicts()
    files = {}
    for fn, v in verdicts.items():
        with open(os.path.join(CORPUS, fn), "rb") as f:
            files[fn] = {"sha256": hashlib.sha256(f.read()).hexdigest(), **v}
    manifest = {
        "command": GEN_COMMAND,
        "repro_version": REPRO_VERSION,
        "compile": "repro.compiler.compile(name, unroll=, arch=, mapper=, "
                   "seed=0, verify=True) per TABLE2 x job_grid() cell, "
                   "REPRO_QUICK unset",
        "verify_command": "plaid-compile verify <corpus> --iterations 3",
        "verify_exit_code": rc,
        "iterations": 3,
        "jobs": {job: list(am) for job, am in job_grid().items()},
        "files": files,
    }
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    n = {k: sum(v["verdict"] == k for v in files.values())
         for k in ("OK", "FAIL", "SKIP")}
    print(f"wrote {len(files)} artifacts + MANIFEST.json: {n}")


# -- tests -------------------------------------------------------------------


def _manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def _artifact_files():
    return sorted(fn for fn in os.listdir(CORPUS)
                  if fn.endswith(".json") and fn != "MANIFEST.json")


@pytest.fixture(scope="module")
def corpus():
    """``[(file, jax CompileResult, port CompileResult)]`` over the corpus."""
    from repro.compiler.artifact import CompileResult as JaxResult
    from repro_torch.compiler.artifact import CompileResult

    return [(fn, JaxResult.load(os.path.join(CORPUS, fn)),
             CompileResult.load(os.path.join(CORPUS, fn)))
            for fn in _artifact_files()]


@pytest.fixture(scope="module")
def corpus_mappings(corpus):
    """Every stored mapping, as ``(jax Mapping, port Mapping)`` pairs."""
    out = []
    for _fn, jart, part in corpus:
        if jart.mappings:
            out.extend(zip(jart.rebuild_mappings(), part.rebuild_mappings()))
    return out


def test_manifest_hashes_match_files():
    m = _manifest()
    assert sorted(m["files"]) == _artifact_files()
    for fn, rec in m["files"].items():
        with open(os.path.join(CORPUS, fn), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == rec["sha256"], fn


def test_corpus_covers_grid_at_full_budget(corpus):
    from repro.compiler.pipeline import job_grid
    from repro.core.workloads import TABLE2
    from repro_torch.compiler.pipeline import job_grid as port_job_grid

    grid = job_grid()
    assert port_job_grid() == grid
    assert [fn for fn, _, _ in corpus] == sorted(
        f"{w.name}_u{w.unroll}__{job}.json" for w in TABLE2 for job in grid)
    for fn, jart, _ in corpus:
        assert jart.provenance["quick"] is False, fn
        assert jart.seed == 0 and jart.budget is None, fn
        if jart.mappings:
            assert jart.compiled_sim is not None, fn


def test_stored_forms_equal_jax_lowering(corpus):
    from repro.sim.lower import lower_mapping

    n = 0
    for fn, jart, _ in corpus:
        if not jart.mappings:
            continue
        forms = jart.compiled_sim["forms"]
        for m, stored in zip(jart.rebuild_mappings(), forms):
            assert lower_mapping(m, iterations=3).to_json() == stored, fn
            n += 1
    assert n == sum(v["segments"] for v in _manifest()["files"].values()
                    if v["verdict"] == "OK")


def test_stored_forms_bind_in_the_port(corpus):
    # mappings_sha256 binds only if the port's canonical JSON of the loaded
    # records is byte-identical to the JAX package's
    from repro.compiler.fsio import canonical_json_bytes as jax_bytes
    from repro_torch.compiler.fsio import canonical_json_bytes

    for fn, jart, part in corpus:
        if not part.mappings:
            continue
        assert canonical_json_bytes(part.mappings) == jax_bytes(jart.mappings)
        prepared = part._stored_prepared(3, "cpu")
        assert prepared is not None and prepared.packed is not None, fn
        assert part._stored_prepared(4, "cpu") is None


def test_cli_verify_matches_manifest_with_parity():
    """``python -m repro_torch verify`` on the whole corpus, on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "verify", CORPUS,
         "--device", "cpu", "--parity"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    got = {}
    for line in proc.stdout.splitlines():
        word = line[:6].strip()
        if word in ("OK", "FAIL", "SKIP"):
            got[line[6:40].strip()] = (word, line[41:].strip())
    files = _manifest()["files"]
    assert len(got) == len(files)
    for fn, want in files.items():
        word, detail = got[fn[:-len(".json")].replace("__", "/")]
        assert word == want["verdict"], (fn, detail)
        if word == "OK":
            assert detail == f"{want['segments']} mapping(s) verified"
        else:
            assert detail == want["reason"], fn
    n = sum(v["segments"] for v in files.values() if v["verdict"] == "OK")
    assert f"batched[cpu]: {n} mappings" in proc.stdout
    assert f"verdict parity on {n}/{n} mappings" in proc.stdout


def _reason_shape(reason):
    """A failure reason with the float text of value mismatches cut off
    (float32 and float64 backends print different digits)."""
    return None if reason is None else reason.split(": got ")[0]


@pytest.mark.parametrize("backend", ["jnp", "numpy"])
def test_port_verdicts_match_jax_per_mapping(corpus_mappings, backend):
    from repro.sim.batch import simulate_batch as jax_simulate_batch
    from repro_torch.sim.batch import simulate_batch
    from repro_torch.sim.check import F32_TOL, close

    jms = [j for j, _ in corpus_mappings]
    pms = [p for _, p in corpus_mappings]
    ours = simulate_batch(pms, iterations=3, device="cpu")
    theirs = jax_simulate_batch(jms, iterations=3, backend=backend)
    assert len(ours) == len(theirs) == len(corpus_mappings)
    for i, (v, w) in enumerate(zip(ours, theirs)):
        assert v.ok == w.ok, i
        assert _reason_shape(v.reason) == _reason_shape(w.reason), i
        if v.ok:
            assert set(v.values) == set(w.values), i
            assert all(close(v.values[k], w.values[k], F32_TOL)
                       for k in w.values), i


def test_compile_result_simulate_matches_jax(corpus):
    # a spatial artifact (several segments) and a modulo one, through the
    # artifact entry point of each package
    from repro_torch.sim.check import F32_TOL, close

    picked = [next(c for c in corpus if c[1].mappings
                   and len(c[1].mappings) > 1),
              next(c for c in corpus if len(c[1].mappings) == 1)]
    for fn, jart, part in picked:
        want = jart.simulate(iterations=3)
        got = part.simulate(iterations=3, device="cpu")
        assert len(got) == len(want), fn
        for g, w in zip(got, want):
            assert set(g) == set(w), fn
            assert all(close(g[k], w[k], F32_TOL) for k in w), fn
    with pytest.raises(ValueError, match="no routed mapping"):
        next(c[2] for c in corpus if not c[2].mappings).simulate(
            device="cpu")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=6)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    generate(ap.parse_args().workers)
