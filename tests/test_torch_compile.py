"""The port's compile pipeline and CLI (``repro_torch.compiler.pipeline``,
``python -m repro_torch list|compile|inspect|diff|store get|store warm``)
against the JAX package's ``repro.compiler``, on the CPU
(``device="cpu"``).  Tolerance: exact equality of every artifact field but
wall time (``timings``, ``provenance``, each pass's ``wall_s``).

* ``job_grid()`` equals the corpus manifest's ``jobs`` and the JAX
  package's;
* ``compile(..., verify=True)`` of every job of atax_u2 and gemm_u2
  equals the JAX package's compile and the corpus file of the same cell;
* one store across packages: the JAX package's ``store warm --workloads
  atax_u2`` is read by the port's ``store get`` (hits, the same
  artifacts), and the reverse;
* the CLI's rows and exit codes: ``compile``, ``diff`` (``--golden``, and
  a flagged regression), ``inspect --verify``, ``list``;
* deadlines (an unmeetable one raises ``CompileTimeout``; with a fallback
  the artifact is degraded and never stored), ``REPRO_QUICK`` in the
  provenance and the key, a disproven mapping never stored, a device fault
  that propagates without the scalar oracle, and no card: refused.
"""
import contextlib
import io
import json
import os
import re

import pytest
import torch

from repro.compiler import compile as jax_compile
from repro.compiler.cli import main as jax_main
from repro.compiler.pipeline import job_grid as jax_job_grid
from repro_torch.compiler import faultinject
from repro_torch.compiler.artifact import CompileResult
from repro_torch.compiler.cli import main as port_main
from repro_torch.compiler.errors import CompileTimeout, exit_code_for
from repro_torch.compiler.pipeline import compile as port_compile
from repro_torch.compiler.pipeline import compile_key, job_grid
from repro_torch.compiler.store import ArtifactStore, key_for

from _torch_artifacts import CORPUS, fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_ii_quick.json")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def full_budget(monkeypatch):
    """The corpus is a full-budget compile: ``--quick`` must not clamp."""
    monkeypatch.delenv("REPRO_QUICK", raising=False)


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def untimed(text: str) -> str:
    """CLI output with each invocation's wall time blanked."""
    return re.sub(r"\(\d+\.\d+s\)", "(T)", text)


def test_job_grid_equals_manifest_and_jax():
    with open(os.path.join(CORPUS, "MANIFEST.json")) as f:
        jobs = json.load(f)["jobs"]
    assert job_grid() == {j: tuple(am) for j, am in jobs.items()}
    assert list(job_grid().items()) == list(jax_job_grid().items())


@pytest.mark.parametrize("key", ["atax_u2", "gemm_u2"])
@pytest.mark.parametrize("job", list(jax_job_grid()))
def test_compile_equals_jax_and_corpus(key, job):
    name, u = key.split("_u")
    arch, mapper = job_grid()[job]
    port = port_compile(name, unroll=int(u), arch=arch, mapper=mapper,
                        seed=0, verify=True, device="cpu")
    jax = jax_compile(name, unroll=int(u), arch=arch, mapper=mapper, seed=0,
                      verify=True)
    corpus = CompileResult.load(os.path.join(CORPUS, f"{key}__{job}.json"))
    assert fields(port) == fields(CompileResult.from_json(jax.to_json()))
    assert fields(port) == fields(corpus)
    assert port.verified is corpus.verified
    assert port.verified is bool(port.mappings)
    assert port.provenance["quick"] is False
    assert list(port.to_json()) == list(jax.to_json())
    assert list(port.timings) == list(jax.timings)
    assert port.summary().keys() == jax.summary().keys()
    assert compile_key(name, arch, mapper, unroll=int(u)).digest == \
        key_for(port).digest


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_store_across_packages(tmp_path, writer):
    """``store warm --workloads atax_u2`` by one package, then ``store
    get`` of every job by the other: all hits, the warmed artifacts."""
    store = str(tmp_path / "store")
    mains = {"jax": jax_main, "port": port_main}
    reader = "port" if writer == "jax" else "jax"
    rc, out, _ = run(mains[writer], ["store", "warm", "--dir", store,
                                     "--workloads", "atax_u2"])
    assert rc == 0 and "warm done: 7 compiled+stored, 0 already present" in out
    for job in job_grid():
        served = str(tmp_path / f"{job}.json")
        rc, out, _ = run(mains[reader], ["store", "get", "atax", "-u", "2",
                                         "--job", job, "--dir", store,
                                         "--out", served])
        assert rc == 0 and out.startswith("HIT"), out
        corpus = CompileResult.load(os.path.join(CORPUS,
                                                 f"atax_u2__{job}.json"))
        got = CompileResult.load(served)
        assert fields(got) == {**fields(corpus), "verified": None,
                               "compiled_sim": None}
    rc, out, _ = run(mains[reader], ["store", "warm", "--dir", store,
                                     "--workloads", "atax_u2"])
    assert rc == 0 and "warm done: 0 compiled+stored, 7 already present" in out
    rc, _, err = run(port_main, ["store", "get", "atax", "-u", "4", "--job",
                                 "plaid", "--dir", store])
    assert rc == 1 and err.startswith("MISS")


def test_store_get_verifying_on_the_cpu(tmp_path, monkeypatch):
    """A verifying ``store get`` (``--verify-policy always``) proves the
    entry on ``--device`` and still hits; without a card it is refused."""
    store = str(tmp_path / "store")
    assert run(port_main, ["store", "warm", "--dir", store, "--workloads",
                           "atax_u2", "--job", "spatial"])[0] == 0
    argv = ["store", "get", "atax", "-u", "2", "--job", "spatial", "--dir",
            store, "--verify-policy", "always"]
    rc, out, _ = run(port_main, argv + CPU)
    assert rc == 0 and out.startswith("HIT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = run(port_main, argv)
    assert rc == 2 and "CUDA" in err


def test_cli_compile_rows_equal_jax(tmp_path):
    rows = {}
    for pkg, main, extra in (("jax", jax_main, []), ("port", port_main, CPU)):
        out_dir = tmp_path / pkg
        out_dir.mkdir()
        rc, out, _ = run(main, ["compile", "atax", "-u", "2", "--all-jobs",
                                "--verify", "--out-dir", str(out_dir),
                                *extra])
        assert rc == 0
        rows[pkg] = untimed(out)
        assert sorted(os.listdir(out_dir)) == sorted(
            f"atax_u2__{job}.json" for job in job_grid())
    assert rows["port"] == rows["jax"]
    assert rows["port"].count(" verified ") == len(job_grid())
    for fn in os.listdir(tmp_path / "port"):
        a = CompileResult.load(str(tmp_path / "port" / fn))
        b = CompileResult.load(str(tmp_path / "jax" / fn))
        assert fields(a) == fields(b), fn
    # one job by name, and a job that is not on the grid
    rc, out, _ = run(port_main, ["compile", "atax", "-u", "2", "--job", "st",
                                 "--out", str(tmp_path / "st.json")])
    assert rc == 0 and "II=2" in out
    assert run(port_main, ["compile", "atax", "--job", "nope"])[0] == 2


def test_cli_compile_unmapped_cell_exits_1(tmp_path):
    """A verifying compile that finds no mapping records verified=False
    and exits 1, as the JAX package's (atax_u4 on the spatial job: the
    analytic segments hold no routed mapping)."""
    got = {}
    for pkg, main, extra in (("jax", jax_main, []), ("port", port_main, CPU)):
        rc, out, _ = run(main, ["compile", "atax", "-u", "4", "--job",
                                "spatial", "--verify", "--out",
                                str(tmp_path / f"{pkg}.json"), *extra])
        got[pkg] = (rc, untimed(out))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and "VERIFY-FAILED" in got["port"][1]


def test_cli_diff_golden_and_regression(tmp_path):
    out_dir = tmp_path / "arts"
    out_dir.mkdir()
    assert run(port_main, ["compile", "atax", "-u", "2", "--all-jobs",
                           "--out-dir", str(out_dir)])[0] == 0
    got = {pkg: run(main, ["diff", "--golden", GOLDEN, str(out_dir)])
           for pkg, main in (("jax", jax_main), ("port", port_main))}
    assert got["port"] == got["jax"]
    rc, out, _ = got["port"]
    assert rc == 0 and "0 regressed" in out

    # a flagged regression: a worse II against the golden file, and two
    # artifacts that differ
    good = str(out_dir / "atax_u2__plaid.json")
    res = CompileResult.load(good)
    res.ii += 1
    res.cycles += 1
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()
    bad = res.save(str(bad_dir / "atax_u2__plaid.json"))
    got = {pkg: run(main, ["diff", "--golden", GOLDEN, str(bad_dir)])
           for pkg, main in (("jax", jax_main), ("port", port_main))}
    assert got["port"] == got["jax"]
    rc, out, _ = got["port"]
    assert rc == 1 and "REGRESSION" in out and "1 regressed" in out
    got = {pkg: run(main, ["diff", good, bad])
           for pkg, main in (("jax", jax_main), ("port", port_main))}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and "ii: 3 != 4" in got["port"][1]
    assert run(port_main, ["diff", good, good])[0] == 0
    assert run(port_main, ["diff", good])[0] == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run(port_main, ["diff", "--golden", GOLDEN, str(empty)])[0] == 1


def test_cli_inspect_verify(tmp_path):
    path = os.path.join(CORPUS, "atax_u2__spatial.json")
    rows = {}
    for pkg, main, extra in (("jax", jax_main, []), ("port", port_main, CPU)):
        rc, out, _ = run(main, ["inspect", "--verify", path, *extra])
        assert rc == 0
        rows[pkg] = out
    assert rows["port"] == rows["jax"]
    assert "re-simulated 6 mapping(s) against the DFG oracle OK" in rows["port"]
    unmapped = os.path.join(CORPUS, "atax_u4__spatial.json")
    rc, out, _ = run(port_main, ["inspect", "--verify", unmapped, *CPU])
    assert rc == 1 and "no stored mapping to verify" in out
    # a mapping validate() rejects is a verdict, not a crash
    from _torch_artifacts import tampered, write_json

    bad = write_json(str(tmp_path / "bad.json"), tampered("op"))
    rc, out, _ = run(port_main, ["inspect", "--verify", bad, *CPU])
    assert rc == 1 and "VERIFY FAILED: AssertionError" in out


def test_cli_list_equals_jax():
    got = {pkg: run(main, ["list"])
           for pkg, main in (("jax", jax_main), ("port", port_main))}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    for name in ("sa", "hierarchical", "node_greedy", "pathfinder",
                 "pathfinder_selective", "pathfinder_global",
                 "pathfinder_window", "spatial"):
        assert f"  {name} " in got["port"][1]


def test_help_names_what_is_not_ported():
    """Nothing of ``plaid-compile`` is left unported: the help names the
    farm's ``serve`` and ``compile --remote``, and no "not ported"."""
    for argv, want in ((["--help"], "serve"),
                       (["compile", "--help"], "--remote")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            port_main(argv)
        assert want in out.getvalue()
        assert "not ported" not in out.getvalue().lower()
    # serve needs its socket
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        port_main(["serve", "--dir", "x"])


def test_deadline_that_cannot_be_met(tmp_path):
    """A deadline already past raises ``CompileTimeout`` in both packages;
    with a fallback mapper both degrade alike and nothing is stored."""
    kw = dict(unroll=2, mapper="hierarchical", deadline_s=-1.0)
    with pytest.raises(CompileTimeout) as port_err:
        port_compile("atax", **kw)
    from repro.compiler.errors import CompileTimeout as JaxTimeout

    with pytest.raises(JaxTimeout) as jax_err:
        jax_compile("atax", **kw)
    assert port_err.value.where == jax_err.value.where
    assert exit_code_for(port_err.value) == 12
    store = ArtifactStore(str(tmp_path / "store"), device="cpu")
    port = port_compile("atax", fallback_mapper="node_greedy", store=store,
                        verify=True, device="cpu", **kw)
    jax = jax_compile("atax", fallback_mapper="node_greedy", verify=True,
                      **kw)

    def deg(d):
        return {k: v for k, v in d.items() if k != "elapsed_s"}

    assert deg(port.degraded) == deg(jax.degraded)
    assert port.degraded["reason"] == "timeout"
    assert port.mapper == "node_greedy" and port.verified is True
    assert fields(port)["mappings"] == fields(
        CompileResult.from_json(jax.to_json()))["mappings"]
    assert store.ls() == [] and port.store_hit is False
    rc, _, err = run(port_main, ["compile", "atax", "-u", "2",
                                 "--deadline-s", "-1"])
    assert rc == 12 and "CompileTimeout" in err


def test_deadline_met_is_bit_identical():
    a = port_compile("bicg", unroll=2, mapper="pathfinder")
    b = port_compile("bicg", unroll=2, mapper="pathfinder", deadline_s=600.0)
    assert fields(a) == fields(b)


def test_quick_budget_is_in_the_provenance_and_the_key(tmp_path,
                                                       monkeypatch):
    """A compile under ``REPRO_QUICK`` stamps ``quick`` and keys apart: a
    full-budget consumer of the same store misses it."""
    store = str(tmp_path / "store")
    monkeypatch.setenv("REPRO_QUICK", "1")
    quick = port_compile("gemm", unroll=2, store=store)
    assert quick.provenance["quick"] is True and quick.store_hit is False
    assert port_compile("gemm", unroll=2, store=store).store_hit is True
    monkeypatch.delenv("REPRO_QUICK")
    full = port_compile("gemm", unroll=2, store=store)
    assert full.store_hit is False and full.provenance["quick"] is False
    corpus = CompileResult.load(os.path.join(CORPUS, "gemm_u2__plaid.json"))
    assert fields(full)["mappings"] == fields(corpus)["mappings"]
    assert len(ArtifactStore(store).ls()) == 2


def test_disproven_mapping_never_enters_the_store(tmp_path, monkeypatch):
    from repro_torch.sim import batch

    real = batch.verify_mappings

    def disproves(*a, **k):
        real(*a, **k)
        raise AssertionError("mapping[0] failed batched verification")

    monkeypatch.setattr(batch, "verify_mappings", disproves)
    store = str(tmp_path / "store")
    res = port_compile("atax", unroll=2, verify=True, device="cpu",
                       store=store)
    assert res.verified is False and res.store_hit is False
    assert ArtifactStore(store).ls() == []


def test_device_fault_propagates_without_the_oracle(tmp_path, monkeypatch):
    """An injected ``sim.batch`` fault during ``compile(verify=True)``
    propagates (the JAX package would degrade to its scalar oracle); the
    oracle is never reached and nothing is stored."""
    import repro_torch.core.simulate as scalar

    def no_oracle(*a, **k):
        raise AssertionError("reached the scalar oracle")

    monkeypatch.setattr(scalar, "simulate", no_oracle)
    store = str(tmp_path / "store")
    with faultinject.inject({"mode": "oserror", "site": "sim.batch"}):
        with pytest.raises(OSError):
            port_compile("atax", unroll=2, verify=True, device="cpu",
                         store=store)
    assert ArtifactStore(store).ls() == []
    ok = port_compile("atax", unroll=2, verify=True, device="cpu",
                      store=store)
    assert ok.verified is True and len(ArtifactStore(store).ls()) == 1


def test_verify_without_a_card_is_refused(tmp_path, monkeypatch):
    """``compile --verify`` runs on the card unless ``--device cpu``: with
    none it is refused before place & route (exit 2; ``RuntimeError``
    from the API), never run on the host."""
    from repro_torch.mapping.mappers import PipelineMapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_pnr(self, dfg):
        raise AssertionError("place & route ran")

    monkeypatch.setattr(PipelineMapper, "map", no_pnr)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_compile("atax", unroll=2, verify=True)
    rc, _, err = run(port_main, ["compile", "atax", "-u", "2", "--verify",
                                 "--out-dir", str(tmp_path)])
    assert rc == 2 and "CUDA" in err
    rc, _, err = run(port_main, ["inspect", "--verify",
                                 os.path.join(CORPUS, "atax_u2__plaid.json")])
    assert rc == 2 and "CUDA" in err
