"""The port's artifact store, journal, fault injection and the verify front
door against the JAX package's, on one shared on-disk store.

Artifacts come from the TABLE2 corpus (``src/repro_torch/corpus/table2/``):
the seven jobs of atax_u2 (the spatial one with six segments), two without
a mapping, and the step-0 tampered copy of ``atax_u2__plaid.json`` that
``Mapping.validate()`` rejects (``tests/_torch_artifacts.py``).  The
port's verifying ``get`` runs on the CPU here (``device="cpu"``); the JAX
package's on its default numpy backend.

* a store written by either package is read by the other: the same entry
  bytes, digests, ``ls`` rows, ``iter_artifacts`` and verified flags;
* a torn journal tail and a corrupt entry heal the same way in both;
* the ``never|first|always`` verify policies give equal results and
  counters (``verify_runs``, ``verify_failures``, ``rejected``,
  ``misses``), and ``gc`` to a byte cap evicts the same digests;
* injected faults at ``store.get`` and ``store.put`` raise
  ``StoreIOError`` in both; at ``sim.batch`` the port's ``get`` and
  ``verify --dir`` raise the ``OSError`` and leave the entry and the index
  as they were (the JAX package's ``get`` degrades to its scalar oracle
  instead, which the port deliberately does not);
* ``verify --dir`` prints the JAX package's rows and the rows of the same
  artifacts named as files; ``--bench-out`` appends the JAX package's
  entry shape; ``store put|ls|gc`` print what the JAX package prints;
* a verifying ``get``, ``verify --dir`` and ``energy_sweep`` run on the
  card unless the caller asks for the CPU, and refuse without one.
"""
import contextlib
import io
import json
import os
import re
import shutil

import pytest
import torch

from repro.compiler import faultinject as jax_faultinject
from repro.compiler.cli import main as jax_main
from repro.compiler.errors import StoreIOError as JaxStoreIOError
from repro.compiler.store import ArtifactStore as JaxStore
from repro.compiler.store import key_for as jax_key_for
from repro.compiler.artifact import CompileResult as JaxResult
from repro_torch.compiler import faultinject
from repro_torch.compiler.artifact import CompileResult
from repro_torch.compiler.cli import main as port_main
from repro_torch.compiler.errors import SimulationFault, StoreIOError
from repro_torch.compiler.store import ArtifactStore, key_for
from repro_torch.core.collect import _append_bench
from repro_torch.core.power_area import energy_sweep

from _torch_artifacts import CORPUS, corpus_json, tampered, write_json

FILES = ["atax_u2__node_on_plaid.json", "atax_u2__pf_on_plaid.json",
         "atax_u2__plaid.json", "atax_u2__plaid3x3.json",
         "atax_u2__plaid_ml.json", "atax_u2__spatial.json",
         "atax_u2__st.json", "atax_u4__spatial.json",
         "bicg_u4__plaid_ml.json"]
#: row fields stamped from the clock or the file system at write time
CLOCK = ("created", "last_used", "mtime")

PORT = dict(store=lambda root, **kw: ArtifactStore(root, device="cpu", **kw),
            result=CompileResult, key_for=key_for, main=port_main,
            store_io=StoreIOError, inject=faultinject.inject,
            verify_argv=["--device", "cpu"])
JAX = dict(store=JaxStore, result=JaxResult, key_for=jax_key_for,
           main=jax_main, store_io=JaxStoreIOError,
           inject=jax_faultinject.inject, verify_argv=[])
PACKAGES = {"port": PORT, "jax": JAX}


def _artifacts(tmp_path, unverify=False):
    """Artifact files to put: the corpus subset (every other one with its
    ``verified`` flag cleared when ``unverify``) and the tampered copy."""
    out = []
    for i, fn in enumerate(FILES):
        data = corpus_json(fn)
        if unverify and i % 2 == 0:
            data["verified"] = None
        out.append(write_json(str(tmp_path / fn), data))
    bad = tampered("op")
    bad["seed"] = 1  # a key of its own beside atax_u2__plaid's
    bad["verified"] = None  # nothing ever proved it
    out.append(write_json(str(tmp_path / "tampered.json"), bad))
    return out


def _put(pkg, root, paths):
    store = pkg["store"](root)
    keys = []
    for p in paths:
        res = pkg["result"].load(p)
        store.put(res, key=pkg["key_for"](res))
        keys.append(pkg["key_for"](res))
    return store, keys


def _rows(store):
    return [{k: v for k, v in r.items() if k not in CLOCK}
            for r in store.ls()]


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _state(root):
    """Bytes of the index snapshot and journal, and the entry listing."""
    out = {}
    for name in ("index.json", "journal.jsonl"):
        path = os.path.join(root, name)
        out[name] = open(path, "rb").read() if os.path.exists(path) else None
    out["entries"] = sorted(os.listdir(os.path.join(root, "entries")))
    return out


# -- one store, two packages -------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_store_written_by_either_is_read_by_the_other(tmp_path, writer,
                                                      reader):
    paths = _artifacts(tmp_path, unverify=True)
    w, r = PACKAGES[writer], PACKAGES[reader]
    root = str(tmp_path / "store")
    wstore, keys = _put(w, root, paths)
    other = str(tmp_path / "other")
    _put(r, other, paths)
    # the entry files are byte for byte the same, whoever wrote them
    assert sorted(os.listdir(os.path.join(root, "entries"))) == \
        sorted(os.listdir(os.path.join(other, "entries")))
    for fn in os.listdir(os.path.join(root, "entries")):
        assert open(os.path.join(root, "entries", fn), "rb").read() == \
            open(os.path.join(other, "entries", fn), "rb").read()
    rstore = r["store"](root)
    assert [k.digest for k in keys] == \
        [r["key_for"](r["result"].load(p)).digest for p in paths]
    assert _rows(rstore) == _rows(wstore) == _rows(r["store"](other))
    got = [(k.describe(), a.to_json()) for k, a in rstore.iter_artifacts()]
    want = [(k.describe(), a.to_json()) for k, a in wstore.iter_artifacts()]
    assert got == want and len(got) == len(paths)
    flags = [rstore.is_verified(k) for k in keys]
    assert flags == [wstore.is_verified(k) for k in keys]
    assert True in flags and False in flags
    # a verdict persisted by the reader is seen by the writer
    unverified = keys[flags.index(False)]
    rstore.mark_verified(unverified)
    assert wstore.is_verified(unverified)


def test_torn_journal_tail_heals_alike(tmp_path):
    root = str(tmp_path / "store")
    _put(PORT, root, _artifacts(tmp_path))
    journal = os.path.join(root, "journal.jsonl")
    lines = open(journal, "rb").read().splitlines(keepends=True)
    # one record bit-flipped mid-journal, then a torn final line
    bad = lines[3].replace(b'"put"', b'"pvt"')
    with open(journal, "wb") as f:
        f.write(b"".join(lines[:3]) + bad + b"".join(lines[4:])
                + b'{"op": "touch", "d": "ab')
    results = {}
    for name, pkg in PACKAGES.items():
        copy = str(tmp_path / name)
        shutil.copytree(root, copy)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rows = _rows(pkg["store"](copy))
        state = _state(copy)
        state.pop("index.json")  # adopted rows carry the clock
        results[name] = (rows, state, out.getvalue().replace(copy, "STORE"))
    assert results["port"] == results["jax"]
    rows, state, out = results["port"]
    # the two records before the flipped one replay; the orphaned entry
    # files are adopted; the journal is truncated, then compacted
    assert "torn/corrupt record at byte" in out
    assert len(rows) == 10
    assert [r["seq"] for r in rows[-2:]] == [2, 1]
    assert state["journal.jsonl"].count(b"\n") == 1


def test_corrupt_entry_is_rejected_alike(tmp_path):
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _, keys = _put(PORT, root, paths)
    victim = keys[2]
    entry = os.path.join(root, "entries", victim.digest + ".json")
    data = json.load(open(entry))
    data["artifact"]["ii"] = 99
    json.dump(data, open(entry, "w"))
    results = {}
    for name, pkg in PACKAGES.items():
        copy = str(tmp_path / name)
        shutil.copytree(root, copy)
        store = pkg["store"](copy, verify="always")
        got = store.get(victim)
        results[name] = (got, store.counters.to_json(), _rows(store),
                         _state(copy)["entries"])
    assert results["port"] == results["jax"]
    got, counters, _rows_, listing = results["port"]
    assert got is None
    assert counters["rejected"] == 1 and counters["misses"] == 1
    assert victim.digest + ".json.corrupt" in listing


@pytest.mark.parametrize("policy", ["never", "first", "always"])
def test_verify_policies_match_the_jax_package(tmp_path, policy):
    """Two passes of ``get`` over every key, under each policy: the same
    artifacts served (the tampered one quarantined wherever a policy
    verifies it), the same counters and the same index rows."""
    paths = _artifacts(tmp_path, unverify=True)
    root = str(tmp_path / "store")
    _, keys = _put(PORT, root, paths)
    results = {}
    for name, pkg in PACKAGES.items():
        copy = str(tmp_path / name)
        shutil.copytree(root, copy)
        store = pkg["store"](copy, verify=policy)
        served = []
        for _ in range(2):
            for k in keys:
                res = store.get(k)
                served.append(None if res is None else res.to_json())
        results[name] = (served, store.counters.to_json(), _rows(store),
                         _state(copy)["entries"])
    assert results["port"] == results["jax"]
    served, counters, _r, listing = results["port"]
    n = len(keys)
    if policy == "never":
        assert counters["verify_runs"] == 0 and None not in served
    else:
        assert counters["verify_failures"] == 1
        assert served[n - 1] is None and served[2 * n - 1] is None
        assert any(f.endswith(".unverified") for f in listing)
    if policy == "always":
        # every mapped entry, each pass, until the tampered one is gone
        assert counters["verify_runs"] == 2 * (n - 2) - 1
    if policy == "first":
        # the unverified mapped entries once each, and the tampered one
        assert counters["verify_runs"] == 4 + 1


def test_gc_to_a_byte_cap_evicts_the_same_digests(tmp_path):
    paths = _artifacts(tmp_path)
    results = {}
    for name, pkg in PACKAGES.items():
        root = str(tmp_path / name)
        store, keys = _put(pkg, root, paths)
        for k in keys[::3]:
            store.get(k)  # recency: these survive
        cap = store.total_bytes() // 2
        evicted = store.gc(max_bytes=cap)
        results[name] = (evicted, sorted(r["key_digest"]
                                         for r in store.ls()),
                         store.total_bytes() <= cap)
    assert results["port"] == results["jax"]
    assert results["port"][0] > 0 and results["port"][2]


# -- fault injection ---------------------------------------------------------


@pytest.mark.parametrize("site", ["store.get", "store.put"])
def test_store_io_faults_raise_store_io_error_alike(tmp_path, site):
    paths = _artifacts(tmp_path)
    for name, pkg in PACKAGES.items():
        root = str(tmp_path / name)
        store, keys = _put(pkg, root, paths[:2])
        before = _state(root)
        spec = {"mode": "oserror", "site": site}
        with pkg["inject"](spec), pytest.raises(pkg["store_io"]):
            if site == "store.get":
                store.get(keys[0])
            else:
                res = pkg["result"].load(paths[2])
                store.put(res, key=pkg["key_for"](res))
        assert _state(root) == before, name
        assert store.get(keys[0]) is not None


def test_sim_batch_fault_raises_out_of_a_verifying_get(tmp_path):
    """An injected ``sim.batch`` ``OSError`` is a device fault, not a
    failed verification: it propagates out of the port's ``get``, nothing
    is quarantined and the index is untouched.  (The JAX package's ``get``
    degrades to its scalar oracle and serves the entry.)"""
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    store, keys = _put(PORT, root, paths)
    shutil.copytree(root, str(tmp_path / "jax"))
    before = _state(root)
    spec = {"mode": "oserror", "site": "sim.batch"}
    store = ArtifactStore(root, verify="always", device="cpu")
    with faultinject.inject(spec), pytest.raises(OSError, match="sim.batch"):
        store.get(keys[0])
    assert _state(root) == before
    assert store.counters.to_json() == dict(
        hits=0, misses=0, puts=0, evictions=0, rejected=0, verify_runs=1,
        verify_failures=0)
    assert store.get(keys[0]) is not None and store.counters.hits == 1
    jax_store = JaxStore(str(tmp_path / "jax"), verify="always")
    with jax_faultinject.inject(spec), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        assert jax_store.get(jax_key_for(JaxResult.load(paths[0])))
    assert "degrading to the scalar simulator" in out.getvalue()


def test_sim_batch_fault_fails_verify_dir_and_leaves_the_index(tmp_path):
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _put(PORT, root, paths)
    before = _state(root)
    spec = {"mode": "oserror", "site": "sim.batch"}
    for pkg in PACKAGES.values():
        with pkg["inject"](spec), pytest.raises(OSError, match="sim.batch"):
            _cli(pkg["main"], ["verify", "--dir", root] + pkg["verify_argv"])
        assert _state(root) == before


@pytest.mark.parametrize("target,exc", [("run_bucket", ValueError),
                                        ("run_bucket", TypeError),
                                        ("pack_bucket", ValueError)])
def test_simulation_fault_leaves_the_entry_and_the_index(tmp_path,
                                                         monkeypatch, target,
                                                         exc):
    """A loop or packing step that raises one of ``VERIFY_FAILURES`` other
    than ``AssertionError`` (as ``sim_loop_cuda``'s input checks do) on a
    mapping that loaded and validated is a fault of the simulation path,
    not a verdict: the verifying ``get`` raises ``SimulationFault``, counts
    no failure, quarantines nothing and leaves the index as it was."""
    from repro_torch.sim import batch

    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _, keys = _put(PORT, root, paths)
    before = _state(root)
    store = ArtifactStore(root, verify="always", device="cpu")

    def refuse(*_a, **_k):
        raise exc(f"{target} refused its inputs")

    monkeypatch.setattr(batch, target, refuse)
    with pytest.raises(SimulationFault, match=f"{target} refused"):
        store.get(keys[2])
    assert _state(root) == before
    assert store.counters.verify_failures == 0
    assert store.counters.misses == 0
    monkeypatch.undo()
    assert store.get(keys[2]) is not None


@pytest.mark.parametrize("env", ["jnp", "pallas", "numpy", "auto"])
def test_reference_backend_variable_leaves_the_store_alone(tmp_path,
                                                           monkeypatch, env):
    """A store put by the JAX package and read by the port with the JAX
    package's ``REPRO_SIM_BACKEND`` set keeps its entries: the port reads
    no backend from the environment.  Its default device is the card, so
    on a host without one every verifying ``get`` raises and touches
    nothing; on the CPU it serves and quarantines what the JAX package
    does with the variable unset."""
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _, keys = _put(JAX, root, paths)
    shutil.copytree(root, str(tmp_path / "jax"))
    shutil.copytree(root, str(tmp_path / "port"))
    jax_store = JaxStore(str(tmp_path / "jax"), verify="always")
    want = [jax_store.get(k) is not None for k in keys]
    assert want.count(False) == 1  # the tampered copy
    monkeypatch.setenv("REPRO_SIM_BACKEND", env)
    before = _state(root)
    store = ArtifactStore(root, verify="always")
    if torch.cuda.is_available():
        assert [store.get(k) is not None for k in keys] == want
    else:
        for k, p in zip(keys, paths):
            if CompileResult.load(p).mappings:
                with pytest.raises(RuntimeError, match="CUDA"):
                    store.get(k)
        assert _state(root) == before
        assert store.counters.verify_failures == 0
    port = ArtifactStore(str(tmp_path / "port"), verify="always",
                         device="cpu")
    assert [port.get(k) is not None for k in keys] == want
    assert port.counters.to_json() == jax_store.counters.to_json()
    assert _rows(port) == _rows(jax_store)


def test_corrupt_put_fault_is_caught_on_the_next_get(tmp_path):
    paths = _artifacts(tmp_path)
    for name, pkg in PACKAGES.items():
        store = pkg["store"](str(tmp_path / name))
        res = pkg["result"].load(paths[0])
        with pkg["inject"]({"mode": "corrupt", "site": "store.put"}):
            store.put(res, key=pkg["key_for"](res))
        assert store.get(pkg["key_for"](res)) is None
        assert store.counters.rejected == 1, name


# -- the CLI -----------------------------------------------------------------


def test_verify_dir_rows_equal_the_jax_package_and_named_files(tmp_path):
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _, keys = _put(PORT, root, paths)
    entry = os.path.join(root, "entries", keys[1].digest + ".json")
    with open(entry, "a") as f:
        f.write("torn")
    port = _cli(port_main, ["verify", "--dir", root, "--device", "cpu"])
    jax = _cli(jax_main, ["verify", "--dir", root])

    def rows(out):
        return [ln for ln in out.splitlines()
                if ln[:6].strip() in ("OK", "FAIL", "SKIP")]

    assert port[0] == jax[0] == 1  # the tampered entry
    assert rows(port[1]) == rows(jax[1]) and len(rows(port[1])) == 9
    assert port[2] == jax[2] == "note: 1 corrupt store entry skipped\n"
    named = _cli(port_main, ["verify", *[p for i, p in enumerate(paths)
                                         if i != 1], "--device", "cpu"])
    assert named[0] == 1

    def verdicts(out):
        return sorted(ln[:6] + re.search(
            r"(\d+ mapping\(s\) verified|unloadable mapping .*"
            r"|no stored mapping .*)$", ln).group(1) for ln in rows(out))

    assert verdicts(named[1]) == verdicts(port[1])


def test_bench_out_appends_the_jax_entry_shape(tmp_path):
    path = os.path.join(CORPUS, "atax_u2__plaid.json")
    port_bench, jax_bench = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    stranded = port_bench + ".stranded-1-2.json"
    write_json(stranded, {"runs": [{"utc": "x", "note": "stranded"}]})
    for _ in range(2):
        rc, out, _err = _cli(port_main, [
            "verify", path, "--device", "cpu", "--parity",
            "--bench-out", port_bench, "--bench-note", "card"])
        assert rc == 0 and f"appended to {port_bench}" in out
    rc, _o, _e = _cli(jax_main, ["verify", path, "--parity",
                                 "--bench-out", jax_bench,
                                 "--bench-note", "card"])
    assert rc == 0
    runs = json.load(open(port_bench))["runs"]
    (want,) = json.load(open(jax_bench))["runs"]
    assert not os.path.exists(stranded) and runs[0]["note"] == "stranded"
    assert len(runs) == 3
    for got in runs[1:]:
        assert sorted(got) == sorted(want)
        assert sorted(got["sim_throughput"]) == sorted(want["sim_throughput"])
        assert got["sim_throughput"]["backend"] == "cpu"
        for k in ("mappings", "buckets", "scalar_fallbacks", "iterations"):
            assert got["sim_throughput"][k] == want["sim_throughput"][k]
    with open(port_bench, "w") as f:
        f.write("{torn")
    with contextlib.redirect_stdout(io.StringIO()):
        _append_bench(port_bench, {"utc": "y"})
    assert json.load(open(port_bench)) == {"runs": [{"utc": "y"}]}
    assert os.path.exists(port_bench + ".corrupt")


def test_store_cli_prints_what_the_jax_package_prints(tmp_path):
    paths = _artifacts(tmp_path)[:-1] + [str(tmp_path / "missing.json")]
    outs = {}
    for name, pkg in PACKAGES.items():
        root = str(tmp_path / name)
        outs[name] = [
            _cli(pkg["main"], ["store", "put", "--dir", root, *paths]),
            _cli(pkg["main"], ["store", "ls", "--dir", root]),
            _cli(pkg["main"], ["store", "gc", "--dir", root,
                               "--max-bytes", "60000"]),
            _cli(pkg["main"], ["store", "ls", "--dir", root]),
        ]
    assert outs["port"] == outs["jax"]
    put, ls, gc, ls_after = outs["port"]
    assert put[0] == 1 and "not a loadable artifact" in put[2]
    assert ls[1].count("\n") == len(paths) - 1 + 3
    assert gc[1].startswith("gc: evicted ") and ls_after != ls


def test_entry_points_run_on_cuda_unless_asked(tmp_path, monkeypatch):
    """A verifying ``get``, ``verify --dir`` and ``energy_sweep`` default to
    the card: on a host without one they refuse (a ``RuntimeError``, exit
    2), touch nothing, and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    paths = _artifacts(tmp_path)
    root = str(tmp_path / "store")
    _, keys = _put(PORT, root, paths)
    before = _state(root)
    store = ArtifactStore(root, verify="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        store.get(keys[0])
    assert _state(root) == before and store.counters.verify_failures == 0
    rc, _out, err = _cli(port_main, ["verify", "--dir", root])
    assert rc == 2 and "CUDA" in err
    ms = CompileResult.load(paths[0]).rebuild_mappings()
    with pytest.raises(RuntimeError, match="CUDA"):
        energy_sweep([("plaid2x2", ms[0], 10)])
    assert ArtifactStore(root, verify="never").get(keys[0]) is not None
