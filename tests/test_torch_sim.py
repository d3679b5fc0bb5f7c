"""``repro_torch.sim`` on the CPU vs the JAX package's ``repro.sim``.

The same mappings (the ``KERNELS`` fixtures of ``test_sim_batch.py``:
atax_u2, dwconv_u1 and jacobi_u1 on plaid2x2) go through both packages:

* the port's ``lower_mapping`` equals the JAX one field for field, and its
  JSON round-trip works;
* the port's ``run_bucket`` on the CPU, given the same ``PackedBucket``,
  matches ``run_bucket_jnp`` with and without Pallas and
  ``run_bucket_numpy``: ``done``/``fail`` exactly, ``val`` within
  ``F32_TOL``;
* corrupted mappings get the same verdicts (and reasons) as the JAX
  ``simulate_batch`` and ``scalar_verdict``;
* warm ``prepared`` reruns equal the cold run, stale ones raise, and a
  call without ``device`` raises on a host without CUDA;
* within one cycle, no scatter index other than the dump slots repeats;
* the premise of the fused ``sim_loop`` kernel (one block per mapping, each
  stopping at its own horizon): each mapping run alone, in a one-mapping
  bucket up to its own horizon, gives its slice of the batched run; and a
  CUDA bucket hands the kernel the statics of ``sim_loop.STATICS`` and
  reads its state back in the eager loop's layout;
* stored mappings are validated against their fabric before they are
  simulated: four faults no simulation sees (a load on an ALU, an FU
  conflict in one modulo slot, a route ending off the consumer's read
  ports, a capacity-1 resource holding two nets) FAIL ``verify`` with the
  JAX package's row, reason and exit code;
* the numpy float64 backend equals the JAX package's ``run_bucket_numpy``
  bit for bit on the TABLE2 corpus bucket, and runs only when asked;
* ``energy_sweep`` rows equal the JAX package's.
"""
import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.compiler.artifact import CompileResult as JaxCompileResult
from repro.compiler.artifact import mapping_to_record
from repro.compiler.cli import main as jax_cli_main
from repro.core.mapper import HierarchicalMapper
from repro.core.power_area import energy_sweep as jax_energy_sweep
from repro.sim.batch import pack_bucket as jax_pack_bucket
from repro.sim.batch import prepare_batch as jax_prepare_batch
from repro.sim.batch import simulate_batch as jax_simulate_batch
from repro.sim.check import scalar_verdict as jax_scalar_verdict
from repro.sim.lower import CompiledSim as JaxCompiledSim
from repro.sim.lower import lower_mapping as jax_lower_mapping
from repro.sim.step import run_bucket_jnp, run_bucket_numpy
from repro.sim.step import run_bucket_numpy as jax_run_bucket_numpy
from repro_torch.compiler.artifact import CompileResult
from repro_torch.compiler.cli import main as port_cli_main
from repro_torch.core.arch import make_arch
from repro_torch.core.power_area import energy_sweep
from repro_torch.core.simulate import simulate
from repro_torch.mapping.mapping import Mapping
from repro_torch.mapping.mapping import mapping_to_record as port_to_record
from repro_torch.sim.batch import (
    pack_bucket,
    prepare_batch,
    select_backend,
    simulate_batch,
    verify_mappings,
)
from repro_torch.sim.check import (DEFAULT_TOL, F32_TOL, close_array,
                                   scalar_verdict, tolerance_for)
from repro_torch.sim.lower import CompiledSim, lower_mapping
from repro_torch.kernels import sim_loop
from repro_torch.sim import step
from repro_torch.sim.step import (PackedBucket, _cycle, _kernel_statics,
                                  _statics, run_bucket, run_bucket_eager)
from repro_torch.sim.step import run_bucket_numpy as port_run_bucket_numpy
from _torch_artifacts import (CORPUS, TAMPER_KINDS, corpus_files,
                              corpus_json, tampered, write_json)

KERNELS = [("atax", 2), ("dwconv", 1), ("jacobi", 1)]
FIELDS = (CompiledSim._INT_FIELDS + CompiledSim._BOOL_FIELDS
          + CompiledSim._F64_FIELDS + ("op_kind",))


@pytest.fixture(scope="module")
def jax_mappings(workload_dfg, arch):
    out = []
    for name, unroll in KERNELS:
        m = HierarchicalMapper(arch("plaid2x2"), seed=0).map(
            workload_dfg(name, unroll))
        assert m is not None, f"{name}_u{unroll} failed to map"
        out.append(m)
    return out


def _port(m):
    """The port's Mapping for a JAX mapping, through the artifact record."""
    return Mapping.from_record(json.loads(json.dumps(mapping_to_record(m))))


def _corrupted(good):
    dropped = copy.deepcopy(good)
    dropped.routes.pop(next(iter(dropped.routes)))
    foreign = copy.deepcopy(good)
    foreign.place[99999] = 0
    shifted = copy.deepcopy(good)
    nid = next(iter(shifted.time))
    shifted.time[nid] += 1
    return [good, dropped, foreign, shifted]


def _assert_forms_equal(got, want):
    assert (got.ii, got.horizon, got.iterations) == \
        (want.ii, want.horizon, want.iterations)
    assert got.node_ids == want.node_ids
    assert got.fail_static == want.fail_static
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype, f
        assert (g == w).all(), f


# -- mapping records and lowering --------------------------------------------


@pytest.mark.parametrize("k", range(len(KERNELS)),
                         ids=[f"{n}_u{u}" for n, u in KERNELS])
def test_record_roundtrip_matches_jax(jax_mappings, k):
    m = jax_mappings[k]
    pm = _port(m)
    assert port_to_record(pm) == mapping_to_record(m)
    assert pm.makespan == m.makespan


@pytest.mark.parametrize("k", range(len(KERNELS)),
                         ids=[f"{n}_u{u}" for n, u in KERNELS])
def test_lowering_matches_jax(jax_mappings, k):
    m = jax_mappings[k]
    got = lower_mapping(_port(m), iterations=3)
    _assert_forms_equal(got, jax_lower_mapping(m, iterations=3))
    # the port's JSON round-trip, through real JSON text, and across
    # packages: the compiled@1 schema is shared
    text = json.dumps(got.to_json())
    _assert_forms_equal(CompiledSim.from_json(json.loads(text)), got)
    _assert_forms_equal(
        CompiledSim.from_json(jax_lower_mapping(m, iterations=3).to_json()),
        got)
    assert JaxCompiledSim.from_json(json.loads(text)).node_ids == \
        got.node_ids
    with pytest.raises(ValueError, match="compiled@1"):
        CompiledSim.from_json({"schema": "something/else"})


# -- the cycle loop ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bucket(jax_mappings):
    batch = jax_mappings + _corrupted(jax_mappings[0])[1:]
    return jax_pack_bucket([jax_lower_mapping(m, iterations=3)
                            for m in batch])


def _assert_run_matches(got, want):
    val, done, fail = got
    wval, wdone, wfail = want
    assert val.dtype == np.float64 and val.shape == wval.shape
    np.testing.assert_array_equal(done, wdone)
    np.testing.assert_array_equal(fail, wfail)
    assert close_array(val, wval, F32_TOL).all()


@pytest.mark.parametrize("reference", ["jnp", "pallas", "numpy"])
def test_run_bucket_matches_jax(jax_bucket, reference):
    pb = PackedBucket.from_numpy(vars(jax_bucket), "cpu")
    got = run_bucket(pb)
    if reference == "numpy":
        want = run_bucket_numpy(jax_bucket)
    else:
        want = run_bucket_jnp(jax_bucket, use_pallas=reference == "pallas")
    _assert_run_matches(got, want)
    # the corrupted members really exercise the read-failure path
    assert got[2].any() and not got[2][:len(KERNELS)].any()


def test_port_packing_matches_jax(jax_mappings):
    forms = [lower_mapping(_port(m), iterations=3) for m in jax_mappings]
    ours = pack_bucket(forms, "cpu")
    theirs = jax_pack_bucket([jax_lower_mapping(m, iterations=3)
                              for m in jax_mappings])
    assert (ours.iterations, ours.hmax, ours.shape) == \
        (theirs.iterations, theirs.hmax, theirs.shape)
    for f in ("ii", "horizon", "opcode", "exec_mask", "issue", "compare",
              "leaf", "ref", "op_kind", "op_src", "op_dist", "op_feed",
              "op_steps", "step_src", "step_abs"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)


def test_scatter_indices_repeat_only_at_dump_slots(jax_bucket):
    pb = PackedBucket.from_numpy(vars(jax_bucket), "cpu")
    B, N, K, M, S = pb.shape
    I = pb.iterations
    s = _statics(pb)
    val = torch.zeros(B * (N + 2) * I)
    done = torch.zeros(B * (N + 2) * I, dtype=torch.bool)
    avail = torch.zeros(B * (S + 2) * I, dtype=torch.bool)
    fail = torch.zeros(B, dtype=torch.bool)
    n_writes = 0
    for t in range(pb.hmax):
        idx, widx = _cycle(s, t, val, done, avail, fail)
        for ix, dump in ((idx, s["dump"]), (widx, s["wdump"])):
            real = ix[ix != dump]
            assert real.unique().numel() == real.numel(), t
            n_writes += real.numel()
    assert n_writes > 0
    # row N (the read sentinel) is never written
    assert not done.view(B, N + 2, I)[:, N, :].any()


def _one_mapping(pb: PackedBucket, b: int) -> PackedBucket:
    """Mapping ``b`` of ``pb`` alone, same padding, run to its own horizon."""
    fields = {f: getattr(pb, f)[b:b + 1] for f in step._FIELDS}
    return PackedBucket(iterations=pb.iterations,
                        hmax=int(pb.horizon[b]), device=pb.device, **fields)


def test_each_mapping_alone_equals_its_slice_of_the_batch(jax_bucket):
    """What lets one block of the fused kernel own one mapping and stop at
    its own horizon: no mapping reads another's state, and no cycle past a
    mapping's horizon changes it."""
    pb = PackedBucket.from_numpy(vars(jax_bucket), "cpu")
    batched = run_bucket(pb)
    assert len(set(pb.horizon.tolist())) > 1  # horizons differ
    for b in range(pb.shape[0]):
        alone = run_bucket(_one_mapping(pb, b))
        for got, want in zip(alone, batched):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got[0], want[b])


def test_kernel_statics_are_the_kernels_inputs(jax_bucket):
    """``_kernel_statics`` gives every static ``sim_loop.STATICS`` names, in
    its dtype and shape, with float64 rounded as the eager loop's cast
    rounds it."""
    pb = PackedBucket.from_numpy(vars(jax_bucket), "cpu")
    B, N, K, M, S = pb.shape
    dims = dict(B=B, N=N, K=K, M=M, S=S)
    st = _kernel_statics(pb)
    assert list(st) == list(sim_loop.STATICS)
    for name, (dtype, letters) in sim_loop.STATICS.items():
        assert st[name].dtype is dtype, name
        assert tuple(st[name].shape) == tuple(dims[c] for c in letters), name
        assert st[name].is_contiguous()
        np.testing.assert_array_equal(st[name].numpy(), getattr(pb, name),
                                      err_msg=name)
    eager = _statics(pb)
    for name in ("leaf", "op_feed"):
        assert torch.equal(st[name].view(torch.int32),
                           eager[name].view(torch.int32))


def test_cuda_bucket_runs_one_sim_loop_launch(monkeypatch, jax_bucket):
    """On a CUDA bucket ``run_bucket`` calls ``sim_loop_cuda`` once with the
    bucket's statics and iterations, and reads the state it returns (the
    eager loop's layout); the eager loop and its ALU never run.  The
    kernel's part is played by the eager loop on the CPU."""
    pb = PackedBucket.from_numpy(vars(jax_bucket), "cpu")
    want = run_bucket_eager(pb)
    B, N = pb.shape[:2]
    I = pb.iterations
    calls = []

    def fake_kernel(statics, iterations):
        calls.append((sorted(statics), iterations))
        val = torch.zeros((B, N + 2, I))
        done = torch.zeros((B, N + 2, I), dtype=torch.bool)
        val[:, :N] = torch.from_numpy(want[0]).float()
        done[:, :N] = torch.from_numpy(want[1])
        return val, done, torch.from_numpy(want[2])

    def no_eager(*args, **kwargs):
        raise AssertionError("the eager loop ran on a CUDA bucket")

    monkeypatch.setattr(step, "sim_loop_cuda", fake_kernel)
    monkeypatch.setattr(step, "_cycle", no_eager)
    monkeypatch.setattr(step, "_kernel_statics",
                        lambda pb_: _kernel_statics(PackedBucket(
                            **{**vars(pb_), "device": torch.device("cpu")})))
    cuda_pb = PackedBucket(**{**vars(pb), "device": torch.device("cuda")})
    got = run_bucket(cuda_pb)
    assert calls == [(sorted(sim_loop.STATICS), I)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- verdicts ----------------------------------------------------------------


def test_corrupted_mappings_match_jax_verdicts(jax_mappings):
    batch = _corrupted(jax_mappings[0])
    ours = simulate_batch([_port(m) for m in batch], iterations=3,
                          device="cpu")
    theirs = jax_simulate_batch(batch, iterations=3, backend="jnp")
    for m, v, w in zip(batch, ours, theirs):
        assert (v.ok, v.reason) == (w.ok, w.reason)
        # the port's scalar oracle is the JAX one, reason for reason
        ok, values, reason = scalar_verdict(_port(m), iterations=3)
        assert (ok, reason) == jax_scalar_verdict(m, iterations=3)[::2]
        assert ok == v.ok
    assert ours[0].ok
    assert "not present at read time" in ours[1].reason
    assert "unknown node 99999" in ours[2].reason


def test_values_match_scalar_oracle(jax_mappings):
    ms = [_port(m) for m in jax_mappings]
    res = simulate_batch(ms, iterations=3, device="cpu")
    assert res.backend == "cpu" and res.n_buckets == 1
    for m, v in zip(ms, res):
        assert v.ok and v._values is None
        want = simulate(m, iterations=3)
        assert set(v.values) == set(want)
        got = np.array([v.values[k] for k in want])
        assert close_array(got, list(want.values()), F32_TOL).all()


def test_prepared_batch_warm_rerun_matches_cold(jax_mappings):
    ms = [_port(m) for m in jax_mappings] + [_port(_corrupted(
        jax_mappings[0])[1])]
    cold = simulate_batch(ms, iterations=3, device="cpu")
    pb = prepare_batch(ms, iterations=3, device="cpu")
    warm1 = simulate_batch(ms, iterations=3, device="cpu", prepared=pb)
    warm2 = simulate_batch(ms, iterations=3, device="cpu", prepared=pb)
    for c, w1, w2 in zip(cold, warm1, warm2):
        assert c.ok == w1.ok == w2.ok
        assert c.reason == w1.reason == w2.reason
        assert w1.values == w2.values == c.values
    with pytest.raises(ValueError, match="prepared batch"):
        simulate_batch(ms[:-1], iterations=3, device="cpu", prepared=pb)
    with pytest.raises(ValueError, match="prepared batch"):
        simulate_batch(ms, iterations=4, device="cpu", prepared=pb)


def test_verify_mappings_raises_on_disproof(jax_mappings):
    ms = [_port(m) for m in jax_mappings]
    values = verify_mappings(ms, iterations=3, device="cpu")
    assert len(values) == len(ms) and all(values)
    bad = _port(_corrupted(jax_mappings[0])[1])
    with pytest.raises(AssertionError, match=r"mapping\[1\]"):
        verify_mappings([ms[0], bad], iterations=3, device="cpu")


def test_negative_distance_goes_to_scalar_oracle(jax_mappings):
    mm = _port(jax_mappings[0])
    mm.dfg.edges[next(iter(mm.routes))].distance = -1
    res = simulate_batch([mm], iterations=3, device="cpu")
    assert res.n_scalar_fallback == 1 and res[0].backend == "scalar"


def test_default_device_is_cuda_and_never_falls_back(jax_mappings):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    ms = [_port(jax_mappings[0])]
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_batch(ms, iterations=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_batch(ms, iterations=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_mappings(ms, iterations=3)


# -- structural validation of stored mappings --------------------------------


def _verify_rows(main, argv):
    """``(rc, FAIL/OK/SKIP rows)`` of a package's ``verify`` CLI run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    rows = [ln for ln in buf.getvalue().splitlines()
            if ln[:6].strip() in ("OK", "FAIL", "SKIP")]
    return rc, rows


@pytest.mark.parametrize("kind", TAMPER_KINDS)
def test_validate_rejects_what_simulation_cannot_see(tmp_path, kind):
    """A stored mapping whose fault a simulation cannot see (a load on an
    ALU, two nodes on one FU in one modulo slot, a route ending on a
    resource the consumer cannot read, a capacity-1 resource holding two
    nets): the scalar oracle, the tensor loop and the numpy loop all
    accept the mapping, and ``verify`` FAILs it at the rebuild, with the
    JAX package's row, reason and exit code."""
    art = tampered(kind)
    bare = Mapping.from_record(art["mappings"][0])
    assert scalar_verdict(bare, iterations=3)[0]
    assert simulate_batch([bare], iterations=3, device="cpu")[0].ok
    assert simulate_batch([bare], iterations=3, backend="numpy")[0].ok
    path = write_json(str(tmp_path / f"{kind}.json"), art)
    want = _verify_rows(jax_cli_main, ["verify", path])
    got = _verify_rows(port_cli_main, ["verify", path, "--device", "cpu"])
    assert got == want
    rc, rows = got
    assert rc == 1 and len(rows) == 1
    assert rows[0].startswith("FAIL  atax_u2/plaid")
    assert "unloadable mapping (AssertionError: " in rows[0]
    if kind == "op":
        assert rows[0].endswith(
            "unloadable mapping (AssertionError: (5, 'load', 'alu'))")
    with pytest.raises(AssertionError):
        CompileResult.from_json(art).simulate(iterations=3, device="cpu")


def test_rebuilt_corpus_mappings_carry_their_fabric():
    art = CompileResult.from_json(corpus_json("atax_u2__spatial.json"))
    ms = art.rebuild_mappings()
    assert len(ms) > 1
    for m in ms:
        assert m.arch is make_arch("spatial4x4")
        m.validate()
    assert ms[0].cycles(5) == ms[0].ii * 4 + ms[0].makespan


# -- the numpy float64 backend -----------------------------------------------


@pytest.fixture(scope="module")
def corpus_pair():
    """The TABLE2 corpus's mappings, rebuilt by each package."""
    port, ref = [], []
    for fn in corpus_files():
        data = corpus_json(fn)
        if not data.get("mappings"):
            continue
        port += CompileResult.from_json(data).rebuild_mappings()
        ref += JaxCompileResult.from_json(data).rebuild_mappings()
    return port, ref


def test_numpy_backend_equals_the_jax_numpy_loop_bit_for_bit(corpus_pair):
    """On the TABLE2 corpus bucket the port's ``run_bucket_numpy`` gives
    the JAX package's ``val``/``done``/``fail`` bit for bit, and
    ``simulate_batch(backend="numpy")`` its verdicts, reasons and values
    exactly."""
    port, ref = corpus_pair
    pb = prepare_batch(port, iterations=3, backend="numpy").packed
    want_pb = jax_prepare_batch(ref, iterations=3).packed
    assert pb.device == torch.device("cpu")
    for f in step._FIELDS:
        np.testing.assert_array_equal(getattr(pb, f), getattr(want_pb, f))
    got, want = port_run_bucket_numpy(pb), jax_run_bucket_numpy(want_pb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    ours = simulate_batch(port, iterations=3, backend="numpy")
    theirs = jax_simulate_batch(ref, iterations=3, backend="numpy")
    assert ours.backend == "numpy" and ours.n_buckets == 1
    for v, w in zip(ours, theirs):
        assert (v.ok, v.reason, v.backend) == (w.ok, w.reason, w.backend)
        assert v.values == w.values


def test_numpy_backend_catches_the_corrupted_mappings(jax_mappings):
    batch = _corrupted(jax_mappings[0])
    ours = simulate_batch([_port(m) for m in batch], iterations=3,
                          backend="numpy")
    theirs = jax_simulate_batch(batch, iterations=3, backend="numpy")
    assert [(v.ok, v.reason) for v in ours] == \
        [(w.ok, w.reason) for w in theirs]
    assert not all(v.ok for v in ours)


def test_numpy_backend_runs_only_when_asked(monkeypatch, jax_mappings):
    """``numpy`` runs when a caller names it, and is judged under
    ``DEFAULT_TOL``; nothing resolves to it (or to the CPU) by default, a
    backend that disagrees with the device is refused, and the JAX
    package's ``REPRO_SIM_BACKEND`` changes nothing in the port, whichever
    of its values it holds."""
    assert tolerance_for("numpy") == DEFAULT_TOL
    assert tolerance_for("cuda") == tolerance_for("cpu") == F32_TOL
    for env in (None, "numpy", "jnp", "pallas", "auto"):
        if env is None:
            monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
        else:
            monkeypatch.setenv("REPRO_SIM_BACKEND", env)
        assert select_backend("numpy") == "numpy"
        assert select_backend("numpy", "cpu") == "numpy"
        assert select_backend(None, "cpu") == "cpu"
        assert select_backend("cpu", "cpu") == "cpu"
        for bad in ("jnp", "pallas", "auto"):
            with pytest.raises(ValueError, match="unknown sim backend"):
                select_backend(bad)
        with pytest.raises(ValueError, match="does not run on"):
            select_backend("numpy", "cuda")
        with pytest.raises(ValueError, match="does not run on"):
            select_backend("cuda", "cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                select_backend()
            with pytest.raises(RuntimeError, match="CUDA"):
                select_backend("cuda")
        res = simulate_batch([_port(jax_mappings[0])], iterations=3,
                             device="cpu")
        assert res.backend == "cpu" and res[0].backend == "cpu"


def test_verify_cli_backend_numpy(capsys):
    rc = port_cli_main(["verify", os.path.join(CORPUS, "atax_u2__plaid.json"),
                        "--backend", "numpy"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "batched[numpy]: 1 mappings" in out
    rc = port_cli_main(["verify", os.path.join(CORPUS, "atax_u2__plaid.json"),
                        "--backend", "numpy", "--device", "cuda"])
    captured = capsys.readouterr()
    assert rc == 2 and "does not run on cuda" in captured.err
    assert captured.out == ""


# -- energy_sweep ------------------------------------------------------------


def test_energy_sweep_rows_equal_the_jax_package(corpus_pair):
    """Every row's ``ii``, ``cycles``, ``verified``, ``power_uw``,
    ``area_um2`` and ``energy_uj`` equal the JAX package's, on the CPU's
    tensor loop and on the numpy backend; ``sim_backend`` names what ran.
    One row is a mapping with a dropped route (``verified: False``)."""
    port, ref = corpus_pair
    bad_ref = copy.deepcopy(ref[0])
    bad_ref.routes.pop(next(iter(bad_ref.routes)))
    bad_port = copy.deepcopy(port[0])
    bad_port.routes.pop(next(iter(bad_port.routes)))
    rows_port = [(m.arch.name, m, 10) for m in port + [bad_port]]
    rows_ref = [(m.arch.name, m, 10) for m in ref + [bad_ref]]
    want = jax_energy_sweep(rows_ref, backend="numpy")
    for kw, backend in ((dict(device="cpu"), "cpu"),
                        (dict(backend="numpy"), "numpy")):
        got = energy_sweep(rows_port, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["sim_backend"] == backend
            assert {k: v for k, v in g.items() if k != "sim_backend"} == \
                {k: v for k, v in w.items() if k != "sim_backend"}
        assert not got[-1]["verified"] and all(
            r["verified"] for r in got[:-1])
