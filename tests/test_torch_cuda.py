"""``repro_torch`` on the card: the CUDA ``sim_alu`` kernel against its
plain version; the whole cycle loop (``sim_loop``, one launch a bucket, its
state in shared memory or, for a bucket too large for it, in global
memory) against the CPU run and the eager loop on the card, bit for bit; the
language-model kernels (``rmsnorm``, ``fused_swiglu`` on each of its three
routes, misaligned bf16 included; ``flash_attention`` in float32 and in
bfloat16 on tensor cores, head dims up to 256: ``wgmma`` + TMA for d %
8 == 0 up to 160 in both forms (danube's 120 and stablelm's 160 too),
``mma.sync`` for the other head dims and misaligned views, a route the
call cannot take refused) against their
plain versions, on the caller's stream, and smoke-width
serving on ``cuda`` against the CPU run (one layer each of the MoE and
Mamba-1 families too, and the MoE dispatch route for route); the PCU
kernel ``motif_pcu``
against its plain version, bit for bit in float32, and the ``ops``
dispatchers through the kernels; the training kernels (``rmsnorm_bwd``
a row over 1, 2 or 4 warps and the loop kernel past them, by name,
``swiglu_gate_bwd``,
``flash_attention_bwd`` on each of its routes: ``wgmma`` + TMA in bf16
for d % 8 == 0 up to 160 (also 200 launches in a row where its
warpgroups skip leading tiles), ``mma.sync`` for the other bf16 head dims
up to 160 and misaligned views, SIMT past it and in float32, a route the
call
cannot take refused; and flash's training forward with its row
log-sum-exp and float32 output) against autograd of the plain versions,
twice bit for bit, each by name; a store round trip verified on
the card (one ``sim_loop`` launch a verifying get); and a compile verified
on the card (one ``sim_loop`` launch, the CPU compile's artifact).

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import CORPUS_DIR
from repro_torch.compiler.artifact import CompileResult
from repro_torch.kernels import ref
from repro_torch.kernels.sim_alu import sim_alu, sim_alu_cuda
from repro_torch.sim.batch import prepare_batch, simulate_batch
from repro_torch.kernels.sim_loop import sim_loop_cuda, state_in_shared
from repro_torch.sim.step import PackedBucket, run_bucket, run_bucket_eager
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels import _launch, ops
from repro_torch.kernels import fused_swiglu as fs
from repro_torch.kernels.fused_swiglu import fused_swiglu, fused_swiglu_cuda
from repro_torch.kernels.motif_pcu import (FANIN, FANOUT, MAX_SLOTS, UNICAST,
                                           motif_pcu, motif_pcu_cuda,
                                           random_schedule)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cuda
from repro_torch.models import moe, zoo
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

pytestmark = pytest.mark.cuda

#: tests/test_kernels.py's tolerances
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-1)}
#: chip_smoke.py's tolerance of the card against the CPU, float32 logits
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _mappings():
    out = []
    for fn in ("atax_u2__plaid.json", "dwconv_u1__plaid.json",
               "jacobi_u1__plaid.json", "atax_u2__spatial.json"):
        art = CompileResult.load(f"{CORPUS_DIR}/{fn}")
        out += art.rebuild_mappings()
    return out


@pytest.mark.parametrize("shape", [(1, 1), (7, 129), (300, 1000)])
def test_sim_alu_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    opcode = torch.from_numpy(
        rng.integers(-1, 21, shape).astype(np.int32)).to(cuda)
    a, b, c, leaf = (torch.from_numpy(
        rng.integers(-2 ** 15, 2 ** 15 + 1, shape).astype(np.float32)
    ).to(cuda) for _ in range(4))
    before = sim_alu_cuda.launches
    got = sim_alu(opcode, a, b, c, leaf)
    torch.cuda.synchronize()
    assert sim_alu_cuda.launches == before + 1
    want = ref.sim_alu(opcode, a, b, c, leaf)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sim_alu_kernel_rejects_bad_operands(cuda):
    x = torch.zeros(4, 4, device=cuda)
    op = torch.zeros(4, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        sim_alu_cuda(op.float(), x, x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        sim_alu_cuda(op.t(), x.t(), x.t(), x.t(), x.t())


def test_cycle_loop_on_card_equals_cpu(cuda):
    ms = _mappings()
    dev = run_bucket(prepare_batch(ms, iterations=3, device=cuda).packed)
    cpu = run_bucket(prepare_batch(ms, iterations=3, device="cpu").packed)
    for x, y in zip(dev, cpu):
        np.testing.assert_array_equal(x, y)


def test_verdicts_on_card_equal_cpu(cuda):
    ms = _mappings()
    bad = copy.deepcopy(ms[0])
    bad.routes.pop(next(iter(bad.routes)))
    ms.append(bad)
    on_card = simulate_batch(ms, iterations=3, device=cuda)
    on_cpu = simulate_batch(ms, iterations=3, device="cpu")
    assert on_card.backend == "cuda"
    assert [(v.ok, v.reason) for v in on_card] == \
        [(v.ok, v.reason) for v in on_cpu]
    assert not on_card[-1].ok and all(v.ok for v in on_card[:-1])


def test_store_round_trip_verified_on_the_card(cuda, tmp_path, monkeypatch):
    """atax's artifacts and the step-0 tampered copy, put into a store and
    read back twice under ``verify="always"`` on the card: one
    ``sim_loop`` launch per verifying get that reaches the simulator (the
    tampered one fails ``validate()`` first), no ``sim_alu`` launch, and
    the same artifacts, counters and values as a CPU store's."""
    from repro_torch.compiler.store import ArtifactStore, key_for
    from _torch_artifacts import corpus_files, tampered

    values = {"cuda": [], "cpu": []}
    simulate = CompileResult.simulate

    def recorded(self, iterations=3, device=None, backend=None):
        out = simulate(self, iterations, device, backend)
        values[torch.device(device).type].append(out)
        return out

    monkeypatch.setattr(CompileResult, "simulate", recorded)
    arts = [CompileResult.load(f"{CORPUS_DIR}/{fn}")
            for fn in corpus_files() if fn.startswith("atax_")]
    arts.append(CompileResult.from_json({**tampered("op"), "seed": 1,
                                         "verified": None}))
    served, counters = {}, {}
    for dev in ("cuda", "cpu"):
        store = ArtifactStore(str(tmp_path / dev), verify="always",
                              device=dev)
        keys = [key_for(a) for a in arts]
        for a, k in zip(arts, keys):
            store.put(a, key=k)
        sim_loop_cuda.launches = sim_alu_cuda.launches = 0
        served[dev] = [None if r is None else r.to_json()
                       for r in (store.get(k) for k in keys + keys)]
        counters[dev] = store.counters.to_json()
        if dev == "cuda":
            runs = store.counters.verify_runs
            assert runs > len(arts)
            assert sim_loop_cuda.launches == runs - 1
            assert sim_alu_cuda.launches == 0
    assert served["cuda"] == served["cpu"]
    assert counters["cuda"] == counters["cpu"]
    assert counters["cuda"]["verify_failures"] == 1
    assert values["cuda"] == values["cpu"]


def test_compile_verifies_on_the_card(cuda, monkeypatch):
    """``compile("atax", unroll=2, verify=True, device="cuda")``: one
    ``sim_loop`` launch and nothing else, no scalar oracle, and the
    artifact of the same compile on the CPU but for wall time."""
    import repro_torch.core.simulate as scalar
    from repro_torch.compiler.pipeline import compile as port_compile

    from _torch_artifacts import fields

    def no_oracle(*a, **k):
        raise AssertionError("the compile path reached the scalar oracle")

    monkeypatch.setattr(scalar, "simulate", no_oracle)
    monkeypatch.delenv("REPRO_QUICK", raising=False)
    cpu = port_compile("atax", unroll=2, verify=True, device="cpu")
    sim_loop_cuda.launches = sim_alu_cuda.launches = 0
    card = port_compile("atax", unroll=2, verify=True, device="cuda")
    assert (sim_loop_cuda.launches, sim_alu_cuda.launches) == (1, 0)
    assert card.verified is True
    assert fields(card) == fields(cpu)


def _corpus_and_corrupted():
    """Every mapping of the TABLE2 corpus, then corrupted copies of four:
    a dropped route, a node placed on no real site, a node issued a cycle
    late."""
    from repro_torch.compiler.cli import _gather_artifacts

    ms = [m for _, art in _gather_artifacts([CORPUS_DIR]) if art.mappings
          for m in art.rebuild_mappings()]
    bad = []
    for m in [m for m in ms if m.routes][:4]:
        dropped = copy.deepcopy(m)
        dropped.routes.pop(next(iter(dropped.routes)))
        foreign = copy.deepcopy(m)
        foreign.place[99999] = 0
        shifted = copy.deepcopy(m)
        shifted.time[next(iter(shifted.time))] += 1
        bad += [dropped, foreign, shifted]
    return ms + bad


def _assert_loops_equal(pb_cuda, pb_cpu):
    """The fused loop (one launch) equals the CPU run, the eager loop on
    the card (hmax sim_alu launches) and a second fused run, bit for bit."""
    before = (sim_loop_cuda.launches, sim_alu_cuda.launches)
    fused = run_bucket(pb_cuda)
    assert (sim_loop_cuda.launches, sim_alu_cuda.launches) == \
        (before[0] + 1, before[1])
    eager = run_bucket_eager(pb_cuda)
    assert sim_alu_cuda.launches == before[1] + pb_cuda.hmax
    for other in (run_bucket(pb_cpu), eager, run_bucket(pb_cuda)):
        for x, y in zip(fused, other):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    return fused


def test_fused_loop_equals_cpu_and_eager_on_the_corpus(cuda):
    ms = _corpus_and_corrupted()
    pb = prepare_batch(ms, iterations=3, device=cuda).packed
    _, N, _, _, S = pb.shape
    assert state_in_shared(N, S, pb.iterations, torch.cuda.current_device())
    fused = _assert_loops_equal(
        pb, prepare_batch(ms, iterations=3, device="cpu").packed)
    assert fused[2].any() and fused[1].any()  # failures and values both


def _padded(pb, n_nodes: int):
    """``pb`` with its node rows padded to ``n_nodes`` by nodes that never
    execute (the sentinel row moves to ``n_nodes``)."""
    B, N, K, M, S = pb.shape
    pad = n_nodes - N
    fields = {}
    for f in ("opcode", "exec_mask", "issue", "compare", "leaf", "ref",
              "op_kind", "op_src", "op_dist", "op_feed", "op_steps"):
        a = getattr(pb, f)
        fill = {"op_src": n_nodes, "op_steps": S}.get(f, 0)
        extra = np.full((B, pad) + a.shape[2:], fill, dtype=a.dtype)
        if f == "op_src":
            a = np.where(a == N, n_nodes, a)
        fields[f] = np.concatenate([a, extra], axis=1)
    step_src = np.where(pb.step_src == N, n_nodes, pb.step_src)
    return PackedBucket(iterations=pb.iterations, hmax=pb.hmax, ii=pb.ii,
                        horizon=pb.horizon, step_src=step_src,
                        step_abs=pb.step_abs, device=pb.device, **fields)


def test_fused_loop_keeps_a_large_state_in_global_memory(cuda):
    """A bucket whose state per mapping ((N + 2) I 5 + (S + 2) I bytes,
    plus 8 N staged) exceeds the card's opt-in shared memory runs the
    global-memory variant, with the same state as the CPU and the eager
    loop."""
    ms = _mappings()
    bad = copy.deepcopy(ms[0])
    bad.routes.pop(next(iter(bad.routes)))
    ms.append(bad)
    N = 16384
    big = [_padded(prepare_batch(ms, iterations=3, device=d).packed, N)
           for d in (cuda, "cpu")]
    _, _, _, _, S = big[0].shape
    I = big[0].iterations
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert (N + 2) * I * 5 + (S + 2) * I + 8 * N > optin
    assert not state_in_shared(N, S, I, torch.cuda.current_device())
    fused = _assert_loops_equal(*big)
    assert fused[2][-1] and not fused[2][:-1].any()


@pytest.fixture(autouse=True)
def _full_float32_matmul():
    """The plain versions' float32 products in full float32, not TF32."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _randn(shape, dtype, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _assert_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(128, 64), (64, 160), (100, 3072),
                                 (4, 3072)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, M, D):
    x, s = _randn((M, D), dtype, cuda, 0), _randn((D,), dtype, cuda, 1)
    before = rmsnorm_cuda.launches
    got = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, D)
    _assert_close(got, ref.rmsnorm(x, s), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(128, 128, 128), (256, 384, 128),
                                   (100, 72, 136), (4, 256, 320)])
def test_fused_swiglu_kernel_matches_plain(cuda, dtype, M, D, F):
    x = _randn((M, D), dtype, cuda, 0)
    w1, w3 = _randn((D, F), dtype, cuda, 1), _randn((D, F), dtype, cuda, 2)
    before = fused_swiglu_cuda.launches
    got = fused_swiglu(x, w1, w3)
    torch.cuda.synchronize()
    assert fused_swiglu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, F)
    _assert_close(got, ref.fused_swiglu(x, w1, w3), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [130, 136, 320, 520])
@pytest.mark.parametrize("D", [72, 256, 1000])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 100, 129, 300])
def test_fused_swiglu_routes_match_plain(cuda, M, D, F, dtype):
    """Every route at ragged shapes: the stream route on both sides of its
    row groups (1, 4, 16) with F = 130's scalar tail, the tensor-core
    route across 128-row and 128-column tiles and 64-deep K steps (D = 72,
    1000), the SIMT route for float32 past 16 rows and bf16 at F = 130."""
    x = _randn((M, D), dtype, cuda, M + D)
    w1, w3 = (_randn((D, F), dtype, cuda, F + i) for i in (1, 2))
    want_route = (fs.STREAM if M <= 16 else
                  fs.TENSOR_CORES if dtype == torch.bfloat16 and F != 130
                  else fs.SIMT)
    assert fs.route(M, D, F, dtype) == want_route
    before = fused_swiglu_cuda.launches
    got = fused_swiglu(x, w1, w3)
    torch.cuda.synchronize()
    assert fused_swiglu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, F)
    _assert_close(got, ref.fused_swiglu(x, w1, w3), dtype)


def test_fused_swiglu_tensor_cores_one_tile(cuda):
    """One 128 x 128 tile over one 64-deep stage: the wgmma descriptors and
    the TMA swizzle on their own."""
    x = _randn((128, 64), torch.bfloat16, cuda, 0)
    w1, w3 = (_randn((64, 128), torch.bfloat16, cuda, i) for i in (1, 2))
    assert fs.route(128, 64, 128, torch.bfloat16) == fs.TENSOR_CORES
    _assert_close(fused_swiglu_cuda(x, w1, w3), ref.fused_swiglu(x, w1, w3),
                  torch.bfloat16)


@pytest.mark.parametrize("M,want_route", [(2000, fs.TENSOR_CORES),
                                          (4, fs.STREAM)])
def test_fused_swiglu_serve_shapes_within_one_ulp(cuda, M, want_route):
    """The serve path's shapes, bf16, weights at 1/sqrt(D): the routes sum
    in another order than the plain version, nothing more, so they agree
    within one bf16 ulp (chip_smoke.py's PATH_TOL)."""
    x = _randn((M, 3072), torch.bfloat16, cuda, 3)
    w1, w3 = (_randn((3072, 8192), torch.bfloat16, cuda, i) * 3072 ** -0.5
              for i in (4, 5))
    assert fs.route(M, 3072, 8192, torch.bfloat16) == want_route
    torch.testing.assert_close(fused_swiglu_cuda(x, w1, w3).float(),
                               ref.fused_swiglu(x, w1, w3).float(),
                               rtol=1e-2, atol=5e-3)


@pytest.mark.parametrize("M,D,F,dtype,route", [
    (4, 64, 128, torch.float32, fs.TENSOR_CORES),    # float32
    (32, 64, 130, torch.bfloat16, fs.TENSOR_CORES),  # F % 8
    (32, 70, 128, torch.bfloat16, fs.TENSOR_CORES),  # D % 8
    (17, 64, 128, torch.bfloat16, fs.STREAM),        # more than 16 rows
    (4, 64, 128, torch.bfloat16, 3),                 # no such route
])
def test_fused_swiglu_entry_refuses_a_route_the_shape_cannot_take(
        cuda, M, D, F, dtype, route):
    x = torch.zeros((M, D), dtype=dtype, device=cuda)
    w = torch.zeros((D, F), dtype=dtype, device=cuda)
    out = torch.empty((M, F), dtype=dtype, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        _launch.launch("fused_swiglu", fs._ARGS, x.get_device(),
                       x.data_ptr(), w.data_ptr(), w.data_ptr(),
                       out.data_ptr(), M, D, F,
                       _launch.DTYPE_CODES[dtype], route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=64),
                                dict(causal=False)],
                         ids=["causal", "window64", "full"])
@pytest.mark.parametrize("H,S,d,g", [(2, 128, 64, 1), (1, 256, 32, 1),
                                     (6, 100, 128, 3)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, kw, H, S, d, g):
    q = _randn((H, S, d), dtype, cuda, 0)
    k, v = (_randn((H // g, S, d), dtype, cuda, i) for i in (1, 2))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, kv_group=g, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (H, S, d)
    _assert_close(got, ref.flash_attention(q, k, v, kv_group=g, **kw), dtype)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=64),
                                dict(causal=False)],
                         ids=["causal", "window64", "full"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 500])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_attention_tensor_cores_match_plain(cuda, d, S, g, kw):
    """The bf16 kernel on tensor cores: every padded head dim (80 runs in
    128 columns), one row, ragged and exact tiles, grouped kv heads."""
    H = 2 * g
    q = _randn((H, S, d), torch.bfloat16, cuda, d + S)
    k, v = (_randn((H // g, S, d), torch.bfloat16, cuda, d + S + i)
            for i in (1, 2))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, kv_group=g, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (H, S, d)
    _assert_close(got, ref.flash_attention(q, k, v, kv_group=g, **kw),
                  torch.bfloat16)


def _kernel_names(fn):
    """The names of the CUDA kernels a call of ``fn()`` launches
    (``torch.profiler``; called up to three times, since a trace can come
    back empty).  The profiler can drop the first kernels of a window, so
    each trace waits 50 ms on the host once it has started and opens with
    eight short spin kernels (left out of the names), as ``chip_smoke``'s
    ``device_ms`` does."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(8):
                torch.cuda._sleep(200_000)
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.key}
        if names:
            return names
    raise AssertionError("three traces without a kernel")


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 160, "flash_fwd_wgmma_kernel<160, false>"),
    (torch.bfloat16, 192, "flash_attention_tc_kernel<256>"),
    (torch.bfloat16, 256, "flash_attention_tc_kernel<256>"),
    (torch.float32, 160, "flash_attention_kernel<float, 16>"),
    (torch.float32, 192, "flash_attention_kernel<float, 16>"),
    (torch.float32, 256, "flash_attention_kernel<float, 16>"),
])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=64),
                                dict(causal=False)],
                         ids=["causal", "window64", "full"])
@pytest.mark.parametrize("S,g", [(100, 1), (500, 4)])
def test_flash_attention_head_dims_to_256(cuda, dtype, d, kernel, kw, S, g):
    """Head dims past 128: bf16 at stablelm_12b's 160 on wgmma + TMA, at
    192 (padded to 256) and 256 on the mma.sync kernel at its padded width
    (serving's instantiation, ``<DP, false>``; the training form is ``<DP,
    true>``), float32 on the SIMT kernel with 16 output columns a thread,
    each asserted by the kernel's name."""
    H = 2 * g
    q = _randn((H, S, d), dtype, cuda, d + S)
    k, v = (_randn((H // g, S, d), dtype, cuda, d + S + i) for i in (1, 2))
    call = lambda: flash_attention(q, k, v, kv_group=g, **kw)  # noqa: E731
    before = flash_attention_cuda.launches
    got = call()
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    names = _kernel_names(call)
    if "tc_kernel" in kernel:
        kernel = kernel.replace(">", ", false>")
    assert any(kernel in n for n in names), names
    assert got.dtype == dtype and got.shape == (H, S, d)
    _assert_close(got, ref.flash_attention(q, k, v, kv_group=g, **kw), dtype)


def test_flash_attention_refuses_head_dims_past_256(cuda):
    q = torch.zeros(2, 8, 257, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims up to 256"):
        flash_attention_cuda(q, q, q)


def _offset_view(shape, seed, device, scale=1.0):
    """Contiguous bf16 values one element into their storage: the data
    pointer is 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    t = torch.empty(n + 1, dtype=torch.bfloat16, device=device)[1:]
    t = t.view(shape)
    t.copy_(_randn(shape, torch.bfloat16, device, seed) * scale)
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("offset", ["x", "w1", "w3", "all"])
@pytest.mark.parametrize("M,D,F", [(300, 1024, 520), (2000, 3072, 8192)])
def test_fused_swiglu_misaligned_bf16_takes_simt(cuda, M, D, F, offset):
    """bf16 operands at an odd element offset, at shapes the tensor-core
    route takes when aligned: the SIMT route computes them (the C entry
    would refuse them on tensor cores), one launch, under ``TOL``."""
    assert fs.route(M, D, F, torch.bfloat16) == fs.TENSOR_CORES
    assert fs.route(M, D, F, torch.bfloat16, aligned=False) == fs.SIMT
    shapes = {"x": (M, D), "w1": (D, F), "w3": (D, F)}
    ts = {name: (_offset_view(shape, i, cuda, D ** -0.5 if i else 1.0)
                 if offset in (name, "all") else
                 _randn(shape, torch.bfloat16, cuda, i)
                 * (D ** -0.5 if i else 1.0))
          for i, (name, shape) in enumerate(shapes.items())}
    call = lambda: fused_swiglu(ts["x"], ts["w1"], ts["w3"])  # noqa: E731
    before = fused_swiglu_cuda.launches
    got = call()
    torch.cuda.synchronize()
    assert fused_swiglu_cuda.launches == before + 1
    names = _kernel_names(call)
    assert any("fused_swiglu_kernel<" in n for n in names), names
    assert got.dtype == torch.bfloat16 and got.shape == (M, F)
    _assert_close(got, ref.fused_swiglu(ts["x"], ts["w1"], ts["w3"]),
                  torch.bfloat16)


def test_kernels_run_on_the_callers_stream(cuda):
    """Launched under ``torch.cuda.stream(s)``, a kernel queues behind a
    long op on ``s``: it reads inputs that ``s`` writes only after a spin
    of the device, so on any other stream it would see zeros."""
    s = torch.cuda.Stream()
    x_new, scale = _randn((64, 3072), torch.bfloat16, cuda, 0), \
        _randn((3072,), torch.bfloat16, cuda, 1)
    q_new = _randn((6, 200, 128), torch.bfloat16, cuda, 2)
    kv = _randn((2, 200, 128), torch.bfloat16, cuda, 3)
    x, q = torch.zeros_like(x_new), torch.zeros_like(q_new)
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)  # a spin of ~0.1 s on s
        x.copy_(x_new)
        q.copy_(q_new)
        got_x = rmsnorm_cuda(x, scale)
        got_q = flash_attention_cuda(q, kv, kv, kv_group=3)
    s.synchronize()
    _assert_close(got_x, ref.rmsnorm(x_new, scale), torch.bfloat16)
    _assert_close(got_q, ref.flash_attention(q_new, kv, kv, kv_group=3),
                  torch.bfloat16)
    assert got_x.float().abs().max() > 0.5


def test_lm_kernels_reject_bad_operands(cuda):
    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm_cuda(x.half(), torch.ones(8, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x.t()[:, :4], torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        fused_swiglu_cuda(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="contiguous"):
        fused_swiglu_cuda(x, x.t(), x)
    q = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.double(), q.double(), q.double())


def test_smoke_generate_on_card_equals_cpu(cuda):
    """Two layers at smoke width, float32: the same weights and prompts give
    the same greedy tokens through the kernels on the card as through the
    plain versions on the CPU."""
    cfg = smoke_config("llama3_2_3b").replace(n_layers=2)
    cpu_model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    before = (rmsnorm_cuda.launches, fused_swiglu_cuda.launches,
              flash_attention_cuda.launches)
    on_card, info = generate(cfg, card_model, prompts.to(cuda),
                             max_new_tokens=6)
    after = (rmsnorm_cuda.launches, fused_swiglu_cuda.launches,
             flash_attention_cuda.launches)
    on_cpu, _ = generate(cfg, cpu_model, prompts, max_new_tokens=6)
    assert info["logits_finite"] and info["cache_length"] == 16 + 5
    np.testing.assert_array_equal(on_card.cpu().numpy(), on_cpu.numpy())
    # per pass: ln1 + ln2 per layer and ln_f; one MLP per layer; attention
    # through flash_attention in the prefill only
    assert [a - b for a, b in zip(after, before)] == [5 * 6, 2 * 6, 2]


@pytest.mark.parametrize("E,K", [(4, 2), (32, 8)])
def test_moe_route_on_card_equals_cpu(cuda, E, K):
    """The MoE dispatch on identical gates, ties and drops included: the
    experts, slots and kept routes equal the CPU's exactly."""
    g = torch.softmax(_randn((512, E), torch.float32, "cpu", E), dim=-1)
    g[:8] = 1.0 / E  # all-equal rows: ties at every place
    C = 512 * K // E // 2  # half the mean load: routes drop
    got = moe.route(g.to(cuda), K, C)
    want = moe.route(g, K, C)
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x.cpu(), y)
    assert got[1][:8].tolist() == [list(range(K))] * 8
    assert not bool(want[2].all())
    torch.testing.assert_close(got[0].cpu(), want[0], **PARITY_TOL)


def _one_layer_on_card_and_cpu(cuda, arch):
    cfg = smoke_config(arch).replace(n_layers=1)
    cpu_model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    return cfg, cpu_model, copy.deepcopy(cpu_model).to(cuda)


@pytest.mark.parametrize("arch,swiglu", [("granite_moe_1b_a400m", 0),
                                         ("arctic_480b", 1)])
def test_moe_layer_on_card_equals_cpu(cuda, arch, swiglu):
    """One MoE layer at smoke width, float32: prefill logits and kv cache
    and two decode steps on the card against the CPU under ``PARITY_TOL``,
    with the kernels' launches counted (ln1, ln2, ln_f a pass; flash in
    the prefill; fused_swiglu only on arctic's dense branch)."""
    cfg, cpu_model, card_model = _one_layer_on_card_and_cpu(cuda, arch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    counters = (rmsnorm_cuda, fused_swiglu_cuda, flash_attention_cuda)
    before = [c.launches for c in counters]
    out = {}
    with torch.inference_mode():
        for name, model, dev in (("card", card_model, cuda),
                                 ("cpu", cpu_model, "cpu")):
            cache, logits = model.prefill({"tokens": toks[:, :16].to(dev)})
            cache = grow_cache(cache, 2)
            steps = [logits]
            for i in range(2):
                cache, logits = model.decode_step(
                    cache, toks[:, 16 + i:17 + i].to(dev))
                steps.append(logits)
            out[name] = (torch.cat(steps, dim=1).cpu(), cache["k"].cpu())
            if name == "card":
                torch.cuda.synchronize()
                after = [c.launches for c in counters]
    assert [a - b for a, b in zip(after, before)] == [3 * 3, swiglu * 3, 1]
    for x, y in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(x, y, **PARITY_TOL)


def test_mamba1_layer_on_card_equals_cpu(cuda):
    """One Mamba-1 layer at smoke width, float32, over two chunks: prefill
    logits and state cache and two decode steps on the card against the
    CPU under ``PARITY_TOL``; the layer norm and ln_f through rmsnorm, no
    flash."""
    cfg, cpu_model, card_model = _one_layer_on_card_and_cpu(
        cuda, "falcon_mamba_7b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 34)).astype(np.int32))
    before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
    out = {}
    with torch.inference_mode():
        for name, model, dev in (("card", card_model, cuda),
                                 ("cpu", cpu_model, "cpu")):
            cache, logits = model.prefill({"tokens": toks[:, :32].to(dev)})
            steps = [logits]
            for i in range(2):
                cache, logits = model.decode_step(
                    cache, toks[:, 32 + i:33 + i].to(dev))
                steps.append(logits)
            out[name] = [torch.cat(steps, dim=1)] + [
                cache[k] for k in ("conv", "h", "length")]
            if name == "card":
                torch.cuda.synchronize()
                after = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (2 * 3, 0)
    for x, y in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(x.cpu(), y, **PARITY_TOL)


def _card_and_cpu_serve(cuda, cfg, T: int, extra=None):
    """Prefill of ``T`` tokens and two decode steps of the smoke model at
    ``cfg`` in float32, on the card and on the CPU from the same weights:
    (card logits and cache, CPU logits and cache, the kernels' launches on
    the card)."""
    cpu_model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, T + 2)).astype(np.int32))
    counters = (rmsnorm_cuda, fused_swiglu_cuda, flash_attention_cuda)
    out = {}
    with torch.inference_mode():
        for name, model, dev in (("card", card_model, cuda),
                                 ("cpu", cpu_model, "cpu")):
            batch = {"tokens": toks[:, :T].to(dev)}
            batch.update({k: v.to(dev) for k, v in (extra or {}).items()})
            before = [c.launches for c in counters]
            cache, logits = model.prefill(batch)
            cache = grow_cache(cache, 2)
            steps = [logits]
            for i in range(2):
                cache, logits = model.decode_step(
                    cache, toks[:, T + i:T + i + 1].to(dev))
                steps.append(logits)
            if name == "card":
                torch.cuda.synchronize()
                launches = [c.launches - b for c, b in zip(counters, before)]
            out[name] = [torch.cat(steps, dim=1).cpu()] + [
                cache[k].cpu() for k in sorted(cache)]
    return out["card"], out["cpu"], launches


def test_hybrid_on_card_equals_cpu(cuda):
    """zamba2's smoke config at 3 layers (one group of 2 and a tail layer),
    float32, a 32-token prompt over two SSD chunks: prefill logits, every
    cache entry and two decode steps on the card against the CPU under
    ``PARITY_TOL``; per pass ln + gated norm a Mamba-2 layer, ln1 + ln2 at
    the shared site and ln_f through rmsnorm, the site's MLP through
    fused_swiglu, its attention through flash in the prefill."""
    cfg = smoke_config("zamba2_1_2b").replace(n_layers=3)
    card, cpu, launches = _card_and_cpu_serve(cuda, cfg, 32)
    assert launches == [(2 * 3 + 2 + 1) * 3, 3, 1]
    for x, y in zip(card, cpu):
        torch.testing.assert_close(x, y, **PARITY_TOL)


def test_encdec_on_card_equals_cpu(cuda):
    """whisper's smoke config (2 + 2 layers, 16 audio frames), float32:
    prefill logits, every cache entry (the static encoder k/v included)
    and two decode steps on the card against the CPU under
    ``PARITY_TOL``; rmsnorm 2 an encoder layer and ``ln_enc`` once, 3 a
    decoder layer and ln_f a pass; fused_swiglu an encoder layer once and a
    decoder layer a pass; flash only for the decoder's causal prefill."""
    cfg = smoke_config("whisper_tiny")
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    card, cpu, launches = _card_and_cpu_serve(cuda, cfg, 16,
                                              {"audio_embeds": audio})
    assert launches == [2 * 2 + 1 + (3 * 2 + 1) * 3, 2 + 2 * 3, 2]
    for x, y in zip(card, cpu):
        torch.testing.assert_close(x, y, **PARITY_TOL)


MOTIF_SCHEDULES = {"fanin": FANIN, "fanout": FANOUT, "unicast": UNICAST,
                   **{f"random{s}": random_schedule(s) for s in range(3)}}


def _motif_inputs(shape, seed, device):
    """Uniform in [-100, 100], the range ``random_schedule`` is drawn for."""
    x = np.random.default_rng(seed).uniform(-100, 100, shape).astype(
        np.float32)
    return torch.from_numpy(x).to(device)


def _bits_equal(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", MOTIF_SCHEDULES)
@pytest.mark.parametrize("N", [1, 1000, 4099])
def test_motif_pcu_kernel_bitwise_equals_plain(cuda, name, N):
    sched = MOTIF_SCHEDULES[name]
    x = _motif_inputs((3, N), N, cuda)
    if not name.startswith("random"):
        # the canonical schedules use add, sub, mul and max only: their
        # first columns take every mix of NaN, +-inf, +-0 and 1
        special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                0.0, -0.0, 1.0], device=cuda)
        grid = torch.cartesian_prod(special, special, special).T[:, :N]
        x[:, :grid.shape[1]] = grid
    before = motif_pcu_cuda.launches
    got = motif_pcu(sched, 3, x)
    torch.cuda.synchronize()
    assert motif_pcu_cuda.launches == before + 1
    assert got.shape == (3 + len(sched), N) and got.dtype == torch.float32
    assert _bits_equal(got, ref.motif_pcu(sched, 3, x))


@pytest.mark.parametrize("name", ["fanin", "fanout", "unicast"])
def test_motif_pcu_kernel_bfloat16_within_one_ulp(cuda, name):
    sched = MOTIF_SCHEDULES[name]
    x = _randn((3, 2048), torch.bfloat16, cuda, 3)
    got = motif_pcu(sched, 3, x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.motif_pcu(sched, 3, x).float(),
                               rtol=1e-2, atol=5e-3)


def test_motif_pcu_kernel_at_the_largest_table(cuda):
    """MAX_SLOTS slots (over 48 KB of shared memory) launch; one more is
    refused before the launch."""
    sched = random_schedule(7, steps=MAX_SLOTS - 3)
    x = _motif_inputs((3, 777), 7, cuda)
    assert _bits_equal(motif_pcu_cuda(sched, 3, x), ref.motif_pcu(sched, 3, x))
    longer = sched + ((MAX_SLOTS, "add", 0, 1),)
    with pytest.raises(ValueError, match="exceed"):
        motif_pcu_cuda(longer, 3, x)


def test_motif_pcu_kernel_rejects_bad_operands(cuda):
    x = torch.zeros(3, 8, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        motif_pcu_cuda(FANIN, 3, x.cpu())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        motif_pcu_cuda(FANIN, 3, x.int())
    with pytest.raises(ValueError, match="contiguous"):
        motif_pcu_cuda(FANIN, 3, torch.zeros(8, 3, device=cuda).t())
    with pytest.raises(ValueError, match="a, b < dst"):
        motif_pcu_cuda(((3, "add", 3, 0),), 3, x)


def test_ops_dispatch_to_the_kernels(cuda):
    """``repro_torch.kernels.ops`` on CUDA tensors at ``benchmarks/run.py``'s
    shapes: one launch of each kernel, equal to the plain versions."""
    x = _randn((128, 256), torch.float32, cuda, 0)
    w1, w3 = (_randn((256, 128), torch.float32, cuda, i) for i in (1, 2))
    s = _randn((256,), torch.float32, cuda, 3)
    q = _randn((2, 128, 64), torch.float32, cuda, 4)
    m = _randn((3, 1024), torch.float32, cuda, 5)
    counters = (fused_swiglu_cuda, rmsnorm_cuda, flash_attention_cuda,
                motif_pcu_cuda)
    before = [c.launches for c in counters]
    got = (ops.fused_swiglu(x, w1, w3), ops.rmsnorm(x, s),
           ops.flash_attention(q, q, q, block_q=64, block_k=64),
           ops.motif_pcu(m, schedule=FANIN, n_inputs=3))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    want = (ref.fused_swiglu(x, w1, w3), ref.rmsnorm(x, s),
            ref.flash_attention(q, q, q), ref.motif_pcu(FANIN, 3, m))
    for g, w in zip(got[:3], want[:3]):
        _assert_close(g, w, torch.float32)
    assert _bits_equal(got[3], want[3])


# ---------------------------------------------------------------------------
# Training: the backward kernels and the forward's row log-sum-exp
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
from repro_torch.kernels.fused_swiglu import swiglu_gate_bwd_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

FLASH_KW = [dict(causal=True), dict(causal=True, window=64),
            dict(causal=False)]
FLASH_KW_IDS = ["causal", "window64", "full"]


def _plain_grads(fn, inputs, grad_out):
    """Autograd of the plain version ``fn(*inputs)`` against ``grad_out``:
    one gradient per input, in the input's dtype."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(128, 64), (64, 160), (100, 3072),
                                 (300, 512), (1, 200), (5000, 3072),
                                 (64, 5120), (33, 3080), (40, 1544),
                                 (7, 33)])
def test_rmsnorm_backward_matches_plain(cuda, dtype, M, D):
    """The register path (rows up to 3072 bf16 or 1536 float32 wide, a
    multiple of the 16-byte vector; 5000 rows walk more than one row a
    warp) and the loop over the row past it (5120, 3080 and 1544 in
    float32, 33)."""
    x, s = _randn((M, D), dtype, cuda, 0), _randn((D,), dtype, cuda, 1)
    dy = _randn((M, D), dtype, cuda, 2)
    before = rmsnorm_bwd_cuda.launches
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches == before + 1
    want_dx, want_ds = _plain_grads(ref.rmsnorm, (x, s), dy)
    assert dx.dtype == dtype and ds.dtype == dtype
    _assert_close(dx, want_dx, dtype)
    _assert_close(ds, want_ds, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gradient_runs_the_backward_kernel(cuda, dtype):
    """``rmsnorm`` on a CUDA tensor that wants a gradient goes through
    ``RMSNormFn``: one forward and one backward launch."""
    x = _randn((64, 256), dtype, cuda, 3).requires_grad_(True)
    s = _randn((256,), dtype, cuda, 4).requires_grad_(True)
    f0, b0 = rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches
    y = rmsnorm(x, s)
    dy = _randn((64, 256), dtype, cuda, 5)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches) == \
        (f0 + 1, b0 + 1)
    want_dx, want_ds = _plain_grads(ref.rmsnorm, (x, s), dy)
    _assert_close(x.grad, want_dx, dtype)
    _assert_close(s.grad, want_ds, dtype)


def _gate(a, b):
    return (torch.nn.functional.silu(a.float()) * b.float()).to(a.dtype)


def _flat_offset(n, dtype, device, seed):
    """n values one element into their storage (misaligned for 16-byte
    vectors)."""
    base = _randn((n + 1,), dtype, device, seed)
    return base[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 33), (128, 256), (300, 520), (1, 1)])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_swiglu_gate_backward_matches_plain(cuda, dtype, shape, aligned):
    n = shape[0] * shape[1]
    if aligned:
        a, b, dh = (_randn(shape, dtype, cuda, i) for i in (6, 7, 8))
    else:
        a, b, dh = (_flat_offset(n, dtype, cuda, i).view(shape)
                    for i in (6, 7, 8))
    before = swiglu_gate_bwd_cuda.launches
    da, db = swiglu_gate_bwd_cuda(a, b, dh)
    torch.cuda.synchronize()
    assert swiglu_gate_bwd_cuda.launches == before + 1
    want_da, want_db = _plain_grads(_gate, (a, b), dh)
    _assert_close(da, want_da, dtype)
    _assert_close(db, want_db, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(128, 128, 128), (300, 256, 520)])
def test_swiglu_gradients_through_the_kernels(cuda, dtype, M, D, F):
    """``fused_swiglu`` on CUDA tensors that want gradients: the kernel
    forward, the gate's backward kernel, dx / dw1 / dw3 against autograd
    of the plain version (bf16 rounds x @ w1 and x @ w3 before the gate's
    backward, within ``TOL``)."""
    x = _randn((M, D), dtype, cuda, 9)
    w1, w3 = (_randn((D, F), dtype, cuda, i) * D ** -0.5 for i in (10, 11))
    dh = _randn((M, F), dtype, cuda, 12)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3)]
    before = (fused_swiglu_cuda.launches, swiglu_gate_bwd_cuda.launches)
    fused_swiglu(*leaves).backward(dh)
    torch.cuda.synchronize()
    assert (fused_swiglu_cuda.launches, swiglu_gate_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, want in zip(leaves, _plain_grads(ref.fused_swiglu,
                                              (x, w1, w3), dh)):
        _assert_close(got.grad, want, dtype)


def _plain_lse(q, k, *, causal, window=0, kv_group=1):
    """Each row's log-sum-exp of its scaled, masked scores (float32)."""
    H, S, d = q.shape
    k = k.float().repeat_interleave(kv_group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k) / d ** 0.5
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    return torch.logsumexp(torch.where(mask, s, torch.full_like(s, ref.NEG)),
                           dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", FLASH_KW, ids=FLASH_KW_IDS)
@pytest.mark.parametrize("H,S,d,g", [(2, 128, 64, 1), (6, 100, 128, 3),
                                     (2, 65, 160, 2), (1, 100, 256, 1)])
def test_flash_attention_training_form(cuda, dtype, kw, H, S, d, g):
    """The forward's training form: the row log-sum-exp close to the plain
    one in float32; the float32 output within float32's ``TOL`` of the
    plain output computed in float32 (bf16 adds P's remainder to P V), the
    output its cast; in float32 the output is serving's, bit for bit."""
    q = _randn((H, S, d), dtype, cuda, 13)
    k, v = (_randn((H // g, S, d), dtype, cuda, i) for i in (14, 15))
    out, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True,
                                           **kw)
    serve_out = flash_attention_cuda(q, k, v, kv_group=g, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (H, S)
    torch.testing.assert_close(lse, _plain_lse(q, k, kv_group=g, **kw),
                               **TOL[torch.float32])
    assert out32.dtype == torch.float32 and out32.shape == (H, S, d)
    assert torch.equal(out, out32.to(dtype))
    plain32 = ref.flash_attention(q.float(), k.float(), v.float(),
                                  kv_group=g, **kw)
    torch.testing.assert_close(out32, plain32, **TOL[torch.float32])
    if dtype == torch.float32:
        assert torch.equal(out, serve_out)
    else:
        _assert_close(serve_out, out, dtype)


def _flash_grads(q, k, v, dout, g, kw):
    """(dq, dk, dv) through ``flash_attention`` on the card (the kernels)
    and through autograd of the plain version."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, kv_group=g, **kw).backward(dout)
    plain = _plain_grads(lambda a, b, c: ref.flash_attention(
        a, b, c, kv_group=g, **kw), (q, k, v), dout)
    return [t.grad for t in leaves], plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", FLASH_KW, ids=FLASH_KW_IDS)
@pytest.mark.parametrize("H,S,d,g", [(2, 128, 64, 1), (1, 256, 32, 1),
                                     (6, 100, 128, 3), (4, 333, 80, 2),
                                     (2, 128, 160, 1), (2, 100, 256, 2),
                                     (1, 1, 64, 1), (3, 1000, 128, 3),
                                     (4, 1000, 64, 4), (2, 4095, 128, 1),
                                     (4, 4095, 64, 4), (3, 200, 128, 3)])
def test_flash_attention_backward_matches_plain(cuda, dtype, kw, H, S, d, g):
    """Every route (bf16 with d % 8 == 0 up to 160 on wgmma + TMA, with S
    ragged against its 64- and 128-row tiles; bf16 past 160 and float32
    on SIMT) in every mask mode."""
    q = _randn((H, S, d), dtype, cuda, 16)
    k, v = (_randn((H // g, S, d), dtype, cuda, i) for i in (17, 18))
    dout = _randn((H, S, d), dtype, cuda, 19)
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches)
    got, want = _flash_grads(q, k, v, dout, g, kw)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype, name
        _assert_close(a, b, dtype)


def test_backward_kernels_are_deterministic_and_named(cuda):
    """Each backward kernel twice on the same inputs: the same bits (no
    atomics), and the profiler sees each kernel by name."""
    bf = torch.bfloat16
    x, dy = _randn((4096, 3072), bf, cuda, 20), _randn((4096, 3072), bf,
                                                      cuda, 21)
    s = _randn((3072,), bf, cuda, 22)
    a, b, dh = (_randn((2048, 8192), bf, cuda, i) for i in (23, 24, 25))
    q = _randn((24, 1024, 128), bf, cuda, 26)
    k, v = (_randn((8, 1024, 128), bf, cuda, i) for i in (27, 28))
    _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=3, train=True)
    dout = _randn((24, 1024, 128), bf, cuda, 29)
    calls = {
        ("rmsnorm_bwd_warp_kernel", "rmsnorm_dscale_kernel"):
            lambda: rmsnorm_bwd_cuda(x, s, dy),
        ("swiglu_gate_bwd_kernel",):
            lambda: swiglu_gate_bwd_cuda(a, b, dh),
        ("flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel<128>",
         "flash_bwd_dq_wgmma_kernel<128>"): lambda: flash_attention_bwd_cuda(
            q, k, v, out32, dout, lse, kv_group=3),
    }
    for wanted, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        for u, w in zip(first, second):
            assert torch.equal(u, w), wanted
        # a trace can drop a window's first kernels: up to three traces
        seen = set()
        for _ in range(3):
            seen |= _kernel_names(call)
            if all(any(w in n for n in seen) for w in wanted):
                break
        assert all(any(w in n for n in seen) for w in wanted), seen


@pytest.mark.parametrize("dtype,d,offset,kernels", [
    (torch.bfloat16, 32, False, ("flash_bwd_dkdv_wgmma_kernel<64>",
                                 "flash_bwd_dq_wgmma_kernel<64>")),
    (torch.bfloat16, 32, True, ("flash_bwd_dkdv_tc_kernel<32>",
                                "flash_bwd_dq_tc_kernel<32>")),
    (torch.bfloat16, 64, False, ("flash_bwd_dkdv_wgmma_kernel<64>",
                                 "flash_bwd_dq_wgmma_kernel<64>")),
    (torch.bfloat16, 128, False, ("flash_bwd_dkdv_wgmma_kernel<128>",
                                  "flash_bwd_dq_wgmma_kernel<128>")),
    (torch.bfloat16, 64, True, ("flash_bwd_dkdv_tc_kernel<64>",
                                "flash_bwd_dq_tc_kernel<64>")),
    (torch.bfloat16, 128, True, ("flash_bwd_dkdv_tc_kernel<128>",
                                 "flash_bwd_dq_tc_kernel<128>")),
    (torch.bfloat16, 80, False, ("flash_bwd_dkdv_wgmma_kernel<128>",
                                 "flash_bwd_dq_wgmma_kernel<128>")),
    (torch.bfloat16, 100, False, ("flash_bwd_dkdv_tc_kernel<128>",
                                  "flash_bwd_dq_tc_kernel<128>")),
    (torch.bfloat16, 120, False, ("flash_bwd_dkdv_wgmma_kernel<128>",
                                  "flash_bwd_dq_wgmma_kernel<128>")),
    (torch.bfloat16, 160, False,
     ("flash_bwd_dkdv_split_wgmma_kernel<160>",
      "flash_bwd_dq_wgmma_kernel<160>")),
    (torch.bfloat16, 160, True, ("flash_bwd_dkdv_tc_kernel<160>",
                                 "flash_bwd_dq_tc_kernel<160>")),
    (torch.bfloat16, 168, False,
     ("flash_bwd_dkdv_kernel<__nv_bfloat16, 2, 16>",
      "flash_bwd_dq_kernel<__nv_bfloat16, 2, 16>")),
    (torch.float32, 128, False, ("flash_bwd_dkdv_kernel<float, 4, 8>",
                                 "flash_bwd_dq_kernel<float, 4, 8>")),
])
def test_flash_backward_route_by_dtype_and_head_dim(cuda, dtype, d, offset,
                                                    kernels):
    """The route rule on the card: bf16 with d % 8 == 0 up to 160 on
    wgmma + TMA (at 64, 128 and 160; the split dk/dv partition at 160), a
    misaligned bf16 view (q one element into its storage) and d % 8 != 0
    up to 160 on mma.sync (the head dim padded to 32, 64, 128 or 160),
    past 160 and in float32 on SIMT, each asserted by name; the gradients
    within ``TOL`` of the plain ones."""
    H, S, g = 4, 200, 2
    q = (_flat_offset(H * S * d, dtype, cuda, 30).view(H, S, d) if offset
         else _randn((H, S, d), dtype, cuda, 30))
    k, v = (_randn((H // g, S, d), dtype, cuda, i) for i in (31, 32))
    dout = _randn((H, S, d), dtype, cuda, 33)
    _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True)
    call = lambda: flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out32, dout, lse, kv_group=g)
    seen = set()
    for _ in range(3):
        seen |= _kernel_names(call)
        if all(any(w in n for n in seen) for w in kernels):
            break
    assert all(any(w in n for n in seen) for w in kernels), seen
    want = _plain_grads(lambda a, b, c: ref.flash_attention(
        a, b, c, kv_group=g), (q, k, v), dout)
    for got, w in zip(call(), want):
        _assert_close(got, w, dtype)


def test_flash_backward_refuses_a_route_it_cannot_take(cuda, monkeypatch):
    """A route the call cannot take is refused by the C entry
    (cudaErrorInvalidValue), never replaced by another: wgmma at head dim
    100 (rows not a multiple of 16 bytes) or 168 (past 160), in float32 or
    on a q off a 16-byte boundary (no tensor map on it), mma.sync in
    float32 or past d 160, SIMT for bf16 at d 128 and 160."""
    from repro_torch.kernels import flash_attention as fa

    for dtype, d, offset, route in [(torch.bfloat16, 100, False, fa.WGMMA),
                                    (torch.bfloat16, 168, False, fa.WGMMA),
                                    (torch.float32, 128, False, fa.WGMMA),
                                    (torch.bfloat16, 128, True, fa.WGMMA),
                                    (torch.float32, 64, False, fa.MMA_SYNC),
                                    (torch.bfloat16, 168, False, fa.MMA_SYNC),
                                    (torch.bfloat16, 128, False, fa.SIMT),
                                    (torch.bfloat16, 160, False, fa.SIMT)]:
        q = (_flat_offset(2 * 64 * d, dtype, cuda, 34).view(2, 64, d)
             if offset else _randn((2, 64, d), dtype, cuda, 34))
        _, lse, out32 = flash_attention_cuda(q, q, q, train=True)
        monkeypatch.setattr(fa, "bwd_route", lambda *a, r=route: r)
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_attention_bwd_cuda(q, q, q, out32, q, lse)


#: bf16 flash backward cases (H, S, d, kv_group, mask) on wgmma whose
#: warpgroups skip leading tiles of a block's run: causal dk/dv (the second
#: warpgroup skips each head's leading query tile) and windowed dq (leading
#: key tiles miss a warpgroup's queries); at d 120 and 160 too (danube's
#: and stablelm's; at 160 dk/dv's warpgroups share their keys and skip
#: nothing, dq skips as at the others)
SKIP_CASES = [(6, 4096, d, 3, dict(causal=True))
              for d in (64, 128, 120, 160)] + [
    (6, S, d, 3, dict(causal=True, window=w)) for w in (64, 256)
    for S in (1024, 4096) for d in (64, 128, 120, 160)]


@pytest.mark.parametrize(
    "H,S,d,g,kw", SKIP_CASES,
    ids=[f"S{S}-d{d}-" + (f"window{kw['window']}" if "window" in kw
                          else "causal") for _, S, d, _, kw in SKIP_CASES])
def test_flash_backward_skipped_tiles_back_to_back(cuda, H, S, d, g, kw):
    """200 launches in a row on one stream, every result kept: none traps
    (a warp waiting on a skipped tile's stage after its refill would), each
    has the first's bits, and the first is within ``TOL`` of plain."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.bwd_route(torch.bfloat16, d) == fa.WGMMA
    bf = torch.bfloat16
    q = _randn((H, S, d), bf, cuda, 110)
    k, v = (_randn((H // g, S, d), bf, cuda, i) for i in (111, 112))
    dout = _randn((H, S, d), bf, cuda, 113)
    _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True,
                                         **kw)
    runs = [flash_attention_bwd_cuda(q, k, v, out32, dout, lse, kv_group=g,
                                     **kw) for _ in range(200)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for u, w in zip(run, runs[0]):
            assert torch.equal(u, w)
    want = _plain_grads(lambda a, b, c: ref.flash_attention(
        a, b, c, kv_group=g, **kw), (q, k, v), dout)
    for got, w in zip(runs[0], want):
        _assert_close(got, w, bf)


# ---------------------------------------------------------------------------
# flash's forward on wgmma + TMA; rmsnorm_bwd on rows past one warp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("kw", FLASH_KW, ids=FLASH_KW_IDS)
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("S", [1, 63, 128, 500, 1000])
@pytest.mark.parametrize("d", [64, 128, 120, 160])
def test_flash_forward_wgmma_matches_plain(cuda, d, S, g, kw, train):
    """The bf16 forward on wgmma + TMA (d 64 and 128, danube's 120 on the
    128 kernel, stablelm's 160; aligned operands) in both forms, S ragged
    against its 64- or 128-key and 128-query tiles, grouped
    kv heads, every mask mode: the output within ``TOL`` of plain; the
    training form's row log-sum-exp and float32 output within float32's
    ``TOL`` of the plain ones in float32, the output its cast."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.fwd_route(torch.bfloat16, d) == fa.WGMMA
    H = 2 * g
    q = _randn((H, S, d), torch.bfloat16, cuda, 90 + S)
    k, v = (_randn((H // g, S, d), torch.bfloat16, cuda, 91 + S + i)
            for i in (1, 2))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, kv_group=g, train=train, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    out = got[0] if train else got
    assert out.dtype == torch.bfloat16 and out.shape == (H, S, d)
    _assert_close(out, ref.flash_attention(q, k, v, kv_group=g, **kw),
                  torch.bfloat16)
    if train:
        _, lse, out32 = got
        torch.testing.assert_close(lse, _plain_lse(q, k, kv_group=g, **kw),
                                   **TOL[torch.float32])
        plain32 = ref.flash_attention(q.float(), k.float(), v.float(),
                                      kv_group=g, **kw)
        torch.testing.assert_close(out32, plain32, **TOL[torch.float32])
        assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("d,offset,train,kernel", [
    (128, False, False, "flash_fwd_wgmma_kernel<128, false>"),
    (128, False, True, "flash_fwd_wgmma_kernel<128, true>"),
    (64, False, False, "flash_fwd_wgmma_kernel<64, false>"),
    (64, False, True, "flash_fwd_wgmma_kernel<64, true>"),
    (128, True, False, "flash_attention_tc_kernel<128, false>"),
    (64, True, True, "flash_attention_tc_kernel<64, true>"),
    (120, False, False, "flash_fwd_wgmma_kernel<128, false>"),
    (120, False, True, "flash_fwd_wgmma_kernel<128, true>"),
    (160, False, False, "flash_fwd_wgmma_kernel<160, false>"),
    (160, False, True, "flash_fwd_wgmma_kernel<160, true>"),
    (160, True, False, "flash_attention_tc_kernel<160, false>"),
    (168, False, True, "flash_attention_tc_kernel<256, true>"),
])
def test_flash_forward_route_by_alignment_named_and_deterministic(
        cuda, d, offset, train, kernel):
    """The forward's route on the card, by kernel name: bf16 with d % 8
    == 0 up to 160 on wgmma + TMA (120 on the 128 kernel), a q one element
    into its storage (no tensor map on it) and d past 160 on mma.sync;
    twice on the same inputs, the same bits (no atomics); the output
    within ``TOL`` of plain."""
    H, S, g = 6, 700, 3
    q = (_flat_offset(H * S * d, torch.bfloat16, cuda, 95).view(H, S, d)
         if offset else _randn((H, S, d), torch.bfloat16, cuda, 95))
    k, v = (_randn((H // g, S, d), torch.bfloat16, cuda, i) for i in (96, 97))
    call = lambda: flash_attention_cuda(  # noqa: E731
        q, k, v, kv_group=g, train=train, causal=True)
    first, second = call(), call()
    torch.cuda.synchronize()
    for u, w in zip(*((first, second) if train else ((first,), (second,)))):
        assert torch.equal(u, w)
    seen = set()
    for _ in range(3):
        seen |= _kernel_names(call)
        if any(kernel in n for n in seen):
            break
    assert any(kernel in n for n in seen), seen
    _assert_close(first[0] if train else first,
                  ref.flash_attention(q, k, v, kv_group=g), torch.bfloat16)


def test_flash_forward_refuses_a_route_it_cannot_take(cuda, monkeypatch):
    """A forward route the call cannot take is refused by the C entry
    (cudaErrorInvalidValue), never replaced by another: wgmma at head dim
    100 (rows not a multiple of 16 bytes) or 168 (past 160), in float32 or
    on a q off a 16-byte boundary, mma.sync in float32, SIMT for bf16; in
    both forms."""
    from repro_torch.kernels import flash_attention as fa

    for dtype, d, offset, route in [(torch.bfloat16, 100, False, fa.WGMMA),
                                    (torch.bfloat16, 168, False, fa.WGMMA),
                                    (torch.float32, 128, False, fa.WGMMA),
                                    (torch.bfloat16, 128, True, fa.WGMMA),
                                    (torch.float32, 64, False, fa.MMA_SYNC),
                                    (torch.bfloat16, 128, False, fa.SIMT)]:
        q = (_flat_offset(2 * 64 * d, dtype, cuda, 98).view(2, 64, d)
             if offset else _randn((2, 64, d), dtype, cuda, 98))
        monkeypatch.setattr(fa, "fwd_route", lambda *a, r=route: r)
        for train in (False, True):
            before = flash_attention_cuda.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                flash_attention_cuda(q, q, q, train=train)
            assert flash_attention_cuda.launches == before


#: danube's and stablelm's head dims on wgmma + TMA: (d, kv_group, S, mask),
#: S not a multiple of 64, windows shorter and longer than a tile run
WIDE_HEADS = [(d, g, S, kw) for d in (120, 160) for g in (1, 4)
              for S in (200, 1000)
              for kw in (dict(causal=True), dict(causal=True, window=64),
                         dict(causal=True, window=256))]


@pytest.mark.parametrize(
    "d,g,S,kw", WIDE_HEADS,
    ids=[f"d{d}-g{g}-S{S}-" + (f"window{kw['window']}" if "window" in kw
                               else "causal") for d, g, S, kw in WIDE_HEADS])
def test_flash_wide_heads_forward_and_gradients_match_plain(cuda, d, g, S,
                                                            kw):
    """bf16 at d 120 (the DP-128 kernels, 8 zero columns from the tensor
    maps) and 160 (three slabs; dk/dv split between the warpgroups) on
    wgmma + TMA: serving's output, the training form's output and the
    gradients within ``TOL`` of plain, the training form and the gradients
    the same bits on two runs."""
    from repro_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    assert fa.fwd_route(bf, d) == fa.bwd_route(bf, d) == fa.WGMMA
    H = 2 * g
    q = _randn((H, S, d), bf, cuda, 120 + d)
    k, v = (_randn((H // g, S, d), bf, cuda, 121 + d + i) for i in (0, 1))
    dout = _randn((H, S, d), bf, cuda, 123 + d)
    want = ref.flash_attention(q, k, v, kv_group=g, **kw)
    _assert_close(flash_attention_cuda(q, k, v, kv_group=g, **kw), want, bf)
    train = [flash_attention_cuda(q, k, v, kv_group=g, train=True, **kw)
             for _ in range(2)]
    grads = [flash_attention_bwd_cuda(q, k, v, train[0][2], dout,
                                      train[0][1], kv_group=g, **kw)
             for _ in range(2)]
    torch.cuda.synchronize()
    for u, w in zip(*train):
        assert torch.equal(u, w)
    for u, w in zip(*grads):
        assert torch.equal(u, w)
    _assert_close(train[0][0], want, bf)
    plain = _plain_grads(lambda a, b, c: ref.flash_attention(
        a, b, c, kv_group=g, **kw), (q, k, v), dout)
    for got, w in zip(grads[0], plain):
        _assert_close(got, w, bf)


#: rmsnorm_bwd's widths past one warp's registers and around the routes'
#: edges: 3080 (past 3072, a multiple of 8), 4100 (not a multiple of 8),
#: 5120, 8192, 12288 (the 4-warp edge in bf16), 16384 (the loop kernel)
WIDE_ROWS = [3080, 4096, 4100, 5120, 8192, 12288, 16384]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("D", WIDE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_wide_rows_match_plain(cuda, dtype, D, offset):
    """rmsnorm_bwd on rows past one warp's registers, on each route (a row
    over 2 or 4 warps, the loop kernel past them, on ragged and
    misaligned rows: x one element into its storage), 300 rows with RMS
    from 0.1 to 10: dx and dscale within ``TOL`` of plain, and the same
    bits twice."""
    M = 300
    rms = torch.from_numpy(np.geomspace(0.1, 10.0, M)[:, None].astype(
        np.float32)).to(cuda)
    x = _randn((M, D), dtype, cuda, 100 + D) * rms.to(dtype)
    if offset:
        base = torch.empty(M * D + 1, dtype=dtype, device=cuda)
        base[1:].copy_(x.reshape(-1))
        x = base[1:].view(M, D)
        assert x.data_ptr() % 16
    s = _randn((D,), dtype, cuda, 101)
    dy = _randn((M, D), dtype, cuda, 102)
    before = rmsnorm_bwd_cuda.launches
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    again = rmsnorm_bwd_cuda(x, s, dy)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches == before + 2
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])
    want_dx, want_ds = _plain_grads(ref.rmsnorm, (x, s), dy)
    _assert_close(dx, want_dx, dtype)
    _assert_close(ds, want_ds, dtype)


@pytest.mark.parametrize("dtype,D,offset,kernel", [
    (torch.bfloat16, 3072, False, "rmsnorm_bwd_warp_kernel"),
    (torch.bfloat16, 4096, False, "rmsnorm_bwd_split_kernel<__nv_bfloat16, 2>"),
    (torch.bfloat16, 8192, False, "rmsnorm_bwd_split_kernel<__nv_bfloat16, 4>"),
    (torch.bfloat16, 12288, False,
     "rmsnorm_bwd_split_kernel<__nv_bfloat16, 4>"),
    (torch.bfloat16, 16384, False,
     "rmsnorm_bwd_loop_kernel<__nv_bfloat16, true>"),
    (torch.bfloat16, 4096, True,
     "rmsnorm_bwd_loop_kernel<__nv_bfloat16, false>"),
    (torch.bfloat16, 4100, False,
     "rmsnorm_bwd_loop_kernel<__nv_bfloat16, false>"),
    (torch.float32, 3072, False, "rmsnorm_bwd_split_kernel<float, 2>"),
    (torch.float32, 6144, False, "rmsnorm_bwd_split_kernel<float, 4>"),
    (torch.float32, 8192, False, "rmsnorm_bwd_loop_kernel<float, true>"),
])
def test_rmsnorm_backward_route_by_width(cuda, dtype, D, offset, kernel):
    """The C entry's choice by row width and alignment, asserted by kernel
    name: a row over 1, 2 or 4 warps up to 3072, 6144 and 12288 bf16 (half
    that in float32), the loop kernel past it and on ragged or misaligned
    rows (16-byte loads only where aligned)."""
    M = 64
    x = (_flat_offset(M * D, dtype, cuda, 103).view(M, D) if offset
         else _randn((M, D), dtype, cuda, 103))
    s, dy = _randn((D,), dtype, cuda, 104), _randn((M, D), dtype, cuda, 105)
    call = lambda: rmsnorm_bwd_cuda(x, s, dy)  # noqa: E731
    seen = set()
    for _ in range(3):
        seen |= _kernel_names(call)
        if any(kernel in n for n in seen):
            break
    assert any(kernel in n for n in seen), seen
    for got, want in zip(call(), _plain_grads(ref.rmsnorm, (x, s), dy)):
        _assert_close(got, want, dtype)


# ---------------------------------------------------------------------------
# every family trains: the Mamba-1 scan's gradient form, a smoke step each
# ---------------------------------------------------------------------------


def _scan_inputs(device, T=40, Bsz=2, Di=24, N=8):
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    dt = torch.nn.functional.softplus(r(Bsz, T, Di) - 1.0)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(Di, N).clone()
    return [t.to(device) for t in (dt, r(Bsz, T, N), r(Bsz, T, N),
                                   r(Bsz, T, Di), A, r(Bsz, Di, N))]


def test_mamba1_scan_grad_form_on_the_card(cuda):
    """``_Mamba1Scan`` on the card: its forward equals the card's serving
    scan bit for bit, and its values and gradients (dt, B, C, x, A, h0;
    T 40 in chunks of 16, the last of 8) equal the CPU's within float32
    sum-order noise (``PARITY_TOL``, atol relative to the largest)."""
    from repro_torch.models import ssm

    outs = {}
    for dev in ("cpu", cuda):
        ins = _scan_inputs(dev)
        with torch.no_grad():
            serve = ssm._mamba1_scan(*ins, 16)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, h = ssm._mamba1_scan(*leaves, 16)
        assert torch.equal(y.detach(), serve[0])
        assert torch.equal(h.detach(), serve[1])
        gy = torch.ones_like(y) * torch.linspace(-1, 1, y.shape[-1],
                                                 device=y.device)
        grads = torch.autograd.grad((y * gy).sum() + h.square().sum(),
                                    leaves)
        outs[str(dev)] = [y, h, *grads]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   rtol=PARITY_TOL["rtol"],
                                   atol=PARITY_TOL["atol"] * scale)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "arctic_480b",
                                  "falcon_mamba_7b", "zamba2_1_2b",
                                  "whisper_tiny", "qwen2_vl_72b"])
def test_smoke_train_step_on_card_equals_cpu(cuda, arch):
    """One AdamW step at smoke width in float32 (from moments with
    history) under the train loop's deterministic algorithms, on the card
    through the kernels and their backward kernels and on the CPU: the
    loss and every param after the step within ``PARITY_TOL``, every
    gradient leaf within 5e-3 relative L2 error (``chip_smoke.py``'s
    ``GRAD_REL_TOL``); ``rmsnorm_bwd`` launched."""
    import os

    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    from repro_torch.train import steps
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import batch_to, deterministic
    from repro_torch.train.tree import items, tree_map as _tree_map

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = smoke_config(arch)
    shape = ShapeSpec("s", 64, 2, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=1e-2,
                    warmup_steps=1, total_steps=10)
    batch = batch_for_step(cfg, shape, 0, 0)
    drawn = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32).params
    # moments with history (step 7): from a zero state AdamW's first update
    # is lr times the sign of each gradient entry, which float32 noise
    # flips at entries near zero
    g = torch.Generator().manual_seed(1)
    moments = {"m": _tree_map(lambda t: torch.randn(
        t.shape, generator=g) * 1e-2, drawn),
               "v": _tree_map(lambda t: (torch.randn(
                   t.shape, generator=g) * 1e-2) ** 2 + 1e-6, drawn)}
    out = {}
    for dev in ("cpu", cuda):
        model = zoo.build(cfg, _tree_to(drawn, dev))
        state = {"m": _tree_to(moments["m"], dev),
                 "v": _tree_to(moments["v"], dev),
                 "step": torch.tensor(7, dtype=torch.int32, device=dev)}
        before = rmsnorm_bwd_cuda.launches
        with deterministic():
            _, _, m = steps.make_train_step(cfg, run)(
                model, state, batch_to(batch, dev, torch.float32))
        out[str(dev)] = (m["loss"], dict(items(model.params)),
                         dict(items(model.grads)),
                         rmsnorm_bwd_cuda.launches - before)
    (lc, pc, gc, nc), (lh, ph, gh, _) = out["cuda"], out["cpu"]
    assert nc > 0
    torch.testing.assert_close(lc.cpu(), lh, **PARITY_TOL)
    for key, t in gc.items():  # chip_smoke.py's GRAD_REL_TOL
        rel = (t.cpu() - gh[key]).norm() / gh[key].norm()
        assert rel <= 5e-3, (key, rel.item())
    for key, t in pc.items():
        torch.testing.assert_close(t.cpu(), ph[key], **PARITY_TOL,
                                   msg=lambda m, key=key: f"{key}: {m}")


def _tree_to(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


@pytest.mark.parametrize("head_dim,theta", [(120, 1e4), (128, 1e6),
                                            (64, 1e4), (128, 5e5)])
def test_rope_frequencies_are_the_cpus_bits(cuda, head_dim, theta):
    """RoPE's inverse frequencies on the card equal the CPU's bit for bit
    (the float64 power rounded once: CUDA's float32 pow was up to 5 ulp
    off, which at h2o_danube_3_4b's position 4600 moved the card's logits
    1.55-2.0 x ``PARITY_TOL`` from the CPU's), and so does RoPE at
    positions past 4096."""
    from repro_torch.models import layers as L

    assert torch.equal(L._inv_freq(head_dim, theta, cuda).cpu(),
                       L._inv_freq(head_dim, theta, "cpu"))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 4600, 2, head_dim), generator=g) * 20
    pos = torch.arange(4600, dtype=torch.int32)[None]
    got = L.apply_rope(x.cuda(), pos.cuda(), theta).cpu()
    want = L.apply_rope(x, pos, theta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_spans_of_a_train_step_and_generate_on_the_card(cuda):
    """``repro_torch.tracing`` on the card: a smoke-width train step under
    the profiler gives ``train.step`` as a host range with its three
    phases inside it, each timed with device time; the remat recompute's
    ``model.rope`` spans, opened on autograd's device thread, lie inside
    ``train.backward``; no span is drawn on the device's timeline; and a
    one-token ``generate`` gives ``serve.prefill`` inside
    ``serve.generate``, over the interval ``prefill_s`` times.  Without the
    profiler nothing is kept."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import batch_to

    def ranges(prof, name):
        return [(e.time_range.start, e.time_range.end)
                for e in prof.events() if e.name == name
                and e.device_type == torch.autograd.DeviceType.CPU]

    def inside(prof, name, outer):
        outs = ranges(prof, outer)
        return sum(any(s <= a and b <= t for s, t in outs)
                   for a, b in ranges(prof, name))

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = smoke_config("llama3_2_3b").replace(n_layers=2, remat="dots")
    shape = ShapeSpec("s", 64, 2, "train")
    run = RunConfig(model=cfg, shape=shape)
    model = zoo.build(cfg, _tree_to(zoo.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu", torch.float32).params,
        cuda))
    state = opt_lib.init_opt_state(model.params, steps.adamw_config(cfg, run))
    batch = batch_to(batch_for_step(cfg, shape, 0, 0), cuda, torch.float32)
    step = steps.make_train_step(cfg, run)
    tracing.reset()
    step(model, state, batch)
    assert tracing.totals() == {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, state, batch)
        torch.cuda.synchronize()
    # a span is a host range only: nothing of it on the device's timeline
    assert not [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(("train.", "model.", "serve."))]
    assert len(ranges(prof, "train.step")) == 1
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert inside(prof, name, "train.step") == 1, (name, ranges(
            prof, name), ranges(prof, "train.step"))
    spans = {n: ranges(prof, n) for n in (
        "train.step", "train.forward", "train.backward", "model.rope")}
    assert inside(prof, "model.rope", "train.forward") == 2, spans
    assert inside(prof, "model.rope", "train.backward") == 2, spans
    t = tracing.totals()
    assert {n: v.count for n, v in t.items()} == {
        "train.forward": 1, "train.backward": 1, "train.optimizer": 1,
        "model.rope": 4}
    assert all(v.device_s and v.device_s > 0 for v in t.values()), t
    tracing.reset()
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                            device=cuda)
    generate(cfg, model, prompts, max_new_tokens=1)  # first call unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, info = generate(cfg, model, prompts, max_new_tokens=1)
    assert inside(prof, "serve.prefill", "serve.generate") == 1
    [(s, e)] = ranges(prof, "serve.prefill")
    assert 1e-6 * (e - s) == pytest.approx(info["prefill_s"], abs=2e-3), \
        (s, e, info)
    t = tracing.totals()
    assert set(t) == {"model.rope"} and t["model.rope"].count == 2
    assert t["model.rope"].device_s > 0
    tracing.reset()
