"""The port's language-model kernels vs the JAX package, on the CPU.

The plain PyTorch versions (``repro_torch.kernels.ref.rmsnorm``,
``fused_swiglu``, ``flash_attention``) and the wrappers given CPU tensors
must agree with the JAX oracles (``repro.kernels.ref``) and with the Pallas
kernels run in interpret mode (``repro.kernels.ops``), on the shapes,
dtypes and tolerances of ``tests/test_kernels.py``.  Ragged shapes, which
the Pallas kernels refuse (their blocks must divide the shape), are held
against the oracles only.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here their entries must
refuse CPU tensors, and ``fused_swiglu``'s route rule (shape, dtype and
16-byte alignment) and the flash forward's and backward's (dtype, head dim
and 16-byte alignment) are held as the wrappers apply them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_swiglu as fs
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_swiglu import fused_swiglu, fused_swiglu_cuda
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cuda

#: tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=2e-4, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-1)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_KW = [dict(causal=True), dict(causal=True, window=64),
            dict(causal=False)]


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype`` (drawn
    in float32, rounded once to ``dtype`` on the JAX side and carried over
    exactly)."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    JAX_DT[dtype])
    t = torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
    return a, t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("M,D,F", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_swiglu_matches_jax(M, D, F, dtype):
    rng = np.random.default_rng(42)
    (x, tx), (w1, tw1), (w3, tw3) = (_pair(rng, s, dtype)
                                     for s in [(M, D), (D, F), (D, F)])
    want_ref = jax_ref.fused_swiglu(x, w1, w3)
    want_pallas = jax_ops.fused_swiglu(x, w1, w3)
    for got in (ref.fused_swiglu(tx, tw1, tw3), fused_swiglu(tx, tw1, tw3)):
        assert got.dtype == TORCH_DT[dtype] and got.shape == (M, F)
        _close(got, want_ref, **TOL[dtype])
        _close(got, want_pallas, **TOL[dtype])


@pytest.mark.parametrize("M,D", [(128, 64), (256, 512), (64, 160)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(M, D, dtype):
    rng = np.random.default_rng(42)
    (x, tx), (s, ts) = _pair(rng, (M, D), dtype), _pair(rng, (D,), dtype)
    want_ref = jax_ref.rmsnorm(x, s)
    want_pallas = jax_ops.rmsnorm(x, s, block_m=64)
    for got in (ref.rmsnorm(tx, ts), rmsnorm(tx, ts)):
        assert got.dtype == TORCH_DT[dtype] and got.shape == (M, D)
        _close(got, want_ref, **TOL[dtype])
        _close(got, want_pallas, **TOL[dtype])


@pytest.mark.parametrize("H,S,d", [(2, 128, 64), (1, 256, 32)])
@pytest.mark.parametrize("kw", FLASH_KW, ids=["causal", "window64", "full"])
def test_flash_attention_matches_jax(H, S, d, kw):
    rng = np.random.default_rng(42)
    (q, tq), (k, tk), (v, tv) = (_pair(rng, (H, S, d), "float32")
                                 for _ in range(3))
    want_ref = jax_ref.flash_attention(q, k, v, **kw)
    want_pallas = jax_ops.flash_attention(q, k, v, block_q=64, block_k=64,
                                          **kw)
    for got in (ref.flash_attention(tq, tk, tv, **kw),
                flash_attention(tq, tk, tv, **kw)):
        _close(got, want_ref, rtol=2e-4, atol=2e-3)
        _close(got, want_pallas, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_shapes_match_jax_oracles(dtype):
    """M = 100 rows and S = 100 positions: no block of the Pallas kernels
    divides them, the port's kernels mask the edge instead.  fused_swiglu
    also at shapes that straddle the CUDA routes' tiles (1, 17 and 129
    rows: both sides of the stream route's 16 and of a 128-row tensor-core
    tile; F = 136 and 264 past 128-column tiles), where the Pallas kernel
    in interpret mode runs one block of the whole shape."""
    rng = np.random.default_rng(7)
    (x, tx), (s, ts) = _pair(rng, (100, 96), dtype), _pair(rng, (96,), dtype)
    _close(rmsnorm(tx, ts), jax_ref.rmsnorm(x, s), **TOL[dtype])
    (x, tx), (w1, tw1), (w3, tw3) = (_pair(rng, sh, dtype) for sh in
                                     [(100, 72), (72, 136), (72, 136)])
    _close(fused_swiglu(tx, tw1, tw3), jax_ref.fused_swiglu(x, w1, w3),
           **TOL[dtype])
    for M in (1, 17, 129):
        for F in (136, 264):
            (x, tx), (w1, tw1), (w3, tw3) = (_pair(rng, sh, dtype) for sh in
                                             [(M, 72), (72, F), (72, F)])
            got = fused_swiglu(tx, tw1, tw3)
            assert got.shape == (M, F) and got.dtype == TORCH_DT[dtype]
            _close(got, jax_ref.fused_swiglu(x, w1, w3), **TOL[dtype])
            _close(got, jax_ops.fused_swiglu(x, w1, w3, block_m=M,
                                             block_f=F, block_k=72),
                   **TOL[dtype])
    (q, tq), (k, tk), (v, tv) = (_pair(rng, (3, 100, 16), dtype)
                                 for _ in range(3))
    for kw in FLASH_KW:
        _close(flash_attention(tq, tk, tv, **kw),
               jax_ref.flash_attention(q, k, v, **kw), **TOL[dtype])


@pytest.mark.parametrize("kw", FLASH_KW, ids=["causal", "window64", "full"])
def test_flash_attention_kv_group_is_repeated_heads(kw):
    """``kv_group`` g: query head h reads kv head h // g, which is the
    JAX oracle over k/v with each head repeated g times."""
    rng = np.random.default_rng(3)
    (q, tq) = _pair(rng, (6, 100, 32), "float32")
    (k, tk), (v, tv) = (_pair(rng, (2, 100, 32), "float32") for _ in range(2))
    want = jax_ref.flash_attention(q, jnp.repeat(k, 3, axis=0),
                                   jnp.repeat(v, 3, axis=0), **kw)
    _close(flash_attention(tq, tk, tv, kv_group=3, **kw), want,
           rtol=2e-4, atol=2e-3)


ROUTES = [
    # decode: at most 16 rows stream the weights, in either dtype
    ((4, 3072, 8192), "float32", fs.STREAM),
    ((4, 3072, 8192), "bfloat16", fs.STREAM),
    ((16, 3072, 8192), "float32", fs.STREAM),
    ((16, 3072, 8192), "bfloat16", fs.STREAM),
    ((1, 72, 130), "bfloat16", fs.STREAM),
    ((16, 1000, 130), "float32", fs.STREAM),
    # prefill in bf16 with 16-byte strides: tensor cores
    ((17, 3072, 8192), "bfloat16", fs.TENSOR_CORES),
    ((2000, 3072, 8192), "bfloat16", fs.TENSOR_CORES),
    ((129, 72, 136), "bfloat16", fs.TENSOR_CORES),
    # float32 past 16 rows, and bf16 strides TMA cannot describe: SIMT
    ((17, 3072, 8192), "float32", fs.SIMT),
    ((2000, 3072, 8192), "float32", fs.SIMT),
    ((100, 72, 130), "bfloat16", fs.SIMT),
    ((100, 1000, 520), "float32", fs.SIMT),
    ((300, 70, 136), "bfloat16", fs.SIMT),
    ((17, 0, 136), "bfloat16", fs.SIMT),
]


@pytest.mark.parametrize("shape,dtype,want", ROUTES,
                         ids=[f"{s}-{d}" for s, d, _ in ROUTES])
def test_fused_swiglu_route_by_shape_and_dtype(shape, dtype, want):
    assert fs.route(*shape, TORCH_DT[dtype]) == want


@pytest.mark.parametrize("shape,dtype,want", ROUTES[::3],
                         ids=[f"{s}-{d}" for s, d, _ in ROUTES[::3]])
def test_fused_swiglu_wrapper_passes_its_route(monkeypatch, shape, dtype,
                                               want):
    """What the wrapper hands the C entry: the pointers, M, D, F, the dtype
    code and the route code, in ``_ARGS``' order; one launch counted."""
    M, D, F = shape
    x = torch.zeros((M, D), dtype=TORCH_DT[dtype])
    w1, w3 = (torch.zeros((D, F), dtype=TORCH_DT[dtype]) for _ in range(2))
    calls = []
    monkeypatch.setattr(fs._launch, "check_operands",
                        lambda *a: (fs._launch.DTYPE_CODES[x.dtype], 0))
    monkeypatch.setattr(fs._launch, "launch",
                        lambda name, argtypes, index, *args:
                        calls.append((name, argtypes, index, args)))
    before = fused_swiglu_cuda.launches
    out = fused_swiglu_cuda(x, w1, w3)
    assert fused_swiglu_cuda.launches == before + 1
    (name, argtypes, index, args), = calls
    assert (name, argtypes, index) == ("fused_swiglu", fs._ARGS, 0)
    assert len(args) == len(fs._ARGS)
    assert args[:4] == (x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                        out.data_ptr())
    assert args[4:] == (M, D, F, fs._launch.DTYPE_CODES[x.dtype], want)
    assert out.shape == (M, F) and out.dtype == x.dtype
    fused_swiglu_cuda.launches = before


@pytest.mark.parametrize("M,D,F,want_aligned,want_misaligned", [
    (2000, 3072, 8192, fs.TENSOR_CORES, fs.SIMT),  # prefill: SIMT if offset
    (17, 72, 136, fs.TENSOR_CORES, fs.SIMT),
    (4, 3072, 8192, fs.STREAM, fs.STREAM),  # the stream loads any address
    (100, 72, 130, fs.SIMT, fs.SIMT),
])
def test_fused_swiglu_route_takes_alignment(M, D, F, want_aligned,
                                            want_misaligned):
    """bf16 operands that do not all start on 16-byte boundaries cannot be
    described to TMA: the route rule sends them to SIMT (a route choice,
    as float32's is), and to tensor cores only when aligned."""
    assert fs.route(M, D, F, torch.bfloat16) == want_aligned
    assert fs.route(M, D, F, torch.bfloat16, aligned=True) == want_aligned
    assert fs.route(M, D, F, torch.bfloat16, aligned=False) == \
        want_misaligned


@pytest.mark.parametrize("offset", ["x", "w1", "w3", "none"])
def test_fused_swiglu_wrapper_routes_offset_views_to_simt(monkeypatch,
                                                          offset):
    """A contiguous bf16 view one element into its storage (2 bytes past a
    16-byte boundary) makes the wrapper pass the SIMT route code; fresh
    tensors pass tensor cores.  The output is the wrapper's own
    allocation, so it is aligned."""
    M, D, F = 32, 64, 128
    shapes = {"x": (M, D), "w1": (D, F), "w3": (D, F)}
    ts = {}
    for name, (r, c) in shapes.items():
        if name == offset:
            ts[name] = torch.zeros(r * c + 1, dtype=torch.bfloat16)[1:] \
                .view(r, c)
            assert ts[name].is_contiguous() and ts[name].data_ptr() % 16 == 2
        else:
            ts[name] = torch.zeros((r, c), dtype=torch.bfloat16)
    calls = []
    monkeypatch.setattr(fs._launch, "check_operands", lambda *a: (1, 0))
    monkeypatch.setattr(fs._launch, "launch",
                        lambda name, argtypes, index, *args:
                        calls.append(args))
    before = fused_swiglu_cuda.launches
    out = fused_swiglu_cuda(ts["x"], ts["w1"], ts["w3"])
    fused_swiglu_cuda.launches = before
    (args,) = calls
    assert args[3] == out.data_ptr() and out.data_ptr() % 16 == 0
    assert args[-1] == (fs.TENSOR_CORES if offset == "none" else fs.SIMT)


#: (dtype, head dim, 16-byte aligned operands, the backward's route)
BWD_ROUTES = [
    # bf16 with d % 8 == 0 up to 160 and operands TMA can take: wgmma +
    # TMA (built at 64, 128 and 160; danube's 120 and stablelm's 160)
    ("bfloat16", 128, True, fa.WGMMA),
    ("bfloat16", 64, True, fa.WGMMA),
    ("bfloat16", 32, True, fa.WGMMA),
    ("bfloat16", 80, True, fa.WGMMA),
    ("bfloat16", 96, True, fa.WGMMA),
    ("bfloat16", 120, True, fa.WGMMA),
    ("bfloat16", 160, True, fa.WGMMA),
    # misaligned bf16 and d % 8 != 0 up to 160: mma.sync
    ("bfloat16", 128, False, fa.MMA_SYNC),
    ("bfloat16", 64, False, fa.MMA_SYNC),
    ("bfloat16", 120, False, fa.MMA_SYNC),
    ("bfloat16", 160, False, fa.MMA_SYNC),
    ("bfloat16", 100, True, fa.MMA_SYNC),
    ("bfloat16", 1, True, fa.MMA_SYNC),
    # float32 (TF32 products would miss its tolerance) and bf16 past 160
    ("bfloat16", 168, True, fa.SIMT),
    ("bfloat16", 192, True, fa.SIMT),
    ("bfloat16", 256, True, fa.SIMT),
    ("bfloat16", 256, False, fa.SIMT),
    ("float32", 64, True, fa.SIMT),
    ("float32", 128, True, fa.SIMT),
    ("float32", 128, False, fa.SIMT),
    ("float32", 256, True, fa.SIMT),
]


@pytest.mark.parametrize("dtype,d,aligned,want", BWD_ROUTES,
                         ids=[f"{t}-d{d}-{'aligned' if a else 'offset'}"
                              for t, d, a, _ in BWD_ROUTES])
def test_flash_bwd_route_by_dtype_head_dim_and_alignment(dtype, d, aligned,
                                                         want):
    assert fa.bwd_route(TORCH_DT[dtype], d, aligned) == want
    if aligned:
        assert fa.bwd_route(TORCH_DT[dtype], d) == want


def _bwd_operands(H, S, d, g, dtype, offset=None):
    """q, k, v, dout (``offset``: that one a contiguous view one element
    into its storage), out32 and lse on the CPU."""
    shapes = {"q": (H, S, d), "k": (H // g, S, d), "v": (H // g, S, d),
              "dout": (H, S, d)}
    ts = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name == offset:
            ts[name] = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
            assert ts[name].is_contiguous() and ts[name].data_ptr() % 16
        else:
            ts[name] = torch.zeros(shape, dtype=dtype)
    return (ts["q"], ts["k"], ts["v"], ts["dout"],
            torch.zeros((H, S, d)), torch.zeros((H, S)))


@pytest.mark.parametrize("dtype,d,aligned,want",
                         [r for r in BWD_ROUTES if r[2]],
                         ids=[f"{t}-d{d}" for t, d, a, _ in BWD_ROUTES if a])
def test_flash_bwd_wrapper_passes_its_route(monkeypatch, dtype, d, aligned,
                                            want):
    """What the backward wrapper hands the C entry: ten pointers (q, k, v,
    out32, dout, lse, dq, dk, dv, delta), H, S, d, the mask, the scale,
    the dtype code and the route code, in ``_BWD_ARGS``' order; one launch
    counted."""
    H, S, g = 4, 40, 2
    q, k, v, dout, out32, lse = _bwd_operands(H, S, d, g, TORCH_DT[dtype])
    calls = []
    monkeypatch.setattr(fa._launch, "check_operands",
                        lambda *a: (fa._launch.DTYPE_CODES[q.dtype], 0))
    monkeypatch.setattr(fa._launch, "launch",
                        lambda name, argtypes, index, *args, library="":
                        calls.append((name, argtypes, index, args, library)))
    before = fa.flash_attention_bwd_cuda.launches
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out32, dout, lse,
                                             kv_group=g, window=8)
    assert fa.flash_attention_bwd_cuda.launches == before + 1
    fa.flash_attention_bwd_cuda.launches = before
    (name, argtypes, index, args, library), = calls
    assert (name, argtypes, index, library) == (
        "flash_attention_bwd", fa._BWD_ARGS, 0, "flash_attention")
    assert len(args) == len(fa._BWD_ARGS)
    assert args[:10] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         args[9])
    assert args[10:16] == (H, S, d, 1, 8, g)
    assert args[16] == pytest.approx(d ** -0.5)
    assert args[17:] == (fa._launch.DTYPE_CODES[q.dtype], want)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("offset", ["q", "k", "v", "dout", None])
@pytest.mark.parametrize("d", [64, 128, 120, 160])
def test_flash_bwd_wrapper_routes_offset_views_to_mma_sync(monkeypatch,
                                                           offset, d):
    """A contiguous bf16 operand one element into its storage (2 bytes past
    a 16-byte boundary) cannot be described to TMA: the wrapper passes the
    ``mma.sync`` route code; fresh tensors pass ``wgmma``.  dq, dk and dv
    are the wrapper's own allocations, so they are aligned."""
    q, k, v, dout, out32, lse = _bwd_operands(3, 24, d, 3, torch.bfloat16,
                                              offset)
    calls = []
    monkeypatch.setattr(fa._launch, "check_operands", lambda *a: (1, 0))
    monkeypatch.setattr(fa._launch, "launch",
                        lambda name, argtypes, index, *args, library="":
                        calls.append(args))
    before = fa.flash_attention_bwd_cuda.launches
    grads = fa.flash_attention_bwd_cuda(q, k, v, out32, dout, lse,
                                        kv_group=3)
    fa.flash_attention_bwd_cuda.launches = before
    (args,) = calls
    assert all(t.data_ptr() % 16 == 0 for t in grads)
    assert args[-1] == (fa.WGMMA if offset is None else fa.MMA_SYNC)


#: (dtype, head dim, 16-byte aligned q, k and v, the forward's route)
FWD_ROUTES = [
    # bf16 with d % 8 == 0 up to 160 and operands TMA can take: wgmma +
    # TMA (built at 64, 128 and 160; danube's 120 and stablelm's 160)
    ("bfloat16", 128, True, fa.WGMMA),
    ("bfloat16", 64, True, fa.WGMMA),
    ("bfloat16", 32, True, fa.WGMMA),
    ("bfloat16", 80, True, fa.WGMMA),
    ("bfloat16", 120, True, fa.WGMMA),
    ("bfloat16", 160, True, fa.WGMMA),
    # misaligned bf16, d % 8 != 0 and d past 160 up to 256: mma.sync
    ("bfloat16", 128, False, fa.MMA_SYNC),
    ("bfloat16", 64, False, fa.MMA_SYNC),
    ("bfloat16", 120, False, fa.MMA_SYNC),
    ("bfloat16", 160, False, fa.MMA_SYNC),
    ("bfloat16", 100, True, fa.MMA_SYNC),
    ("bfloat16", 168, True, fa.MMA_SYNC),
    ("bfloat16", 192, True, fa.MMA_SYNC),
    ("bfloat16", 256, True, fa.MMA_SYNC),
    ("bfloat16", 256, False, fa.MMA_SYNC),
    ("bfloat16", 1, True, fa.MMA_SYNC),
    # float32 (TF32 products would miss its tolerance)
    ("float32", 64, True, fa.SIMT),
    ("float32", 128, True, fa.SIMT),
    ("float32", 128, False, fa.SIMT),
    ("float32", 256, True, fa.SIMT),
]


@pytest.mark.parametrize("dtype,d,aligned,want", FWD_ROUTES,
                         ids=[f"{t}-d{d}-{'aligned' if a else 'offset'}"
                              for t, d, a, _ in FWD_ROUTES])
def test_flash_fwd_route_by_dtype_head_dim_and_alignment(dtype, d, aligned,
                                                         want):
    assert fa.fwd_route(TORCH_DT[dtype], d, aligned) == want
    if aligned:
        assert fa.fwd_route(TORCH_DT[dtype], d) == want


def _fwd_operands(H, S, d, g, dtype, offset=None):
    """q, k, v on the CPU (``offset``: that one a contiguous view one
    element into its storage)."""
    shapes = {"q": (H, S, d), "k": (H // g, S, d), "v": (H // g, S, d)}
    ts = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name == offset:
            ts[name] = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
            assert ts[name].is_contiguous() and ts[name].data_ptr() % 16
        else:
            ts[name] = torch.zeros(shape, dtype=dtype)
    return ts["q"], ts["k"], ts["v"]


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("dtype,d,aligned,want",
                         [r for r in FWD_ROUTES if r[2]],
                         ids=[f"{t}-d{d}" for t, d, a, _ in FWD_ROUTES if a])
def test_flash_fwd_wrapper_passes_its_route(monkeypatch, dtype, d, aligned,
                                            want, train):
    """What the forward wrapper hands the C entry: six pointers (q, k, v,
    out, lse, out32: null when serving, and out32 null in float32, where
    the output is its own float32 form), H, S, d, the mask, the scale, the
    dtype code and the route code, in ``_ARGS``' order; one launch
    counted."""
    H, S, g = 4, 40, 2
    q, k, v = _fwd_operands(H, S, d, g, TORCH_DT[dtype])
    calls = []
    monkeypatch.setattr(fa._launch, "check_operands",
                        lambda *a: (fa._launch.DTYPE_CODES[q.dtype], 0))
    monkeypatch.setattr(fa._launch, "launch",
                        lambda name, argtypes, index, *args, library="":
                        calls.append((name, argtypes, index, args, library)))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, kv_group=g, window=8, train=train)
    assert fa.flash_attention_cuda.launches == before + 1
    fa.flash_attention_cuda.launches = before
    (name, argtypes, index, args, library), = calls
    assert (name, argtypes, index, library) == ("flash_attention", fa._ARGS,
                                                0, "")
    assert len(args) == len(fa._ARGS)
    out, lse, out32 = got if train else (got, None, None)
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    want_lse = lse.data_ptr() if train else 0
    want_o32 = out32.data_ptr() if train and out32 is not out else 0
    assert args[4:6] == (want_lse, want_o32)
    assert args[6:12] == (H, S, d, 1, 8, g)
    assert args[12] == pytest.approx(d ** -0.5)
    assert args[13:] == (fa._launch.DTYPE_CODES[q.dtype], want)


@pytest.mark.parametrize("offset", ["q", "k", "v", None])
@pytest.mark.parametrize("d", [64, 128, 120, 160])
def test_flash_fwd_wrapper_routes_offset_views_to_mma_sync(monkeypatch,
                                                           offset, d):
    """A contiguous bf16 q, k or v one element into its storage (2 bytes
    past a 16-byte boundary) cannot be described to TMA: the wrapper
    passes the ``mma.sync`` route code; fresh tensors pass ``wgmma``.  The
    output is the wrapper's own allocation, so it is aligned."""
    q, k, v = _fwd_operands(3, 24, d, 3, torch.bfloat16, offset)
    calls = []
    monkeypatch.setattr(fa._launch, "check_operands", lambda *a: (1, 0))
    monkeypatch.setattr(fa._launch, "launch",
                        lambda name, argtypes, index, *args, library="":
                        calls.append(args))
    before = fa.flash_attention_cuda.launches
    out = fa.flash_attention_cuda(q, k, v, kv_group=3)
    fa.flash_attention_cuda.launches = before
    (args,) = calls
    assert out.data_ptr() % 16 == 0
    assert args[-1] == (fa.WGMMA if offset is None else fa.MMA_SYNC)


def test_wrappers_count_no_launch_on_the_cpu():
    x = torch.ones(4, 8)
    before = (rmsnorm_cuda.launches, fused_swiglu_cuda.launches,
              flash_attention_cuda.launches)
    rmsnorm(x, torch.ones(8))
    fused_swiglu(x, torch.ones(8, 8), torch.ones(8, 8))
    flash_attention(x[None], x[None], x[None])
    assert (rmsnorm_cuda.launches, fused_swiglu_cuda.launches,
            flash_attention_cuda.launches) == before


def test_cuda_entries_refuse_cpu_tensors():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_swiglu_cuda(x, torch.ones(8, 8), torch.ones(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x[None], x[None], x[None])
