"""The port's Mamba-1 family (``repro_torch.models.ssm``) vs the JAX
package's ``repro.models.ssm``, on the CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``params_from_numpy``, which keeps ``dt_bias``, ``A_log`` and
``Dskip`` float32), so both packages compute the same function on the
same prompts.  falcon_mamba_7b's smoke config (2 layers, d_model 64,
d_inner 128, state 8, conv 4, ``ssm_chunk`` 16) at T 16, which scans one
chunk, and at T 40, which scans four (``_chunk_len`` gives 10).  The
``rmsnorm`` kernel runs through its wrapper, which on CPU tensors takes
the plain version.

Tolerances:

* float32, parameters cast to float32 on both sides: ``F32`` (rtol 1e-4,
  atol 1e-4; for hidden states, conv windows and states atol is relative
  to the reference's largest magnitude).  The two sides differ in the
  order of sums (the projections, the state's contraction with C) and in
  a few ulps of exp; greedy tokens must be equal;
* bfloat16: ``tests/test_serving.py``'s rtol 0.12, atol 0.25.  The port's
  ``rms_norm`` rounds in another place than the JAX layers (ROADMAP.md
  section 3);
* ``init_params``' ``ssm_dt`` leaves equal ``init_of``'s bit for bit;
  its ``ssm_a`` leaves are the correctly rounded float32 log, within one
  ulp of XLA's CPU log, which is one ulp off at 7 (the smoke state is 8).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.serve.kvcache import grow_cache as jax_grow_cache
from repro.serve.loop import generate as jax_generate
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import ssm, zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

ARCH = "falcon_mamba_7b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2
#: prompt lengths: one chunk of 16, and four of 10
LENGTHS = [16, 40]


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    """(JAX config, port config, JAX params, port model)."""
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    params = init_of(jzoo.param_spec(jcfg), jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu",
                              TORCH_DT[dtype])
    return jcfg, tcfg, params, model


def _tokens(cfg, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, scaled=False):
    want = _np(want)
    atol = tol["atol"] * max(1.0, float(np.abs(want).max())) if scaled \
        else tol["atol"]
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"], atol=atol)


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


def test_chunk_len_and_dt_rank_match_jax():
    for chunk in (1, 10, 16, 256):
        for T in (1, 7, 16, 40, 500, 509):
            assert ssm._chunk_len(chunk, T) == jssm._chunk_len(chunk, T)
    assert ssm._chunk_len(16, 40) == 10 and ssm._chunk_len(16, 16) == 16
    for arch in (ARCH,):
        assert ssm.dt_rank(get_config(arch)) == \
            jssm.dt_rank(jax_get_config(arch)) == 256


def test_specs_cache_and_inputs_match_jax():
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    got = L.spec_map(lambda s: (s.shape, s.axes, s.init, str(s.dtype)[6:]),
                     zoo.param_spec(cfg))
    want = JL.spec_map(lambda s: (s.shape, s.axes, s.init,
                                  jnp.dtype(s.dtype).name),
                       jzoo.param_spec(jcfg))
    assert got == want
    assert L.spec_map(lambda s: (s.shape, s.axes, str(s.dtype)[6:]),
                      zoo.cache_spec(cfg, 2, 9)) == JL.spec_map(
        lambda s: (s.shape, s.axes, jnp.dtype(s.dtype).name),
        jzoo.cache_spec(jcfg, 2, 9))
    for name, shape in SHAPES.items():
        assert L.spec_map(lambda s: (s.shape, s.axes),
                          zoo.input_spec(cfg, shape)) == JL.spec_map(
            lambda s: (s.shape, s.axes),
            jzoo.input_spec(jcfg, JAX_SHAPES[name])), name
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()


@pytest.mark.parametrize("N", [8, 16, 256])
def test_init_params_ssm_rules_match_init_of(N):
    """``A_log`` and ``dt_bias`` from ``init_params`` against
    ``init_of``'s: ``dt_bias`` bit for bit; ``A_log`` the correctly
    rounded log of 1..N, which is XLA's CPU log bit for bit except one ulp
    at 7, 47, 49 and 179."""
    cfg = smoke_config(ARCH).replace(ssm_state=N)
    jcfg = jax_smoke_config(ARCH).replace(ssm_state=N)
    got = L.init_params(zoo.param_spec(cfg), torch.Generator().manual_seed(0),
                        "cpu")["layers"]
    want = jax.tree.map(np.asarray, init_of(
        jzoo.param_spec(jcfg), jax.random.PRNGKey(0))["layers"])
    assert got["dt_bias"].dtype == got["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(got["dt_bias"].numpy(), want["dt_bias"])
    assert want["dt_bias"].flat[0] == np.float32(math.log(math.e ** 0.01 - 1))
    a, wa = got["A_log"].numpy(), want["A_log"]
    assert a.shape == wa.shape == (2, 128, N)
    exact = np.array([math.log(i) for i in range(1, N + 1)], np.float32)
    np.testing.assert_array_equal(a, np.broadcast_to(exact, a.shape))
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - wa.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert {i + 1 for i in np.nonzero(ulps[0, 0])[0]} <= {7, 47, 49, 179}
    np.testing.assert_array_equal(got["Dskip"].numpy(), want["Dskip"])


def test_float32_leaves_stay_float32():
    """``params_from_numpy`` in bfloat16 keeps ``dt_bias``, ``A_log`` and
    ``Dskip`` float32, as the JAX package's spec does."""
    _, _, params, model = _setup("bfloat16")
    w = model.layers[1]
    for key in ("dt_bias", "A_log", "Dskip"):
        assert w[key].dtype == torch.float32, key
        np.testing.assert_array_equal(
            w[key].numpy(), np.asarray(params["layers"][key][1]))
    for key in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj", "ln"):
        assert w[key].dtype == torch.bfloat16, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
def test_causal_conv_matches_jax(with_state, dtype):
    rng = np.random.default_rng(7)
    x, w, b, st = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, 11, 24), (24, 4), (24,), (B, 3, 24)))
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    jb, tb = _both(b, dtype)
    jst, tst = _both(st, dtype) if with_state else (None, None)
    want, wstate = jssm._causal_conv(jx, jw, jb, jst)
    got, state = ssm._causal_conv(tx, tw, tb, tst)
    assert got.dtype == TORCH_DT[dtype] and state.shape == (B, 3, 24)
    _close(got, want, TOL[dtype])
    np.testing.assert_array_equal(_np(state), _np(wstate))


def _cache_in(cfg, seed: int):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, cfg.d_conv - 1, cfg.d_inner))
    h = rng.standard_normal((B, cfg.d_inner, cfg.ssm_state))
    return conv.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", LENGTHS)
def test_mamba1_block_matches_jax(T, dtype):
    """Output without a cache, and output and new cache (conv window and
    state) from a random one."""
    jcfg, tcfg, params, model = _setup(dtype)
    x = np.random.default_rng(3).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    w = jax.tree.map(lambda a: a[0], params["layers"])
    want, _ = jssm.mamba1_block(jcfg, w, jx)
    got, none = ssm.mamba1_block(tcfg, model.layers[0], tx)
    assert none is None and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], scaled=True)

    conv, h = _cache_in(jcfg, T)
    jconv, tconv = _both(conv, dtype)
    want, wc = jssm.mamba1_block(jcfg, w, jx,
                                 {"conv": jconv, "h": jnp.asarray(h)})
    got, c = ssm.mamba1_block(tcfg, model.layers[0], tx,
                              {"conv": tconv, "h": torch.from_numpy(h)})
    _close(got, want, TOL[dtype], scaled=True)
    assert c["h"].dtype == torch.float32
    np.testing.assert_array_equal(_np(c["conv"]), _np(wc["conv"]))
    _close(c["h"], wc["h"], TOL[dtype], scaled=True)


def _prefill_both(dtype, toks):
    jcfg, _, params, model = _setup(dtype)
    jcache, jlogits = jzoo.prefill(jcfg, params,
                                   {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tcache, tlogits = model.prefill({"tokens": torch.from_numpy(toks)})
    return jcache, jlogits, tcache, tlogits


def _cache_close(tcache, jcache, dtype):
    assert set(tcache) == set(jcache) == {"conv", "h", "length"}
    for key in ("conv", "h"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], TOL[dtype], scaled=True)
    assert tcache["h"].dtype == torch.float32
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", LENGTHS)
def test_prefill_matches_jax(T, dtype):
    toks = _tokens(_setup(dtype)[0], T)
    jcache, jlogits, tcache, tlogits = _prefill_both(dtype, toks)
    assert tlogits.shape == jlogits.shape and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, TOL[dtype])
    _cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", LENGTHS)
def test_teacher_forced_decode_matches_jax(T, dtype):
    """Four decode steps fed the same tokens; the state cache does not
    grow."""
    jcfg, _, params, model = _setup(dtype)
    toks = _tokens(jcfg, T + 4)
    jcache, _, tcache, _ = _prefill_both(dtype, toks[:, :T])
    jcache = jax_grow_cache(jcache, 4)
    grown = grow_cache(tcache, 4)
    assert grown is tcache
    for i in range(4):
        step = toks[:, T + i:T + i + 1]
        jcache, jlogits = jzoo.decode_step(jcfg, params, jcache,
                                           jnp.asarray(step))
        with torch.inference_mode():
            tcache, tlogits = model.decode_step(tcache,
                                                torch.from_numpy(step))
        _close(tlogits, jlogits, TOL[dtype])
    _cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("T", LENGTHS)
def test_decode_matches_forward(T):
    """The port's own state-cache consistency in float32: teacher-forced
    decode logits equal the full forward's, position by position."""
    _, tcfg, _, model = _setup("float32")
    toks = torch.from_numpy(_tokens(tcfg, T + 4))
    with torch.inference_mode():
        cache, _ = model.prefill({"tokens": toks[:, :T]})
        got = []
        for i in range(4):
            cache, logits = model.decode_step(cache, toks[:, T + i:T + i + 1])
            got.append(logits[:, 0])
        h = model.forward({"tokens": toks})
        want = (h @ model.emb.T).float()
    for i in range(4):
        _close(got[i], want[:, T + i], F32)


def test_forward_matches_jax():
    jcfg, _, params, model = _setup("float32")
    toks = _tokens(jcfg, 40)
    want = jssm.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = model.forward({"tokens": torch.from_numpy(toks)})
    _close(got, want, F32, scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax(dtype):
    """Exact token budgets (0 = prefill only) and cache lengths; greedy
    tokens equal the JAX package's in float32."""
    jcfg, tcfg, params, model = _setup(dtype)
    toks = _tokens(jcfg, 16, seed=5)
    for budget in (0, 1, 4):
        want, winfo = jax_generate(jcfg, params, jnp.asarray(toks),
                                   max_new_tokens=budget)
        got, info = generate(tcfg, model, torch.from_numpy(toks),
                             max_new_tokens=budget)
        assert got.shape == (B, budget) and got.dtype == torch.int32
        assert info["cache_length"] == winfo["cache_length"] == 16 + max(
            budget - 1, 0)
        assert info["logits_finite"]
        assert info["decode_steps"] == max(budget - 1, 0)
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the scan's gradient form (training)
# ---------------------------------------------------------------------------


def _scan_inputs(T, seed, dtype=torch.float32, Bsz=2, Di=6, N=8):
    """dt, Bm, Cm, xs, A, h0 of a scan: dt in softplus's range, A = -1..-N
    per state as ``A_log``'s init gives it, a nonzero start state."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)  # noqa
    dt = torch.nn.functional.softplus(r(Bsz, T, Di) - 1.0)
    A = -torch.arange(1, N + 1, dtype=torch.float64).expand(Di, N) \
        * (1 + 0.1 * r(Di, N).abs())
    return [t.to(dtype) for t in (dt, r(Bsz, T, N), r(Bsz, T, N),
                                  r(Bsz, T, Di), A, r(Bsz, Di, N))]


def _plain_scan(dt, Bm, Cm, xs, A, h):
    """The recurrence step by step, out of place (what autograd
    differentiates as written)."""
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xs[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("T,Q", [(64, 16), (40, 16)],
                         ids=["four_chunks", "short_last_chunk"])
def test_mamba1_scan_grad_form_forward_is_the_serving_scan(T, Q):
    """Where a gradient is recorded the scan is ``_Mamba1Scan``; its
    forward gives the in-place serving form's bits, y and h_T."""
    ins = _scan_inputs(T, 0)
    with torch.no_grad():
        y0, h0 = ssm._mamba1_scan(*ins, Q)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y1, h1 = ssm._mamba1_scan(*leaves, Q)
    assert y1.grad_fn is not None and "Mamba1Scan" in type(
        y1.grad_fn).__name__
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())


@pytest.mark.parametrize("T,Q", [(64, 16), (40, 16)],
                         ids=["four_chunks", "short_last_chunk"])
def test_mamba1_scan_gradients_match_a_float64_plain_scan(T, Q):
    """The gradients of dt, B, C, x, A and h0 (through y and h_T) in
    float32 against autograd of the plain step-by-step scan in float64,
    within ``F32`` (atol relative to each gradient's largest entry); T 40
    leaves a last chunk of 8."""
    ins = _scan_inputs(T, 1)
    g = torch.Generator().manual_seed(2)
    dy = torch.randn(ins[0].shape, generator=g, dtype=torch.float64)
    dh = torch.randn(ins[5].shape, generator=g, dtype=torch.float64)
    want_in = [t.clone().requires_grad_(True) for t in ins]
    y, h = _plain_scan(*want_in)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), want_in)
    got_in = [t.float().requires_grad_(True) for t in ins]
    y, h = ssm._mamba1_scan(*got_in, Q)
    got = torch.autograd.grad((y * dy.float()).sum() + (h * dh.float()).sum(),
                              got_in)
    for name, a, b in zip(("dt", "B", "C", "x", "A", "h0"), got, want):
        assert a.dtype == torch.float32, name
        _close(a.double(), b, F32, scaled=True)


def test_mamba1_scan_keeps_only_chunk_starts():
    """What the scan keeps for the backward is its inputs and the
    (chunks, B, Di, N) starting states: no chunk's (B, Q, Di, N) states or
    decays outlive the forward."""
    Bsz, T, Q, Di, N = 2, 64, 16, 6, 8
    ins = [t.requires_grad_(True) for t in _scan_inputs(T, 3, Bsz=Bsz,
                                                       Di=Di, N=N)]
    kept = []

    def pack(t):
        kept.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, h = ssm._mamba1_scan(*ins, Q)
    chunk_states = Bsz * Q * Di * N
    assert (T // Q, Bsz, Di, N) in kept
    assert max(math.prod(s) for s in kept) < chunk_states
    (y.sum() + h.sum()).backward()
    assert all(t.grad is not None for t in ins)


@pytest.mark.parametrize("remat", ["dots", "nothing"])
def test_mamba1_block_under_remat_matches_no_remat(remat):
    """The scan's Function nested in ``L.remat``'s checkpoint (``"dots"``:
    selective, as falcon_mamba_7b trains; ``"nothing"``: full): the
    gradients of every leaf and of the input equal those without remat."""
    _, tcfg, _, base = _setup("float32")
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 40, tcfg.d_model)).astype(np.float32))
    outs = []
    for policy in (L.remat_policy(remat), None):
        w = {k: v.detach().clone().requires_grad_(True)
             for k, v in base.params["layers"].items()}
        w = {k: v[0] for k, v in w.items()}
        x = x0.clone().requires_grad_(True)
        out = L.remat(lambda ww, xx: ssm.mamba1_block(tcfg, ww, xx)[0],
                      policy, w, x)
        leaves = [x] + [v for v in w.values()]
        outs.append(torch.autograd.grad((out.float() ** 2).sum(), leaves,
                                        allow_unused=True))
    for a, b in zip(*outs):
        if b is None:
            assert a is None
            continue
        _close(a, b, F32, scaled=True)
