"""The port's Mamba-2 block and hybrid family (``repro_torch.models.ssm``'s
SSD and ``repro_torch.models.hybrid``) vs the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``params_from_numpy``, which keeps ``dt_bias``, ``A_log`` and
``Dskip`` float32), so both packages compute the same function on the
same prompts.  zamba2_1_2b's smoke config: d_model 64, d_inner 128, 4 SSM
heads of 32, state 8, conv 4, ``ssm_chunk`` 16, the shared block with 4
heads of 16 after every 2 Mamba-2 layers.  Two depths: 2 layers (one
group, no tail) and 3 (one group and a tail layer).  The block at T 16
scans one chunk and at T 40 four (``_chunk_len`` gives 10); the models'
prompts of 16 and 64 scan one chunk and four.  The kernels run through their
wrappers, which on CPU tensors take the plain versions.

Tolerances:

* float32, parameters cast to float32 on both sides: ``F32`` (rtol 1e-4,
  atol 1e-4; for hidden states, conv windows, states and caches atol is
  relative to the reference's largest magnitude).  The two sides differ in
  the order of sums (the projections, the chunk products) and in a few
  ulps of exp; greedy tokens must be equal;
* bfloat16: ``tests/test_serving.py``'s rtol 0.12, atol 0.25.  The port's
  ``rms_norm`` rounds in another place than the JAX layers, the gated norm
  included (ROADMAP.md section 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import hybrid as jhybrid
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.serve.kvcache import grow_cache as jax_grow_cache
from repro.serve.loop import generate as jax_generate
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.models import hybrid, layers as L
from repro_torch.models import ssm, zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

ARCH = "zamba2_1_2b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2
#: block lengths: one chunk of 16, and four of 10
LENGTHS = [16, 40]
#: prompt lengths: one chunk of 16, and four (the JAX attention takes a
#: multiple of the smoke config's ``attn_chunk``, 32, past 32)
PROMPTS = [16, 64]
#: the depths: one group of 2 (no tail), and one group and a tail layer
DEPTHS = [2, 3]
CACHE_KEYS = {"conv", "h", "k", "v", "pos", "length"}


@functools.lru_cache(maxsize=None)
def _setup(dtype: str, n_layers: int = 2):
    """(JAX config, port config, JAX params, port model)."""
    jcfg = jax_smoke_config(ARCH).replace(n_layers=n_layers)
    tcfg = smoke_config(ARCH).replace(n_layers=n_layers)
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


def test_specs_cache_and_inputs_match_jax():
    for n in DEPTHS:
        cfg = smoke_config(ARCH).replace(n_layers=n)
        jcfg = jax_smoke_config(ARCH).replace(n_layers=n)
        got = L.spec_map(lambda s: (s.shape, s.axes, s.init,
                                    str(s.dtype)[6:]), zoo.param_spec(cfg))
        want = JL.spec_map(lambda s: (s.shape, s.axes, s.init,
                                      jnp.dtype(s.dtype).name),
                           jzoo.param_spec(jcfg))
        assert got == want
        assert L.spec_map(lambda s: (s.shape, s.axes, str(s.dtype)[6:]),
                          zoo.cache_spec(cfg, 2, 9)) == JL.spec_map(
            lambda s: (s.shape, s.axes, jnp.dtype(s.dtype).name),
            jzoo.cache_spec(jcfg, 2, 9))
        assert hybrid.n_groups(cfg) == jhybrid.n_groups(jcfg) == (1, n - 2)
    for name, shape in SHAPES.items():
        assert L.spec_map(lambda s: (s.shape, s.axes),
                          zoo.input_spec(cfg, shape)) == JL.spec_map(
            lambda s: (s.shape, s.axes),
            jzoo.input_spec(jcfg, JAX_SHAPES[name])), name
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert hybrid.n_groups(full) == jhybrid.n_groups(jfull) == (6, 2)
    assert ssm._chunk_len(full.ssm_chunk, 500) == 250


def test_float32_leaves_stay_float32():
    """``params_from_numpy`` in bfloat16 keeps ``dt_bias``, ``A_log`` and
    ``Dskip`` float32, as the JAX package's spec does; the shared block is
    one unstacked set of weights."""
    _, _, params, model = _setup("bfloat16")
    w = model.mamba[1]
    for key in ("dt_bias", "A_log", "Dskip"):
        assert w[key].dtype == torch.float32, key
        np.testing.assert_array_equal(
            w[key].numpy(), np.asarray(params["mamba"][key][1]))
    for key in ("wz", "wx", "wB", "wC", "wdt", "conv_w", "norm", "out_proj"):
        assert w[key].dtype == torch.bfloat16, key
    assert model.shared["attn"]["wq"].shape == (64, 64)
    np.testing.assert_array_equal(
        model.shared["mlp"]["w1"].float().numpy(),
        np.asarray(params["shared"]["mlp"]["w1"], np.float32))


def _state_in(cfg, seed: int):
    rng = np.random.default_rng(seed)
    P = cfg.d_inner // cfg.n_ssm_heads
    conv = rng.standard_normal((B, cfg.d_conv - 1, cfg.d_inner))
    h = rng.standard_normal((B, cfg.n_ssm_heads, P, cfg.ssm_state))
    return conv.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", LENGTHS)
def test_mamba2_block_matches_jax(T, dtype):
    """Output without a cache, and output and new cache (conv window and
    state) from a random one."""
    jcfg, tcfg, params, model = _setup(dtype)
    x = np.random.default_rng(3).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    w = jax.tree.map(lambda a: a[0], params["mamba"])
    want, _ = jssm.mamba2_block(jcfg, w, jx)
    got, none = ssm.mamba2_block(tcfg, model.mamba[0], tx)
    assert none is None and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], scaled=True)

    conv, h = _state_in(jcfg, T)
    jconv, tconv = _both(conv, dtype)
    want, wc = jssm.mamba2_block(jcfg, w, jx,
                                 {"conv": jconv, "h": jnp.asarray(h)})
    got, c = ssm.mamba2_block(tcfg, model.mamba[0], tx,
                              {"conv": tconv, "h": torch.from_numpy(h)})
    _close(got, want, TOL[dtype], scaled=True)
    assert c["h"].dtype == torch.float32
    np.testing.assert_array_equal(_np(c["conv"]), _np(wc["conv"]))
    _close(c["h"], wc["h"], TOL[dtype], scaled=True)


def _recurrence(la, Bm, Cm, xh, h):
    """The SSD's recurrence step by step in float64: h_t = exp(la_t) h_{t-1}
    + x_t B_t^T, y_t = h_t C_t (heads first, as ``_ssd`` takes them)."""
    la, Bm, Cm, xh, h = (t.double() for t in (la, Bm, Cm, xh, h))
    ys = []
    for t in range(la.shape[-1]):
        h = la[..., t].exp()[..., None, None] * h \
            + xh[:, :, t, :, None] * Bm[:, None, t, None, :]
        ys.append(h @ Cm[:, None, t, :, None])
    return torch.cat(ys, dim=-1).transpose(-1, -2), h


@pytest.mark.parametrize("decay", ["gentle", "steep", "mixed"])
def test_ssd_matches_the_recurrence(decay):
    """``_ssd`` over three chunks of 16 with a carried state against the
    recurrence it computes.  A steep decay (-30 to -60 a step) makes exp
    above each chunk's diagonal overflow float32: the masked entries must
    be zero, not ``inf * 0``.  A mixed one (a step of -5000 at the start
    of each chunk, gentle steps after it, as zamba2's widths give) puts
    the chunk's prefix sums near -5000, where ``cum_t - cum_s`` would
    lose the gentle decays' last digits."""
    rng = np.random.default_rng(9)
    Bsz, H, T, P, N = 2, 3, 48, 5, 4
    lo, hi = (-60.0, -30.0) if decay == "steep" else (-0.5, 0.0)
    la = rng.uniform(lo, hi, (Bsz, H, T)).astype(np.float32)
    if decay == "mixed":
        la[..., ::16] = -5000.0
    la = torch.from_numpy(la)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((Bsz, T, N)).astype(
        np.float32)) for _ in range(2))
    xh = torch.from_numpy(rng.standard_normal((Bsz, H, T, P)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((Bsz, H, P, N)).astype(
        np.float32))
    y, h = ssm._ssd(la, Bm, Cm, xh, h0, 16)
    want_y, want_h = _recurrence(la, Bm, Cm, xh, h0)
    assert y.shape == (Bsz, H, T, P) and h.shape == h0.shape
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    _close(y, want_y, F32, scaled=True)
    _close(h, want_h, F32, scaled=True)


def _prefill_both(dtype, n_layers, toks):
    jcfg, _, params, model = _setup(dtype, n_layers)
    jcache, jlogits = jzoo.prefill(jcfg, params,
                                   {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tcache, tlogits = model.prefill({"tokens": torch.from_numpy(toks)})
    return jcache, jlogits, tcache, tlogits


def _cache_close(tcache, jcache, dtype):
    assert set(tcache) == set(jcache) == CACHE_KEYS
    for key in ("conv", "h", "k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], TOL[dtype], scaled=True)
    assert tcache["h"].dtype == torch.float32
    for key in ("pos", "length"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", PROMPTS)
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_prefill_matches_jax(n_layers, T, dtype):
    toks = _tokens(_setup(dtype, n_layers)[0], T)
    jcache, jlogits, tcache, tlogits = _prefill_both(dtype, n_layers, toks)
    assert tlogits.shape == jlogits.shape and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, TOL[dtype])
    _cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_teacher_forced_decode_matches_jax(n_layers, dtype):
    """Four decode steps on the grown cache, fed the same tokens: the
    sites' k/v and ``pos`` grow, the conv windows and states do not."""
    jcfg, _, params, model = _setup(dtype, n_layers)
    T = 64
    toks = _tokens(jcfg, T + 4)
    jcache, _, tcache, _ = _prefill_both(dtype, n_layers, toks[:, :T])
    jcache = jax_grow_cache(jcache, 4)
    tcache = grow_cache(tcache, 4)
    for i in range(4):
        step = toks[:, T + i:T + i + 1]
        jcache, jlogits = jzoo.decode_step(jcfg, params, jcache,
                                           jnp.asarray(step))
        with torch.inference_mode():
            tcache, tlogits = model.decode_step(tcache,
                                                torch.from_numpy(step))
        _close(tlogits, jlogits, TOL[dtype])
    assert tcache["k"].shape[2] == T + 4 and tcache["conv"].shape[2] == 3
    _cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_decode_matches_forward(n_layers):
    """The port's own cache consistency in float32: teacher-forced decode
    logits equal the full forward's, position by position."""
    _, tcfg, _, model = _setup("float32", n_layers)
    T = 64
    toks = torch.from_numpy(_tokens(tcfg, T + 4))
    with torch.inference_mode():
        cache, _ = model.prefill({"tokens": toks[:, :T]})
        cache = grow_cache(cache, 4)
        got = []
        for i in range(4):
            cache, logits = model.decode_step(cache, toks[:, T + i:T + i + 1])
            got.append(logits[:, 0])
        h = model.forward({"tokens": toks})
        want = (h @ model.emb.T).float()
    for i in range(4):
        _close(got[i], want[:, T + i], F32)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_forward_matches_jax(n_layers):
    jcfg, _, params, model = _setup("float32", n_layers)
    toks = _tokens(jcfg, 64)
    want = jhybrid.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = model.forward({"tokens": torch.from_numpy(toks)})
    _close(got, want, F32, scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax(dtype):
    """Exact token budgets (0 = prefill only) and cache lengths; greedy
    tokens equal the JAX package's in float32."""
    jcfg, tcfg, params, model = _setup(dtype, 3)
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
