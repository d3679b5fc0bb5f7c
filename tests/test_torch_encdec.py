"""The port's encoder-decoder family (``repro_torch.models.encdec``) and the
cross-attention branch of ``attention_layer`` vs the JAX package's, on the
CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``params_from_numpy``), so both packages compute the same function
on the same prompts and audio-frame embeddings.  whisper_tiny's smoke
config: 2 encoder and 2 decoder layers, d_model 64, 4 query heads over 2
kv heads of 16, ``enc_seq`` 16.  The kernels run through their wrappers,
which on CPU tensors take the plain versions.

Tolerances:

* float32, parameters cast to float32 on both sides: ``F32`` (rtol 1e-4,
  atol 1e-4; for hidden states and caches atol is relative to the
  reference's largest magnitude).  The two sides differ in the order of
  sums and in a few ulps of pow/cos/sin/exp; greedy tokens must be equal;
* bfloat16: ``tests/test_serving.py``'s rtol 0.12, atol 0.25.  The port's
  ``rms_norm`` rounds in another place than the JAX layers (ROADMAP.md
  section 3).  The teacher-forced decode is held in float32 only:
  ``init_of`` divides a stacked weight by the square root of its layer
  count (2 here), so the smoke residual stream reaches ~800 and each
  side's bfloat16 decode logits are 0.3 to 1.8 from its own float32 run
  (measured, both packages alike); the two sides' bfloat16 logits then
  differ by up to 0.46 at a step, which says nothing about the port.
  Prefill, encode, the cross-attention layer and ``generate`` are held in
  bfloat16 as well.
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
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.serve.kvcache import grow_cache as jax_grow_cache
from repro.serve.loop import generate as jax_generate
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.models.convert import params_from_numpy, tree_from_numpy
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

ARCH = "whisper_tiny"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2
#: prompt lengths (the JAX decoder attention takes a multiple of the smoke
#: config's ``attn_chunk``, 32, past 32)
PROMPTS = [16, 64]
CACHE_KEYS = {"k", "v", "xk", "xv", "pos", "length"}


@functools.lru_cache(maxsize=None)
def _setup(dtype: str, qk_norm: bool = False):
    """(JAX config, port config, JAX params, port model)."""
    jcfg = jax_smoke_config(ARCH).replace(qk_norm=qk_norm)
    tcfg = smoke_config(ARCH).replace(qk_norm=qk_norm)
    params = init_of(jzoo.param_spec(jcfg), jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu",
                              TORCH_DT[dtype])
    return jcfg, tcfg, params, model


def _batch(cfg, n: int, seed: int = 0) -> dict:
    """Tokens (B, n) and audio-frame embeddings (B, enc_seq, d_model)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
                np.int32),
            "audio_embeds": rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def _jax_batch(batch: dict, dtype: str) -> dict:
    return {"tokens": jnp.asarray(batch["tokens"]),
            "audio_embeds": jnp.asarray(batch["audio_embeds"],
                                        JAX_DT[dtype])}


def _torch_batch(batch: dict, dtype: str) -> dict:
    out = tree_from_numpy(batch, "cpu")
    out["audio_embeds"] = out["audio_embeds"].to(TORCH_DT[dtype])
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, scaled=False):
    want = _np(want)
    atol = tol["atol"] * max(1.0, float(np.abs(want).max())) if scaled \
        else tol["atol"]
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"], atol=atol)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_cross_attention_layer_matches_jax(qk_norm, dtype):
    """``attention_layer`` with ``cross_x``: q from 24 decoder positions
    (RoPE, qk-norm where configured), k/v from 16 encoder states (no RoPE),
    non-causal; the output and the cross k/v."""
    jcfg, tcfg, params, model = _setup(dtype, qk_norm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 24, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 16, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (B, 24))
    w = jax.tree.map(lambda a: a[0], params["decoder"]["cross_attn"])
    jdt = JAX_DT[dtype]
    want, (wk, wv) = JL.attention_layer(
        jcfg, w, jnp.asarray(x, jdt), jnp.asarray(pos),
        cross_x=jnp.asarray(enc, jdt))
    got, (gk, gv) = L.attention_layer(
        tcfg, model.decoder[0]["cross_attn"],
        torch.from_numpy(x).to(TORCH_DT[dtype]),
        torch.from_numpy(pos.copy()),
        cross_x=torch.from_numpy(enc).to(TORCH_DT[dtype]))
    assert got.shape == (B, 24, jcfg.d_model)
    assert gk.shape == gv.shape == (B, 16, jcfg.n_kv_heads, 16)
    for g, wnt in ((got, want), (gk, wk), (gv, wv)):
        _close(g, wnt, TOL[dtype], scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, _, params, model = _setup(dtype)
    batch = _batch(jcfg, 16)
    want = jencdec.encode(jcfg, params,
                          _jax_batch(batch, dtype)["audio_embeds"])
    with torch.inference_mode():
        got = model.encode(_torch_batch(batch, dtype)["audio_embeds"])
    assert got.shape == want.shape and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], scaled=True)


def _prefill_both(dtype, batch):
    jcfg, _, params, model = _setup(dtype)
    jcache, jlogits = jzoo.prefill(jcfg, params, _jax_batch(batch, dtype))
    with torch.inference_mode():
        tcache, tlogits = model.prefill(_torch_batch(batch, dtype))
    return jcache, jlogits, tcache, tlogits


def _cache_close(tcache, jcache, dtype):
    assert set(tcache) == set(jcache) == CACHE_KEYS
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], TOL[dtype], scaled=True)
    for key in ("pos", "length"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", PROMPTS)
def test_prefill_matches_jax(T, dtype):
    batch = _batch(_setup(dtype)[0], T)
    jcache, jlogits, tcache, tlogits = _prefill_both(dtype, batch)
    assert tlogits.shape == jlogits.shape and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, TOL[dtype])
    _cache_close(tcache, jcache, dtype)


def test_teacher_forced_decode_matches_jax():
    """Four decode steps on the grown cache, fed the same tokens, in
    float32: the self k/v and ``pos`` grow, the encoder's ``xk``/``xv`` do
    not."""
    dtype = "float32"
    jcfg, _, params, model = _setup(dtype)
    T = 16
    batch = _batch(jcfg, T + 4)
    toks = batch["tokens"]
    jcache, _, tcache, _ = _prefill_both(
        dtype, dict(batch, tokens=toks[:, :T]))
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
    assert tcache["k"].shape[2] == T + 4
    assert tcache["xk"].shape[2] == jcfg.enc_seq
    _cache_close(tcache, jcache, dtype)


def test_decode_matches_forward():
    """The port's own cache consistency in float32: teacher-forced decode
    logits equal the full forward's, position by position."""
    _, tcfg, _, model = _setup("float32")
    T = 16
    batch = _torch_batch(_batch(tcfg, T + 4), "float32")
    toks = batch["tokens"]
    with torch.inference_mode():
        cache, _ = model.prefill(dict(batch, tokens=toks[:, :T]))
        cache = grow_cache(cache, 4)
        got = []
        for i in range(4):
            cache, logits = model.decode_step(cache, toks[:, T + i:T + i + 1])
            got.append(logits[:, 0])
        h = model.forward(batch)
        want = (h @ model.emb.T).float()
    for i in range(4):
        _close(got[i], want[:, T + i], F32)


def test_forward_matches_jax():
    jcfg, _, params, model = _setup("float32")
    batch = _batch(jcfg, 64)
    want = jencdec.forward(jcfg, params, _jax_batch(batch, "float32"))
    with torch.inference_mode():
        got = model.forward(_torch_batch(batch, "float32"))
    _close(got, want, F32, scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax(dtype):
    """Exact token budgets (0 = prefill only) and cache lengths, the audio
    as ``extra_batch``; greedy tokens equal the JAX package's in
    float32."""
    jcfg, tcfg, params, model = _setup(dtype)
    batch = _batch(jcfg, 16, seed=5)
    toks = batch["tokens"]
    for budget in (0, 1, 4):
        want, winfo = jax_generate(
            jcfg, params, jnp.asarray(toks), max_new_tokens=budget,
            extra_batch={"audio_embeds": _jax_batch(batch, dtype)[
                "audio_embeds"]})
        got, info = generate(
            tcfg, model, torch.from_numpy(toks), max_new_tokens=budget,
            extra_batch={"audio_embeds": _torch_batch(batch, dtype)[
                "audio_embeds"]})
        assert got.shape == (B, budget) and got.dtype == torch.int32
        assert info["cache_length"] == winfo["cache_length"] == 16 + max(
            budget - 1, 0)
        assert info["logits_finite"]
        assert info["decode_steps"] == max(budget - 1, 0)
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
