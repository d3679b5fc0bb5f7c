"""The port's dense-LM serving path vs the JAX package, on the CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``repro_torch.models.convert.params_from_numpy``), so both packages
compute the same function on the same prompts.  The smoke configs of
llama3_2_3b, h2o_danube_3_4b (sliding window 8, which wraps the ring
cache, and 32, which does not) and qwen3_14b (qk-norm) carry the branches;
qwen2_vl_72b carries M-RoPE; stablelm_12b's smoke config at head dims 160
(the full config's) and 256 carries the widest heads the attention kernel
takes.  The kernels run through their wrappers,
which on CPU tensors take the plain versions.

Tolerances:

* float32, parameters cast to float32 on both sides: ``F32`` (rtol 1e-4,
  atol 1e-4; for hidden states and caches atol is relative to the
  reference's largest magnitude).  The two sides differ only in the order
  of sums and in a few ulps of pow/cos/sin; measured logit differences are
  below 1e-5 at logit magnitudes near 2.  Greedy tokens must be equal.
* bfloat16: ``tests/test_serving.py``'s rtol 0.12, atol 0.25.  The port
  computes the kernels' function, which rounds in other places than the
  JAX layers (ROADMAP.md section 3); measured logit differences are below
  0.05.
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
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.serve.kvcache import grow_cache as jax_grow_cache
from repro.serve.loop import generate as jax_generate
from repro_torch.configs import (PORTED_ARCH_IDS, SHAPES, get_config,
                                 smoke_config)
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.models.convert import params_from_numpy, tree_from_numpy
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: (arch, config overrides): the dense branches the slice serves
CASES = {
    "llama": ("llama3_2_3b", {}),
    "danube_w8": ("h2o_danube_3_4b", dict(sliding_window=8)),
    "danube_w32": ("h2o_danube_3_4b", {}),
    "qwen3_qknorm": ("qwen3_14b", {}),
    "stablelm_hd160": ("stablelm_12b", dict(head_dim=160)),
    "stablelm_hd256": ("stablelm_12b", dict(head_dim=256)),
}
B, T = 2, 16


@functools.lru_cache(maxsize=None)
def _setup(case: str, dtype: str):
    """(JAX config, port config, JAX params, port model) for one case."""
    arch, kw = CASES[case]
    jcfg = jax_smoke_config(arch).replace(**kw)
    tcfg = smoke_config(arch).replace(**kw)
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
    """``assert_allclose`` under ``tol``; ``scaled`` multiplies atol by the
    reference's largest magnitude (for hidden states and caches, whose
    entries reach ~100 with the smoke configs' weights, so an entry near
    zero carries the rounding of its large neighbours)."""
    want = _np(want)
    atol = tol["atol"] * max(1.0, float(np.abs(want).max())) if scaled \
        else tol["atol"]
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


def test_specs_and_input_specs_match_jax():
    cfg, jcfg = smoke_config("qwen3_14b"), jax_smoke_config("qwen3_14b")
    got = L.spec_map(lambda s: (s.shape, s.axes, s.init),
                     zoo.param_spec(cfg))
    want = JL.spec_map(lambda s: (s.shape, s.axes, s.init),
                       jzoo.param_spec(jcfg))
    assert got == want
    assert L.axes_of(zoo.param_spec(cfg)) == JL.axes_of(jzoo.param_spec(jcfg))
    metas = L.shapes_of(zoo.param_spec(cfg))
    assert metas["layers"]["mlp"]["w1"].device.type == "meta"
    assert L.spec_map(lambda s: s.shape, zoo.param_spec(cfg)) == \
        jax.tree.map(lambda t: tuple(t.shape), metas)
    assert L.spec_map(lambda s: s.shape, zoo.cache_spec(cfg, 2, 9)) == \
        JL.spec_map(lambda s: s.shape, jzoo.cache_spec(jcfg, 2, 9))
    for arch in ("llama3_2_3b", "qwen2_vl_72b", "zamba2_1_2b",
                 "whisper_tiny"):
        for name, shape in SHAPES.items():  # train, prefill and decode
            got = L.spec_map(lambda s: (s.shape, s.axes),
                             zoo.input_spec(smoke_config(arch), shape))
            want = JL.spec_map(lambda s: (s.shape, s.axes), jzoo.input_spec(
                jax_smoke_config(arch), JAX_SHAPES[name]))
            assert got == want, (arch, name)


@pytest.mark.parametrize("B", [1, 2])
def test_banded_attention_hands_the_kernel_contiguous_heads(B, monkeypatch):
    """The flash kernel takes contiguous (B * H, T, hd) operands; at batch 1
    the heads-first reshape of (1, T, H, hd) is a strided view, which the
    card's wrapper refuses (h2o_danube_3_4b's batch-1 prefill past its
    window raised ``q must be contiguous`` there)."""
    seen = []
    real = L.flash_attention

    def check(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(L, "flash_attention", check)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, 24, 4, 16), generator=g)
    k, v = (torch.randn((B, 24, 2, 16), generator=g) for _ in range(2))
    out = L.banded_attention(q, k, v, causal=True, window=8)
    assert seen == [True]
    torch.testing.assert_close(out, L.naive_attention(q, k, v, window=8),
                               **F32)


def test_unported_families_raise():
    """Every family of the JAX zoo is ported; an unknown family or arch id
    still raises."""
    with pytest.raises(NotImplementedError, match="not a ported family"):
        zoo.param_spec(smoke_config("llama3_2_3b").replace(family="nope"))
    with pytest.raises(NotImplementedError, match="not a ported arch"):
        get_config("nope")
    assert sorted(zoo.FAMILY_MODULES) == ["dense", "encdec", "hybrid", "moe",
                                          "ssm", "vlm"]


def test_init_params_follows_init_of_rules():
    cfg = smoke_config("qwen3_14b")
    gen = torch.Generator().manual_seed(0)
    tree = L.init_params(zoo.param_spec(cfg), gen, "cpu")
    wq = tree["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 64)
    # normal / sqrt(shape[0]): the stacked layer count, as in init_of
    assert 0.5 < float(wq.float().std() * np.sqrt(2)) < 1.5
    assert torch.equal(tree["layers"]["attn"]["q_norm"],
                       torch.ones(2, 16, dtype=torch.bfloat16))
    again = L.init_params(zoo.param_spec(cfg),
                          torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["emb"], tree["emb"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(s, jdt))
    got = L.rms_norm(torch.from_numpy(x).to(TORCH_DT[dtype]),
                     torch.from_numpy(s).to(TORCH_DT[dtype]))
    assert got.shape == x.shape and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("sections", [None, (6, 1, 1)],
                         ids=["rope", "m_rope"])
def test_apply_rope_matches_jax(sections):
    """Positions up to 531 (a 500-token prompt plus 31 decode steps):
    ``theta ** (-i / half)``, cos and sin differ from XLA's by a few ulps,
    which ``F32`` covers."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 532, (2, 3, 9) if sections else (2, 9)
                       ).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0,
                         sections)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0,
                       sections)
    _close(got, want, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8], ids=["causal", "window8"])
@pytest.mark.parametrize("hd", [16, 160, 256])
def test_banded_attention_matches_jax(hd, window, dtype):
    """``banded_attention`` (through the flash_attention wrapper, plain on
    the CPU) against ``repro.models.layers.banded_attention`` at head dims
    up to 256, 4 query heads over 2 kv heads."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((B, T, h, hd)).astype(np.float32)
               for h in (4, 2, 2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JL.banded_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               causal=True, window=window)
    got = L.banded_attention(*(torch.from_numpy(a).to(TORCH_DT[dtype])
                               for a in (q, k, v)),
                             causal=True, window=window)
    assert got.shape == (B, T, 4, hd) and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_layer_matches_jax(case, dtype):
    jcfg, tcfg, params, model = _setup(case, dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    w = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, (wk, wv) = JL.attention_layer(jcfg, w, jnp.asarray(x, jdt),
                                        jnp.asarray(pos))
    got, (gk, gv) = L.attention_layer(
        tcfg, model.layers[0]["attn"], torch.from_numpy(x).to(
            TORCH_DT[dtype]), torch.from_numpy(pos.copy()))
    for g, wnt in ((got, want), (gk, wk), (gv, wv)):
        _close(g, wnt, TOL[dtype], scaled=True)


def _prefill_both(case, dtype, toks):
    jcfg, _, params, model = _setup(case, dtype)
    jcache, jlogits = jzoo.prefill(jcfg, params,
                                   {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tcache, tlogits = model.prefill({"tokens": torch.from_numpy(toks)})
    return jcache, jlogits, tcache, tlogits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_matches_jax(case, dtype):
    toks = _tokens(_setup(case, dtype)[0], T)
    jcache, jlogits, tcache, tlogits = _prefill_both(case, dtype, toks)
    assert tlogits.shape == jlogits.shape and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, TOL[dtype])
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        _close(tcache[key], jcache[key], TOL[dtype], scaled=True)
    for key in ("pos", "length"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_decode_matches_jax(case, dtype):
    """Four decode steps on the grown cache, fed the same tokens."""
    jcfg, tcfg, params, model = _setup(case, dtype)
    toks = _tokens(jcfg, T + 4)
    jcache, _, tcache, _ = _prefill_both(case, dtype, toks[:, :T])
    jcache = jax_grow_cache(jcache, 4, window=jcfg.sliding_window)
    tcache = grow_cache(tcache, 4, window=tcfg.sliding_window)
    for i in range(4):
        step = toks[:, T + i:T + i + 1]
        jcache, jlogits = jzoo.decode_step(jcfg, params, jcache,
                                           jnp.asarray(step))
        with torch.inference_mode():
            tcache, tlogits = model.decode_step(tcache,
                                                torch.from_numpy(step))
        _close(tlogits, jlogits, TOL[dtype])
    for key in ("pos", "length"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    _close(tcache["k"], jcache["k"], TOL[dtype], scaled=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_forward(case):
    """The port's own KV-cache consistency (``tests/test_serving.py``):
    teacher-forced decode logits equal the full forward's, position by
    position, in float32."""
    _, tcfg, _, model = _setup(case, "float32")
    toks = torch.from_numpy(_tokens(tcfg, T + 4))
    with torch.inference_mode():
        cache, _ = model.prefill({"tokens": toks[:, :T]})
        cache = grow_cache(cache, 4, window=tcfg.sliding_window)
        got = []
        for i in range(4):
            cache, logits = model.decode_step(cache, toks[:, T + i:T + i + 1])
            got.append(logits[:, 0])
        h = model.forward({"tokens": toks})
        want = (h @ model.emb.T).float()
    for i in range(4):
        _close(got[i], want[:, T + i], F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["llama", "danube_w8"])
def test_generate_matches_jax(case, dtype):
    """Exact token budgets (0 = prefill only); greedy tokens equal the JAX
    package's in float32."""
    jcfg, tcfg, params, model = _setup(case, dtype)
    toks = _tokens(jcfg, T, seed=5)
    for budget in (0, 1, 4):
        want, winfo = jax_generate(jcfg, params, jnp.asarray(toks),
                                   max_new_tokens=budget)
        got, info = generate(tcfg, model, torch.from_numpy(toks),
                             max_new_tokens=budget)
        assert got.shape == (B, budget) and got.dtype == torch.int32
        assert info["cache_length"] == winfo["cache_length"]
        assert info["logits_finite"]
        assert info["decode_steps"] == max(budget - 1, 0)
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vlm_prefill_matches_jax():
    """qwen2_vl_72b's smoke config: embeddings in, 3-axis M-RoPE ids."""
    jcfg = jax_smoke_config("qwen2_vl_72b")
    tcfg = smoke_config("qwen2_vl_72b")
    params = jax.tree.map(lambda a: a.astype(jnp.float32), init_of(
        jzoo.param_spec(jcfg), jax.random.PRNGKey(0)))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu",
                              torch.float32)
    rng = np.random.default_rng(4)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    batch = {"tokens": _tokens(jcfg, T),
             "embeds": rng.standard_normal(
                 (B, T, jcfg.d_model)).astype(np.float32),
             "positions": np.stack([pos, pos // 2, pos % 4], axis=1)}
    jcache, jlogits = jzoo.prefill(jcfg, params, jax.tree.map(jnp.asarray,
                                                              batch))
    with torch.inference_mode():
        tcache, tlogits = model.prefill(tree_from_numpy(batch, "cpu"))
        tcache = grow_cache(tcache, 1)
        _, tstep = model.decode_step(tcache,
                                     torch.from_numpy(batch["tokens"][:, :1]))
    _close(tlogits, jlogits, F32)
    _close(tcache["k"][:, :, :T], jcache["k"], F32, scaled=True)
    jcache = jax_grow_cache(jcache, 1)
    _, jstep = jzoo.decode_step(jcfg, params, jcache,
                                jnp.asarray(batch["tokens"][:, :1]))
    _close(tstep, jstep, F32)
