"""The port's MoE family (``repro_torch.models.moe``) vs the JAX package's
``repro.models.moe``, on the CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``params_from_numpy``, which keeps the float32 router float32), so
both packages compute the same function on the same prompts.  Cases:
granite_moe_1b_a400m's smoke config (4 experts, top 2); arctic_480b's
(the dense residual branch, ``moe_dense_ff`` 64, through the
``fused_swiglu`` wrapper); granite's at ``capacity_factor`` 0.25, where
routes really drop.  The kernels run through their wrappers, which on CPU
tensors take the plain versions.

Tolerances:

* the dispatch (``route``) is exact: the experts, each route's slot and
  which routes are kept must be equal, ties and overflow included;
  ``top_w`` within ``F32``;
* float32, parameters cast to float32 on both sides: ``F32`` (rtol 1e-4,
  atol 1e-4; for hidden states and caches atol is relative to the
  reference's largest magnitude).  Greedy tokens must be equal;
* bfloat16: ``tests/test_serving.py``'s rtol 0.12, atol 0.25.  The port's
  kernels round in other places than the JAX layers (ROADMAP.md section
  3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.serve.kvcache import grow_cache as jax_grow_cache
from repro.serve.loop import generate as jax_generate
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe, zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.kvcache import grow_cache
from repro_torch.serve.loop import generate

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: (arch, config overrides)
CASES = {
    "granite": ("granite_moe_1b_a400m", {}),
    "arctic": ("arctic_480b", {}),
    "granite_drop": ("granite_moe_1b_a400m", dict(capacity_factor=0.25)),
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
    want = _np(want)
    atol = tol["atol"] * max(1.0, float(np.abs(want).max())) if scaled \
        else tol["atol"]
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"], atol=atol)


def _jax_route(gates: np.ndarray, K: int, C: int):
    """``moe.py:73-85`` on ``gates``, as ``repro.models.moe.moe_block``
    computes it."""
    g = jnp.asarray(gates)
    E = g.shape[-1]
    top_w, top_e = lax.top_k(g, K)
    top_w = top_w / jnp.maximum(jnp.sum(top_w, -1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    keep = pos < C
    return top_w, top_e, keep, jnp.where(keep, pos, C)


def _route_both(gates: np.ndarray, K: int, C: int):
    want = _jax_route(gates, K, C)
    got = moe.route(torch.from_numpy(np.array(gates)), K, C)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got[0], want[0], F32)
    return got


def _tied_gates(rng, n: int, E: int, K: int) -> np.ndarray:
    """Rows of exact ties: all-equal rows (the gates of a zero row after
    ``rms_norm``), and rows where the K-th and (K+1)-th gates are equal,
    the tied pair placed at random experts."""
    rows = [np.full(E, 1.0 / E, np.float32)]
    for _ in range(n - 1):
        vals = np.sort(rng.random(E).astype(np.float32))[::-1].copy()
        vals[K] = vals[K - 1]
        if rng.random() < 0.5:  # a tie across the whole top as well
            vals[:K + 1] = vals[K - 1]
        rows.append(vals[rng.permutation(E)])
    return np.stack(rows)


@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (32, 8)])
@pytest.mark.parametrize("gates", ["random", "ties", "overflow"])
def test_route_matches_jax_exactly(gates, E, K):
    rng = np.random.default_rng(E * 10 + K)
    n = 64
    if gates == "random":
        logits = rng.standard_normal((n, E)).astype(np.float32)
        g = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        C = 8 * (-(-int(np.ceil(n * K * 1.25 / E)) // 8))
    elif gates == "ties":
        g = _tied_gates(rng, n, E, K)
        C = 8 * (-(-int(np.ceil(n * K * 1.25 / E)) // 8))
    else:  # most routes to the first experts, past a small capacity
        logits = rng.standard_normal((n, E)).astype(np.float32)
        logits[:, :K] += 4.0
        g = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        C = 8
    top_w, top_e, keep, slot = _route_both(g, K, C)
    assert top_e.shape == (n, K) and keep.shape == slot.shape == (n * K,)
    if gates == "ties":
        # lax.top_k's order: the lower expert index first among equals
        row = torch.argsort(torch.from_numpy(-g[0]), stable=True)[:K]
        assert top_e[0].tolist() == row.tolist() == list(range(K))
    if gates == "overflow":
        assert int((~keep).sum()) > 0
        assert bool((slot[~keep] == C).all())


def test_route_takes_the_lower_index_on_ties_where_topk_does_not():
    """The example of the gates [.25, .25, .25, .25] with K 2."""
    g = np.full((1, 4), 0.25, np.float32)
    _, top_e, _, _ = _route_both(g, 2, 8)
    assert top_e.tolist() == [[0, 1]]


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "arctic_480b"])
def test_specs_cache_and_inputs_match_jax(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
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
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()


def test_capacity_matches_jax():
    for cf in (0.25, 1.25):
        cfg = get_config("granite_moe_1b_a400m").replace(capacity_factor=cf)
        jcfg = jax_get_config("granite_moe_1b_a400m").replace(
            capacity_factor=cf)
        for n in (1, 4, 32, 2000):
            assert moe.moe_capacity(cfg, n) == jmoe.moe_capacity(jcfg, n)


def test_float32_leaves_stay_float32():
    """``params_from_numpy`` in bfloat16 keeps the router float32, as the
    JAX package's spec does; everything else is bfloat16."""
    _, tcfg, params, model = _setup("arctic", "bfloat16")
    w = model.layers[0]["moe"]
    assert w["router"].dtype == torch.float32
    assert np.asarray(params["layers"]["moe"]["router"]).dtype == np.float32
    np.testing.assert_array_equal(
        w["router"].numpy(), np.asarray(params["layers"]["moe"]["router"][0]))
    assert w["w1"].dtype == w["dense"]["w1"].dtype == torch.bfloat16
    assert model.emb.dtype == torch.bfloat16


def _moe_inputs(case, dtype):
    jcfg, tcfg, params, model = _setup(case, dtype)
    x = np.random.default_rng(3).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    w = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    return (jcfg, w, jnp.asarray(x, jdt)), (
        tcfg, model.layers[0]["moe"], torch.from_numpy(x).to(TORCH_DT[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_jax(case, dtype):
    jargs, targs = _moe_inputs(case, dtype)
    want, waux = jmoe.moe_block(*jargs)
    got, aux = moe.moe_block(*targs)
    assert got.shape == want.shape and got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], scaled=True)
    _close(aux, waux, TOL[dtype])
    tcfg, w, x = targs
    gates = torch.softmax(x.reshape(-1, tcfg.d_model).float() @ w["router"],
                          dim=-1)
    keep = moe.route(gates, tcfg.top_k, moe.moe_capacity(tcfg, B * T))[2]
    assert bool((~keep).any()) == (case == "granite_drop")


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
    jcfg, _, params, model = _setup(case, dtype)
    toks = _tokens(jcfg, T + 4)
    jcache, _, tcache, _ = _prefill_both(case, dtype, toks[:, :T])
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
    for key in ("pos", "length"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    _close(tcache["k"], jcache["k"], TOL[dtype], scaled=True)


@pytest.mark.parametrize("case", ["granite", "arctic"])
def test_decode_matches_forward(case, monkeypatch):
    """The port's own KV-cache consistency in float32, on the cases where
    no route drops: a decode step (capacity for B tokens) and the forward
    (capacity for B * (T + 4)) then compute the same function."""
    _, tcfg, _, model = _setup(case, "float32")
    toks = torch.from_numpy(_tokens(tcfg, T + 4))
    all_kept = []

    def recording_route(*args):
        out = real_route(*args)
        all_kept.append(bool(out[2].all()))
        return out

    real_route = moe.route
    monkeypatch.setattr(moe, "route", recording_route)
    with torch.inference_mode():
        cache, _ = model.prefill({"tokens": toks[:, :T]})
        cache = grow_cache(cache, 4)
        got = []
        for i in range(4):
            cache, logits = model.decode_step(cache, toks[:, T + i:T + i + 1])
            got.append(logits[:, 0])
        h, aux = model.forward({"tokens": toks})
        want = (h @ model.emb.T).float()
    assert len(all_kept) == 6 * tcfg.n_layers and all(all_kept)
    assert aux.shape == () and bool(torch.isfinite(aux))
    for i in range(4):
        _close(got[i], want[:, T + i], F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(case, dtype):
    """Exact token budgets (0 = prefill only) and cache lengths; greedy
    tokens equal the JAX package's in float32."""
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


def test_forward_matches_jax():
    """``forward`` returns (h, aux) as ``repro.models.moe.forward``."""
    jcfg, _, params, model = _setup("granite_drop", "float32")
    toks = _tokens(jcfg, T)
    want, waux = jmoe.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = model.forward({"tokens": torch.from_numpy(toks)})
    _close(got, want, F32, scaled=True)
    _close(aux, waux, F32)
