"""The port's training path vs the JAX package, on the CPU.

Parameters come from the JAX package's ``init_of`` and cross over through
numpy (``repro_torch.models.convert.params_from_numpy``); inputs are drawn
with numpy and handed to both.  On CPU tensors the kernels' wrappers take
their plain versions, which autograd differentiates.

Tolerances: ``F32`` (rtol 1e-4, atol 1e-4) for every float32 value and
gradient, where the two packages differ only in the order of sums and in a
few ulps of exp/log/pow/cos; one bfloat16 ulp (``BF16_ULP``, rtol 2**-7)
for bfloat16 optimizer state, which is float32 math cast once on both
sides, so a float32 difference of one ulp can round to neighbouring bf16
values; the quantizers and the data bitwise.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, strategies as st

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.parallel import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import PORTED_ARCH_IDS, RunConfig, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as tsteps
from repro_torch.train.data import Prefetcher, batch_for_step
from repro_torch.train.loop import batch_to, train
from repro_torch.train.tree import items

F32 = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)
SHAPE = ShapeSpec("smoke", 32, 2, "train")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_tree_items(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _jax_tree_items(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key]


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 24, 512], ids=["divides", "pads",
                                                      "one_chunk"])
def test_chunked_xent_value_and_grad_match_jax(chunk):
    rng = np.random.default_rng(0)
    B, T, D, V = 2, 32, 16, 50
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    want, (jdh, jde) = jax.value_and_grad(
        lambda a, b: JL.chunked_xent(a, b, jnp.asarray(y), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    got = L.chunked_xent(th, te, torch.from_numpy(y), chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **F32)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jdh), **F32)
    np.testing.assert_allclose(_np(te.grad), np.asarray(jde), **F32)


def test_chunked_xent_keeps_one_chunk_of_logits():
    """Each chunk runs under its own checkpoint: what the graph keeps for
    the backward is the chunks' inputs, never a (chunk, V) logits block."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((1, 64, 8)).astype(
        np.float32)).requires_grad_(True)
    emb = torch.from_numpy(rng.standard_normal((1000, 8)).astype(
        np.float32)).requires_grad_(True)
    y = torch.from_numpy(rng.integers(0, 1000, (1, 64)))
    kept = []

    def pack(t):
        kept.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = L.chunked_xent(h, emb, y, 16)
    assert max(kept) < 16 * 1000  # no logits block outlives its chunk
    loss.backward()
    assert h.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------


def _counted(monkeypatch):
    counts = {"rmsnorm": 0, "fused_swiglu": 0, "flash_attention": 0}
    for name in counts:
        real = getattr(ref, name)

        def wrapped(*a, _name=name, _real=real, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ref, name, wrapped)
    return counts


@pytest.mark.parametrize("remat,recomputed", [("dots", True),
                                              ("nothing", True),
                                              ("full", False)])
def test_remat_policy_recomputes_each_kernel(monkeypatch, remat, recomputed):
    """One train step's calls of each kernel's function: a forward (2 norms
    a layer and ln_f, one gate and one attention a layer), and under both
    wrapping policies a recompute of every layer's in the backward (a
    kernel is not an aten product, so ``"dots"`` does not keep it)."""
    cfg = smoke_config("llama3_2_3b").replace(remat=remat)
    gen = torch.Generator().manual_seed(0)
    model = zoo.init_model(cfg, gen, "cpu", torch.float32)
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    counts = _counted(monkeypatch)
    tsteps.value_and_grad(cfg, model, batch)
    Ln = cfg.n_layers
    extra = Ln if recomputed else 0
    assert counts == {"rmsnorm": 2 * Ln + 1 + 2 * extra,
                      "fused_swiglu": Ln + extra,
                      "flash_attention": Ln + extra}


def test_dots_policy_keeps_the_products():
    policy = L.remat_policy("dots")
    assert L.remat_policy("full") is None
    assert L.remat_policy("nothing") is torch.utils.checkpoint.noop_context_fn
    assert L._save_dots(None, torch.ops.aten.mm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert L._save_dots(None, torch.ops.aten.bmm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    assert callable(policy)


# ---------------------------------------------------------------------------
# loss_fn and every gradient leaf
# ---------------------------------------------------------------------------

#: case -> (arch, config overrides, fan-in scale): each family, and the
#: branches of each.  The families added after the dense ones hold at the
#: fan-in scale (``_fan_in_scaled``)
LOSS_CASES = {
    "llama": ("llama3_2_3b", {}, False),
    "danube_window": ("h2o_danube_3_4b", {}, False),
    "vlm": ("qwen2_vl_72b", {}, False),
    "moe": ("granite_moe_1b_a400m", {}, True),
    "moe_dense_branch": ("arctic_480b", {}, True),
    "ssm": ("falcon_mamba_7b", {}, True),
    "hybrid": ("zamba2_1_2b", {}, True),
    "hybrid_tail": ("zamba2_1_2b", dict(n_layers=3), True),
    "encdec": ("whisper_tiny", {}, True),
}


def _fan_in_scaled(spec, params):
    """``params`` with each normal weight stacked over layers rescaled
    from ``init_of``'s N(0, 1 / n_layers) to N(0, 1 / fan-in) (its second
    axis).  At smoke width ``init_of``'s stacked scale (a 64-wide
    projection of std 1 / sqrt(2)) makes the float32 gradient of the JAX
    package itself miss its float64 gradient by 2e-4 to 6e-4 of each
    leaf's largest entry for granite, zamba2 and whisper (the port's
    misses by as much), so ``F32`` cannot tell the two packages apart
    there; at the fan-in scale both agree to under 0.04 of ``F32``."""
    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(s[k], a[k]) for k in s}
        a = np.asarray(a)
        if s.init == "normal" and s.axes[0] == "layers" and a.ndim >= 3:
            a = (a * np.sqrt(a.shape[0] / a.shape[1])).astype(a.dtype)
        return a

    return walk(spec, params)


def _jax_and_port(arch, overrides, fan_in=False, seed=0):
    """Both packages' smoke configs (with ``overrides``), the JAX
    package's float32 params from ``init_of`` (rescaled by
    :func:`_fan_in_scaled` with ``fan_in``) and the port's model holding
    them."""
    jcfg = jax_smoke_config(arch).replace(**overrides)
    tcfg = smoke_config(arch).replace(**overrides)
    spec = jzoo.param_spec(jcfg)
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                          init_of(spec, jax.random.PRNGKey(seed)))
    if fan_in:
        params = _fan_in_scaled(spec, params)
    model = params_from_numpy(tcfg, params, "cpu", torch.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), model


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_every_gradient_match_jax(case):
    """The port's loss (and the MoE family's ``nll`` and ``aux``) and the
    gradient of each leaf against ``jax.value_and_grad`` of
    ``zoo.loss_fn``, float32, 2 x 64 tokens (a multiple of the smoke
    ``attn_chunk``, 32; four SSD or scan chunks of the smoke
    ``ssm_chunk``, 16), under each config's ``remat`` (granite's
    ``"nothing"``, the others' ``"dots"``).  ``hybrid_tail`` runs a
    Mamba-2 layer after the last shared site."""
    jcfg, tcfg, params, model = _jax_and_port(*LOSS_CASES[case])
    shape = JaxShapeSpec("s", 64, 2, "train")
    batch = jdata.batch_for_step(jcfg, shape, 3, 1)
    (want, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                         for k, v in batch.items()}),
        has_aux=True)(params)
    loss, metrics, grads = tsteps.value_and_grad(
        tcfg, model, batch_to(batch, "cpu", torch.float32))
    np.testing.assert_allclose(loss.item(), float(want), **F32)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(),
                                   float(jmetrics[key]), **F32, err_msg=key)
    jflat = dict(_jax_tree_items(jgrads))
    tflat = dict(items(grads))
    assert sorted(jflat) == sorted(tflat)
    for key, g in tflat.items():
        np.testing.assert_allclose(_np(g), np.asarray(jflat[key]), **F32,
                                   err_msg=key)
        assert np.abs(_np(g)).max() > 0, key


def test_gradients_land_in_the_stacked_tree():
    """Each layer's ``.grad`` is a view of its slice of the stacked
    gradient, and the forward never indexes a stacked leaf."""
    cfg = smoke_config("llama3_2_3b")
    model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    grads = tsteps.grads_of(model)
    w1 = grads["layers"]["mlp"]["w1"]
    for i, layer in enumerate(model.layers):
        g = layer["mlp"]["w1"].grad
        assert g.data_ptr() == w1[i].data_ptr() and g.shape == w1[i].shape
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    tsteps.value_and_grad(cfg, model, batch)
    assert all(float(w1[i].abs().sum()) > 0 for i in range(cfg.n_layers))
    assert model.layers[1]["mlp"]["w1"].grad.data_ptr() == w1[1].data_ptr()


@pytest.mark.parametrize("family", sorted(zoo.FAMILY_MODULES))
def test_every_family_has_a_loss(family):
    """Every family of ``FAMILY_MODULES`` trains: ``zoo.loss_fn`` gives a
    finite loss at smoke width; an unknown family raises
    ``NotImplementedError``."""
    arch = next(a for a in PORTED_ARCH_IDS
                if smoke_config(a).family == family)
    cfg = smoke_config(arch)
    model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    loss, metrics = zoo.loss_fn(cfg, model, batch)
    assert torch.isfinite(loss) and metrics["loss"] is loss
    with pytest.raises(NotImplementedError, match="not a ported family"):
        zoo.loss_fn(cfg.replace(family="rnn"), model, batch)


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_moe_gradients_under_remat_equal_full(remat):
    """granite's blocks recomputed in the backward (``"nothing"``, its own
    policy, and ``"dots"``) route as they did in the forward: the loss,
    its parts and every gradient leaf equal those with ``"full"`` (no
    recompute) bit for bit."""
    cfg = smoke_config("granite_moe_1b_a400m")
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    out = []
    for r in (remat, "full"):
        c = cfg.replace(remat=r)
        model = zoo.init_model(c, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
        out.append(tsteps.value_and_grad(c, model, batch))
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(m1[k], m2[k]) for k in ("nll", "aux"))
    for (key, a), (_, b) in zip(items(g1), items(g2)):
        assert torch.equal(a, b), key


def test_hybrid_shared_block_gathers_every_site():
    """zamba2's shared block is one gradient tree: each of its parameters'
    ``.grad`` is that tree's leaf, which after a backward holds the sum of
    the gradients of every site (here the shared block run with a copy of
    its weights a site, each site's gradient taken apart), within
    ``F32``."""
    from repro_torch.models import hybrid

    cfg = smoke_config("zamba2_1_2b").replace(n_layers=5)  # 2 sites, a tail
    model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    grads = tsteps.grads_of(model)
    wq = model.shared["attn"]["wq"]
    assert wq.grad.data_ptr() == grads["shared"]["attn"]["wq"].data_ptr()
    assert model.mamba[1]["wx"].grad.data_ptr() == \
        grads["mamba"]["wx"][1].data_ptr()
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    tsteps.value_and_grad(cfg, model, batch)

    copies = []
    real = hybrid._shared_attn

    def per_site(c, shared, x, positions):
        tree = {k: {n: t.detach().clone().requires_grad_(True)
                    for n, t in v.named_parameters()}
                if isinstance(v, torch.nn.Module) else
                v.detach().clone().requires_grad_(True)
                for k, v in shared.named_children()}
        for k in ("ln1", "ln2"):
            tree[k] = getattr(shared, k).detach().clone().requires_grad_(True)
        copies.append(tree)
        return real(c, tree, x, positions)

    hybrid._shared_attn = per_site
    try:
        loss, _ = zoo.loss_fn(cfg, model, batch)
    finally:
        hybrid._shared_attn = real
    assert len(copies) == 2
    flat = [dict(items(t)) for t in copies]
    site_grads = torch.autograd.grad(loss, [v for f in flat
                                            for v in f.values()])
    n = len(flat[0])
    for i, key in enumerate(flat[0]):
        want = site_grads[i] + site_grads[n + i]
        got = dict(items(grads["shared"]))[key]
        assert float(site_grads[i].abs().max()) > 0, key
        np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=key)


# model FLOPs of a 2 x 32 step, counted by hand from the smoke configs
# (d 64, 4 heads of 16, 2 kv heads (zamba2: 4), d_ff 128, vocab 256):
# attention 12288 a layer (wq, wo 64 x 64; wk, wv 64 x 32), MLP 24576,
# norms 128, the embedding 16384; causal pairs of 32 tokens 528, and the
# attention products 12 x 16 x 4 = 768 FLOPs a pair and sequence
FLOP_CASES = {
    # 2 x (12288 + 24576 + 128) + 16384
    "llama3_2_3b": dict(products=6 * 90368 * 64,
                        attention=768 * 528 * 2 * 2),
    # active: 2 x (12288 + router 256 + 2 of 4 experts x 24576 + 128)
    # + 16384 = 140032 (all 4 experts: 238336)
    "granite_moe_1b_a400m": dict(products=6 * 140032 * 64,
                                 attention=768 * 528 * 2 * 2),
    # a Mamba-1 layer: in_proj 16384, conv 512, x_proj + dt_proj 3200,
    # A_log 1024, D 128, out_proj 8192, norm 64: 2 x 29504 + 16384; the
    # scan is left out
    "falcon_mamba_7b": dict(products=6 * 75392 * 64, attention=0),
    # 5 Mamba-2 layers of 26560 (in 16384, conv 512, 3 x 128, A 1024, out
    # 8192, norm 64), the shared block (16384 + 24576 + 128, MHA) at
    # 5 // 2 = 2 sites, the embedding; attention at the 2 sites only
    "zamba2_1_2b": dict(products=6 * (5 * 26560 + 2 * 41088 + 16384) * 64,
                        attention=768 * 528 * 2 * 2),
    # encoder 2 x 36992 and the decoder's cross wk / wv 2 x 4096 on 2 x 16
    # frames; the rest of the decoder (2 x 49344 - 8192) and the
    # embedding on 2 x 32 tokens; pairs: 16^2 an encoder layer, 528 causal
    # + 32 x 16 cross a decoder layer
    "whisper_tiny": dict(products=6 * (82176 * 32 + 106880 * 64),
                         attention=768 * 2 * (2 * 256 + 2 * (528 + 512))),
}


@pytest.mark.parametrize("arch", FLOP_CASES)
def test_model_flops_per_family_match_hand_counts(arch):
    cfg = smoke_config(arch)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=5)
    got = launch_train.model_flops(cfg, 2, 32)
    want = FLOP_CASES[arch]
    assert got["products"] == want["products"]
    assert got["attention"] == want["attention"]
    assert got["total"] == want["products"] + want["attention"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_trees(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "layers": {"w": (3, 4, 6), "s": (3, 4)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    return draw(1.0), draw(grad_scale), draw(1e-2), draw(1e-3)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_apply_updates_matches_jax(state_dtype, clip):
    """One step from a nonzero state (step 7): params, m, v, step,
    grad_norm and lr against the JAX package's."""
    p, g, m, v = _opt_trees(0, 3.0)
    cfg_kw = dict(learning_rate=1e-2, warmup_steps=4, total_steps=50,
                  grad_clip=clip, state_dtype=state_dtype)
    jdt = ml_dtypes.bfloat16 if state_dtype == "bfloat16" else np.float32
    tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(a.astype(jdt)), m),
              "v": jax.tree.map(lambda a: jnp.asarray(np.abs(a).astype(jdt)),
                                v),
              "step": jnp.asarray(7, jnp.int32)}
    jp, js, jm = jopt.apply_updates(jax.tree.map(jnp.asarray, p),
                                    jax.tree.map(jnp.asarray, g), jstate,
                                    jopt.AdamWConfig(**cfg_kw))
    T = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(dt)
    tp = jax.tree.map(T, p)
    tstate = {"m": jax.tree.map(lambda a: T(a, tdt), m),
              "v": jax.tree.map(lambda a: T(np.abs(a), tdt), v),
              "step": torch.tensor(7, dtype=torch.int32)}
    tp2, ts, tm = opt.apply_updates(tp, jax.tree.map(T, g), tstate,
                                    opt.AdamWConfig(**cfg_kw))
    assert tp2 is tp  # in place
    assert int(ts["step"]) == int(js["step"]) == 8
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               **F32)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    state_tol = BF16_ULP if state_dtype == "bfloat16" else F32
    for name, got, want, tol in (("params", tp, jp, F32),
                                 ("m", ts["m"], js["m"], state_tol),
                                 ("v", ts["v"], js["v"], state_tol)):
        want = dict(_jax_tree_items(want))
        for key, t in items(got):
            assert t.dtype == (tdt if name != "params" else torch.float32)
            np.testing.assert_allclose(
                _np(t), np.asarray(want[key], np.float32), **tol,
                err_msg=f"{name}/{key}")


def test_schedule_matches_jax():
    cfg = dict(learning_rate=3e-4, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 7, 50, 99, 100, 101, 500, 999, 1000, 2000):
        got = opt.schedule(opt.AdamWConfig(**cfg), step)
        want = jopt.schedule(jopt.AdamWConfig(**cfg),
                             jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(step))


def test_adamw_converges_quadratic():
    cfg = opt.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                          warmup_steps=0, total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(params, cfg)
    for _ in range(60):
        opt.apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_metric():
    cfg = opt.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.ones(4)}
    state = opt.init_opt_state(params, cfg)
    _, _, m = opt.apply_updates(params, {"w": 100 * torch.ones(4)}, state,
                                cfg)
    assert float(m["grad_norm"]) > 100


def test_init_opt_state_dtypes():
    params = {"a": torch.zeros(2, 3, dtype=torch.bfloat16)}
    st_ = opt.init_opt_state(params, opt.AdamWConfig(state_dtype="bfloat16"))
    assert st_["m"]["a"].dtype == torch.bfloat16
    assert st_["step"].dtype == torch.int32 and st_["step"].dim() == 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_vl_72b",
                                  "whisper_tiny"])
def test_batch_for_step_is_byte_identical_to_jax(arch):
    shape = ShapeSpec("s", 24, 3, "train")
    want = jdata.batch_for_step(jax_smoke_config(arch),
                                JaxShapeSpec("s", 24, 3, "train"), 5, 11)
    got = batch_for_step(smoke_config(arch), shape, 5, 11)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_data_deterministic_and_prefetch():
    cfg = smoke_config("llama3_2_3b")
    shape = ShapeSpec("s", 16, 2, "train")
    b1 = batch_for_step(cfg, shape, seed=7, step=3)
    b2 = batch_for_step(cfg, shape, seed=7, step=3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    pf = Prefetcher(cfg, shape, seed=7, start_step=0)
    s0, batch0 = pf.next()
    s1, batch1 = pf.next()
    pf.close()
    assert (s0, s1) == (0, 1)
    np.testing.assert_array_equal(batch0["tokens"],
                                  batch_for_step(cfg, shape, 7, 0)["tokens"])
    np.testing.assert_array_equal(batch1["labels"],
                                  batch_for_step(cfg, shape, 7, 1)["labels"])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g = {"a": (rng.standard_normal((8, 5)) * 0.3).astype(jdt),
         "b": {"c": (rng.standard_normal((3, 4, 2)) * 7).astype(jdt)},
         "s": np.asarray(2.5, jdt)}
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(tdt)  # noqa
    tg = jax.tree.map(T, g)
    want = jcomp.compress_tree_int8(jax.tree.map(jnp.asarray, g))
    got = comp.compress_tree_int8(tg)
    wflat = dict(_jax_tree_items(want))
    for key, t in items(got):
        assert t.dtype == tdt
        np.testing.assert_array_equal(_np(t),
                                      np.asarray(wflat[key], np.float32))
    jr = jcomp.init_residual(jax.tree.map(jnp.asarray, g))
    tr = comp.init_residual(tg)
    for _ in range(2):
        jout, jr = jcomp.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jr)
        tout, tr = comp.compress_with_feedback(tg, tr)
        for want_t, got_t in ((jout, tout), (jr, tr)):
            wflat = dict(_jax_tree_items(want_t))
            for key, t in items(got_t):
                np.testing.assert_allclose(
                    _np(t), np.asarray(wflat[key], np.float32), rtol=1e-6,
                    atol=1e-7, err_msg=key)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 1000))
def test_int8_compression_bounded_error(seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal((32, 16))
                          * rng.uniform(0.001, 10)).astype(np.float32))
    out = comp.compress_tree_int8({"g": g})["g"]
    scale = float(g.abs().max()) / 127.0
    assert float((out - g).abs().max()) <= scale * 0.51 + 1e-9


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal(256) * 0.01).astype(
        np.float32))
    r = comp.init_residual({"g": g})
    total_plain = torch.zeros_like(g)
    total_fb = torch.zeros_like(g)
    for _ in range(16):
        total_plain += comp.compress_tree_int8({"g": g})["g"]
        out, r = comp.compress_with_feedback({"g": g}, r)
        total_fb += out["g"]
    err_plain = float(torch.linalg.norm(total_plain - 16 * g))
    err_fb = float(torch.linalg.norm(total_fb - 16 * g))
    assert err_fb <= err_plain + 1e-6


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def _history_state(params, seed):
    """The same optimizer state with history (step 7, moments of a scale
    that past gradients would leave) for both packages.  From a zero state
    AdamW's first update is lr * g / (|g| + eps), the sign of each
    gradient entry, so an entry within float32 noise of zero could flip
    and move its param by 2 lr; with history the update follows the
    gradient smoothly."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(
        np.float32), params)
    v = jax.tree.map(lambda a: ((rng.standard_normal(a.shape) * 1e-2) ** 2
                                + 1e-6).astype(np.float32), params)
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.asarray(7, jnp.int32)}
    tstate = {"m": jax.tree.map(torch.from_numpy, m),
              "v": jax.tree.map(torch.from_numpy, v),
              "step": torch.tensor(7, dtype=torch.int32)}
    return jstate, tstate


@pytest.mark.parametrize("arch,compression,fan_in", [
    ("llama3_2_3b", "none", False), ("llama3_2_3b", "int8", False),
    ("zamba2_1_2b", "none", True)], ids=["none", "int8", "hybrid"])
def test_train_step_matches_jax(arch, compression, fan_in):
    """One ``make_train_step`` step (with and without int8 compression;
    for zamba2 the shared block's gradient summed over its sites and
    AdamW over a tree whose stacked leaves sit under ``mamba``) from the
    same float32 params and optimizer state: loss, metrics and every
    param."""
    jcfg, tcfg, params, model = _jax_and_port(arch, {}, fan_in, seed=1)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20,
              grad_compression=compression)
    batch = jdata.batch_for_step(jcfg, JaxShapeSpec("s", 32, 2, "train"),
                                 0, 0)
    jrun = JaxRunConfig(model=jcfg, shape=JaxShapeSpec("s", 32, 2, "train"),
                        **kw)
    jstate, tstate = _history_state(jax.tree.map(np.asarray, params), 4)
    jp, _, jm = jsteps.make_train_step(jcfg, jrun)(
        params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    trun = RunConfig(model=tcfg, shape=SHAPE, **kw)
    _, _, tm = tsteps.make_train_step(tcfg, trun)(
        model, tstate, batch_to(batch, "cpu", torch.float32))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **F32,
                                   err_msg=key)
    want = dict(_jax_tree_items(jp))
    assert sorted(want) == sorted(k for k, _ in items(model.params))
    for key, t in items(model.params):
        np.testing.assert_allclose(_np(t), np.asarray(want[key]), **F32,
                                   err_msg=key)


def test_grad_accum_step_matches_jax():
    """``make_grad_accum_step`` over 2 micro-batches of 2: the mean loss and
    every param after the step (from a state with history), against the
    JAX package's scan."""
    jcfg = jax_smoke_config("llama3_2_3b").replace(n_layers=1)
    tcfg = smoke_config("llama3_2_3b").replace(n_layers=1)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_of(jzoo.param_spec(jcfg),
                                  jax.random.PRNGKey(2)))
    kw = dict(grad_accum=2, learning_rate=1e-2, warmup_steps=1,
              total_steps=10)
    full = jdata.batch_for_step(jcfg, JaxShapeSpec("s", 32, 4, "train"), 1,
                                0)
    batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in full.items()}
    jrun = JaxRunConfig(model=jcfg, shape=JaxShapeSpec("s", 32, 4, "train"),
                        **kw)
    jstate, tstate = _history_state(jax.tree.map(np.asarray, params), 5)
    jp, _, jm = jsteps.make_grad_accum_step(jcfg, jrun)(
        params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu",
                              torch.float32)
    trun = RunConfig(model=tcfg, shape=ShapeSpec("s", 32, 4, "train"), **kw)
    _, _, tm = tsteps.make_grad_accum_step(tcfg, trun)(
        model, tstate, batch_to(batch, "cpu", torch.float32))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **F32)
    want = dict(_jax_tree_items(jp))
    for key, t in items(model.params):
        np.testing.assert_allclose(_np(t), np.asarray(want[key]), **F32,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the loop (tests/test_system.py's properties, on the port)
# ---------------------------------------------------------------------------


def _run(tmp, **kw):
    cfg = smoke_config("llama3_2_3b").replace(n_layers=2)
    base = dict(model=cfg, shape=SHAPE, checkpoint_dir=str(tmp),
                checkpoint_every=0, total_steps=30)
    base.update(kw)
    return RunConfig(**base)


def test_train_loss_decreases(tmp_path, monkeypatch):
    """tests/test_system.py's run on the port (20 steps at lr 1e-2 after a
    2-step warmup, 5-step windows), with the loop fed step 0's batch at
    every step.  The synthetic tokens are uniform, so across fresh batches
    there is nothing to learn but the uniform distribution and the window
    means move by batch noise (the JAX run at seed 0 drops 0.025, the
    port's 0.009; a difference of two 5-batch means has a spread near
    0.045); on one batch the loop must learn it: measured drops 3.29 to
    3.45 over seeds 0-2, held here at 1.0."""
    import repro_torch.train.loop as loop

    real = loop.batch_for_step
    monkeypatch.setattr(loop, "batch_for_step",
                        lambda cfg, shape, seed, step: real(cfg, shape, seed,
                                                            0))
    out = train(_run(tmp_path, learning_rate=1e-2, warmup_steps=2,
                     total_steps=24), steps=20, device="cpu")
    assert np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 1.0


def test_checkpoint_resume_bit_identical(tmp_path):
    full = train(_run(tmp_path / "a", checkpoint_every=4), steps=8,
                 device="cpu")
    run2 = _run(tmp_path / "b", checkpoint_every=4)
    first = train(run2, steps=4, device="cpu")  # writes the checkpoint at 4
    resumed = train(run2, steps=8, device="cpu")  # resumes 4 -> 8
    assert resumed["losses"] == full["losses"][4:]
    assert first["losses"] == full["losses"][:4]
    for (key, a), (_, b) in zip(items(full["params"]),
                                items(resumed["params"])):
        assert torch.equal(a, b), key
    for (key, a), (_, b) in zip(items(full["opt_state"]),
                                items(resumed["opt_state"])):
        assert torch.equal(a, b), key


def test_failure_injection_retries(tmp_path):
    boom = {"armed": True}

    def fail_once(step):
        if step == 2 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = train(_run(tmp_path), steps=4, fail_hook=fail_once, device="cpu")
    assert out["final_step"] == 4 and len(out["losses"]) == 4
    assert not boom["armed"]


def test_kernel_error_propagates(tmp_path, monkeypatch):
    """A kernel's refused launch raises ``RuntimeError`` inside the step;
    the loop does not retry it (the JAX loop would, for ever)."""
    calls = {"n": 0}

    def refused(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("rmsnorm launch failed: CUDA error 1 (invalid "
                           "argument)")

    monkeypatch.setattr(ref, "rmsnorm", refused)
    with pytest.raises(RuntimeError, match="rmsnorm launch failed"):
        train(_run(tmp_path), steps=3, device="cpu")
    assert calls["n"] == 1


def test_straggler_watchdog_flags_slow_steps():
    from repro_torch.train.loop import StragglerWatchdog

    wd = StragglerWatchdog(threshold=3.0)
    for i in range(8):
        assert not wd.observe(i, 1.0)
    assert wd.observe(8, 5.0) and wd.flagged == [8]


def test_train_launcher_at_smoke_width(tmp_path, capsys):
    out = launch_train.run(["--arch", "llama3_2_3b", "--smoke", "--steps",
                            "3", "--seq", "32", "--batch", "2",
                            "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "final step 3" in text and "time: median step" in text
    assert len(out["losses"]) == 3 and out["tokens_per_s"] > 0
    assert "mfu" not in out  # no device figure from a CPU run
    flops = launch_train.model_flops(out["cfg"], 2, 32)
    assert flops["total"] == flops["products"] + flops["attention"]
    assert launch_train.causal_pairs(4096) == 4096 * 4097 // 2
    assert launch_train.causal_pairs(10, 4) == 10 + 6 * 4


@pytest.mark.parametrize("argv,want", [
    ([], ("train_4k", 4096, 256)),
    (["--batch", "4"], ("train_4k@4x4096", 4096, 4)),
    (["--batch", "4", "--seq", "4096"], ("train_4k@4x4096", 4096, 4)),
    (["--shape", "prefill_32k", "--seq", "1024"],
     ("prefill_32k@32x1024", 1024, 32)),
    (["--smoke"], ("smoke", 64, 4)),
    (["--smoke", "--seq", "32", "--batch", "2"], ("smoke", 32, 2)),
], ids=["full_train_4k", "batch_cut", "batch_and_seq", "other_shape",
        "smoke_defaults", "smoke_given"])
def test_train_launcher_shape_follows_shape_seq_and_batch(argv, want):
    shape = launch_train.resolve_shape(launch_train.parse_args(
        ["--arch", "llama3_2_3b", *argv]))
    assert (shape.name, shape.seq_len, shape.global_batch) == want


def test_train_launcher_rejects_an_unknown_shape():
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "llama3_2_3b", "--shape", "nope"])
