"""The launch planner of the port on the CPU: the dry run
(``repro_torch.launch.dryrun``), its roofline (``launch.roofline``) and the
kernels' fake rule (``kernels.fake``), against the JAX package where the
two compute the same thing.

The dry run traces the card's program at smoke width on a world-1 host
mesh (gloo): one family at a time, its 1- and 2-layer traces combined by
the JAX package's extrapolation equal the full-depth trace's FLOPs
exactly, its arguments are the real tensors' bytes, and its kernel calls
are ``chip_smoke.py``'s launch formulas.  The production cells run
through the command line on the fake 256- and 512-GPU groups.  Every
process group is destroyed after each test.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jroof
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable, smoke_config)
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import cost, fake, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_swiglu import fused_swiglu, fused_swiglu_cuda
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cuda
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import zoo
from repro_torch.models.layers import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.data import batch_for_step
from repro_torch.train.loop import batch_to

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: one arch of each family
FAMILIES = {"dense": "llama3_2_3b", "moe": "arctic_480b",
            "ssm": "falcon_mamba_7b", "hybrid": "zamba2_1_2b",
            "encdec": "whisper_tiny", "vlm": "qwen2_vl_72b",
            "moe_granite": "granite_moe_1b_a400m",
            "window": "h2o_danube_3_4b"}
#: the smoke cells' traffic
SMOKE = {"train": (2, 64), "prefill": (2, 64), "decode": (2, 64)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left its process group alive")


def _overrides(arch, **extra):
    """The smoke config of ``arch`` as overrides of its full config."""
    full, sm = get_config(arch), smoke_config(arch).replace(**extra)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if getattr(sm, f.name) != getattr(full, f.name)}


def _run(arch, kind, overrides, device="cuda"):
    B, T = SMOKE[kind]
    shape = ShapeSpec(f"smoke_{kind}", T, B, kind)
    with host_mesh(device="cpu") as mesh:
        return dryrun.run_cell(arch, shape.name, False, shape=shape,
                               mesh=mesh, cfg_overrides=overrides,
                               device=device)


# ---------------------------------------------------------------------------
# The dry run at smoke width
# ---------------------------------------------------------------------------


#: each family's smoke depth for the extrapolation check (deeper than the
#: 2-layer points, so the combination is not one point)
DEEP = {"llama3_2_3b": dict(n_layers=4), "arctic_480b": dict(n_layers=3),
        "falcon_mamba_7b": dict(n_layers=3),
        "zamba2_1_2b": dict(n_layers=5, attn_every=2),
        "whisper_tiny": dict(n_layers=3, n_enc_layers=3),
        "qwen2_vl_72b": dict(n_layers=3)}


@pytest.mark.parametrize("arch", sorted(DEEP))
def test_points_combine_to_the_full_depth_flops(arch):
    """The JAX package's 1- and 2-layer extrapolation, over the port's own
    traces, gives the full-depth trace's FLOPs exactly."""
    ov = _overrides(arch, **DEEP[arch])
    full = _run(arch, "train", ov)
    assert full["status"] == "ok", full
    cfg = get_config(arch).replace(**ov)
    pts = []
    for _, point, coef in roofline.points_for(cfg):
        rec = _run(arch, "train", dict(ov, **point))
        assert rec["status"] == "ok", rec
        pts.append((rec, coef))
    assert roofline.combine(pts)["flops"] == full["flops_per_device"]
    assert roofline.points_for(cfg) == jroof.points_for(
        jax_get_config(arch).replace(**ov))


def _real_arguments(arch, kind, ov):
    """The bytes of real tensors of a cell's arguments at smoke width."""
    cfg = get_config(arch).replace(**ov)
    B, T = SMOKE[kind]
    shape = ShapeSpec("real", T, B, kind)
    gen = torch.Generator().manual_seed(0)
    params = init_params(zoo.param_spec(cfg), gen, torch.device("cpu"))
    tensors = list(_flat(params))
    if kind == "train":
        state = opt.init_opt_state(params, opt.AdamWConfig(
            state_dtype=cfg.opt_state_dtype))
        tensors += list(_flat(state))
        tensors += list(batch_to(batch_for_step(cfg, shape, 0, 0), "cpu",
                                 torch.bfloat16).values())
    elif kind == "prefill":
        tensors += list(_flat(init_params(zoo.input_spec(cfg, shape), gen,
                                          torch.device("cpu"))))
    else:
        tensors += list(_flat(init_params(zoo.cache_spec(cfg, B, T), gen,
                                          torch.device("cpu"))))
        tensors.append(torch.zeros((B, 1), dtype=torch.int32))
    return sum(t.numel() * t.element_size() for t in tensors)


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree


def _want_launches(cfg, kind):
    if kind == "train":
        return CS.train_launches(cfg, 1)
    one = CS.serve_launches(cfg, passes=1)
    if kind == "prefill":
        return one
    two = CS.serve_launches(cfg, passes=2)
    return {k: v - one.get(k, 0) for k, v in two.items()
            if v - one.get(k, 0)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_smoke_cell_arguments_and_kernel_calls(family, kind):
    arch = FAMILIES[family]
    ov = _overrides(arch)
    rec = _run(arch, kind, ov)
    assert rec["status"] == "ok", rec
    assert rec["argument_size_in_bytes"] == _real_arguments(arch, kind, ov)
    # one device holds everything at world 1: the trace is the prediction
    assert rec["traced_argument_bytes"] == rec["argument_size_in_bytes"]
    assert rec["peak_bytes"] == rec["traced_peak_bytes"]
    assert rec["kernels"] == _want_launches(
        get_config(arch).replace(**ov), kind)
    assert rec["flops_per_device"] > rec["kernel_flops"] >= 0
    assert rec["bytes_per_device"] > 0
    assert all(v["count"] == 0 for v in rec["collectives"].values())
    assert rec["not_reported"] == ["alias_size_in_bytes",
                                   "generated_code_size_in_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_cpu_device_models_the_plain_versions(kind):
    """``--device cpu`` traces the plain versions: no kernel call, and the
    plain attention's (T, T) scores raise the peak."""
    ov = _overrides("llama3_2_3b")
    card, plain = _run("llama3_2_3b", kind, ov), _run(
        "llama3_2_3b", kind, ov, device="cpu")
    assert plain["status"] == "ok" and plain["kernels"] == {}
    assert card["kernels"] and plain["kernel_flops"] == 0
    assert plain["argument_size_in_bytes"] == card["argument_size_in_bytes"]
    assert plain["temp_size_in_bytes"] > card["temp_size_in_bytes"]


def test_local_view_refusals_are_errors_with_reasons():
    """A plan the local view cannot express is an error record; whisper's
    6 heads on ``model=8`` (48 columns a device) are no longer one: they
    are gathered whole for compute."""
    from repro_torch.launch.mesh import production_mesh

    with production_mesh(multi_pod=False) as mesh:
        rec = dryrun.run_cell("whisper_tiny", "train_4k", False, mesh=mesh)
        assert rec["status"] == "ok"
        assert rec["local_config"]["n_heads"] == 6
        # heads sharded (24 x 12 columns), kv_heads replicated (12 do not
        # split 8 ways): kv_group would change from 24 to 3
        rec = dryrun.run_cell("llama3_2_3b", "decode_32k", False, mesh=mesh,
                              cfg_overrides={"head_dim": 12,
                                             "n_kv_heads": 1})
        assert rec["status"] == "error" and "kv_group" in rec["reason"]


def _local_bytes(spec_tree, mesh, cfg, multi_pod):
    """The bytes of the local shards the sharding rules' placements give
    one device on ``mesh``."""
    from repro_torch.parallel import sharding

    total = 0
    places = dict(dryrun._leaves(sharding.shardings_for(
        spec_tree, mesh, cfg, multi_pod=multi_pod)))
    for path, s in dryrun._leaves(spec_tree):
        shape = list(s.shape)
        for i, p in enumerate(places[path]):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
        total += int(np.prod(shape)) * torch.empty(
            (), dtype=s.dtype).element_size()
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["sp", "mp"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_whisper_plans_on_the_production_mesh(shape, multi_pod):
    """whisper_tiny's 6 x 64 head columns shard to 48 a device on
    ``model=8``: the cell plans, attention on whole heads gathered over
    ``model``.  Its arguments are the placements' local shards, byte for
    byte; the gathers are all-gathers over ``model``; its FLOPs a device
    are at least the model's over the devices."""
    from repro_torch.launch.mesh import production_mesh
    from repro_torch.train import optimizer as opt_lib

    cfg, spec = get_config("whisper_tiny"), SHAPES[shape]
    with production_mesh(multi_pod=multi_pod) as mesh:
        rec = dryrun.run_cell("whisper_tiny", shape, multi_pod, mesh=mesh)
        assert rec["status"] == "ok", rec
        trees = [zoo.param_spec(cfg), zoo.input_spec(cfg, spec)]
        if spec.kind == "train":
            trees.append(opt_lib.opt_state_spec(trees[0], opt_lib.AdamWConfig(
                state_dtype=cfg.opt_state_dtype)))
        elif spec.kind == "decode":
            trees.append(zoo.cache_spec(cfg, spec.global_batch,
                                        spec.seq_len))
        want = sum(_local_bytes(t, mesh, cfg, multi_pod) for t in trees)
    assert rec["argument_size_in_bytes"] == want
    assert rec["local_config"]["n_heads"] == rec["local_config"][
        "n_kv_heads"] == 6
    assert rec["kernels"] and rec["kernel_routes"]
    gather = rec["collectives"]["all-gather"]
    assert gather["count"] > 0 and gather["by_axis"]["model"] > 0
    assert rec["collectives"]["reduce-scatter"]["count"] == 0
    assert rec["flops_per_device"] >= roofline.model_flops(
        cfg, spec) / rec["mesh"]["n_devices"]
    assert rec["temp_size_in_bytes"] > 0


def _without_times(rec):
    return {k: v for k, v in rec.items()
            if k not in ("trace_s", "total_s", "traced_depths")}


@pytest.mark.parametrize("kind,batch", [("prefill", 32), ("train", 256)])
def test_point_traced_cell_equals_the_full_trace(kind, batch, monkeypatch):
    """falcon_mamba_7b at 4 layers and 256 tokens on the production mesh,
    traced at the depth rule's points and combined, equals its full-depth
    trace in every field (arguments, outputs, temp, FLOPs, bytes, kernel
    calls and routes, collectives)."""
    from repro_torch.launch.mesh import production_mesh

    shape = ShapeSpec(f"small_{kind}", 256, batch, kind)
    ov = {"n_layers": 4}
    with production_mesh(multi_pod=False) as mesh:
        full = dryrun.run_cell("falcon_mamba_7b", shape.name, False,
                               shape=shape, mesh=mesh, cfg_overrides=ov)
        monkeypatch.setattr(dryrun, "FULL_DEPTH_SCAN_STEPS", 0)
        pts = dryrun.run_cell("falcon_mamba_7b", shape.name, False,
                              shape=shape, mesh=mesh, cfg_overrides=ov)
    assert full["status"] == pts["status"] == "ok"
    assert "traced_depths" not in full and pts["traced_depths"] == [2, 3]
    assert _without_times(pts) == _without_times(full)


def test_depth_rule_picks_points_without_tracing(monkeypatch):
    """falcon_mamba_7b's ``prefill_32k`` (32768 positions x 64 layers of
    the eager scan) is traced at 2 and 3 layers, combined with the
    coefficients (3 - L) and (L - 2); its ``train_4k`` and decode cells and
    the other families' cells at full depth.  The trace is a stand-in that
    counts the depths."""
    from repro_torch.launch.mesh import production_mesh

    depths = []

    def stand_in(cell, device="cuda"):
        depths.append(cell.cfg.n_layers)
        return {"flops_per_device": float(cell.cfg.n_layers),
                "kernels": {"rmsnorm": 1}, "trace_s": 1.0}

    monkeypatch.setattr(dryrun, "trace_cell", stand_in)
    with production_mesh(multi_pod=False) as mesh:
        for shape, want in [("prefill_32k", [2, 3]), ("train_4k", [64]),
                            ("decode_32k", [64])]:
            depths.clear()
            rec = dryrun.run_cell("falcon_mamba_7b", shape, False,
                                  mesh=mesh)
            assert depths == want, shape
            assert rec.get("traced_depths", depths) == want
            # a linear count comes back as the full depth's
            assert rec["flops_per_device"] == 64.0
            assert rec["kernels"] == {"rmsnorm": 1}
            assert rec["trace_s"] == float(len(want))
    for arch, shape in [("zamba2_1_2b", "prefill_32k"),
                        ("llama3_2_3b", "train_4k"),
                        ("falcon_mamba_7b", "decode_32k")]:
        assert dryrun.depth_points(get_config(arch), SHAPES[shape]) is None


def test_combine_records_field_by_field():
    recs = [({"a": 3, "b": 2.5, "d": {"x": 1, "y": {"z": 4}}, "s": "p",
              "trace_s": 1.5}, -1),
            ({"a": 5, "b": 4.5, "d": {"x": 2, "w": 7, "y": {"z": 6}},
              "s": "q", "trace_s": 2.0}, 2)]
    assert dryrun.combine_records(recs) == {
        "a": 7, "b": 6.5, "d": {"x": 3, "y": {"z": 8}, "w": 14}, "s": "p",
        "trace_s": 3.5}


def test_collectives_follow_the_plan_on_the_production_mesh():
    """llama3_2_3b decode on 256 GPUs: no FSDP, no gradients; one
    all-reduce over model a row-parallel product a layer, the vocab
    head's two statistics and the lookup's."""
    from repro_torch.launch.mesh import production_mesh

    with production_mesh(multi_pod=False) as mesh:
        cell, _ = dryrun.build_cell("llama3_2_3b", "decode_32k", False,
                                    mesh=mesh)
    coll = dryrun.plan_collectives(cell)
    assert coll["all-gather"]["count"] == coll["reduce-scatter"]["count"] \
        == coll["all-to-all"]["count"] == 0
    L = 28
    assert coll["all-reduce"]["count"] == 2 * L + 3
    assert set(coll["all-reduce"]["by_axis"]) == {"model"}


def test_fsdp_shards_the_arguments_and_the_optimizer():
    """llama3_2_3b's training with FSDP on 256 GPUs: the arguments are the
    data-sharded shards, AdamW runs on them (its bytes shrink), and each
    FSDP leaf is all-gathered twice a layer and reduce-scattered once."""
    from repro_torch.launch.mesh import production_mesh

    with production_mesh(multi_pod=False) as mesh:
        tp = dryrun.run_cell("llama3_2_3b", "train_4k", False, mesh=mesh)
        fsdp = dryrun.run_cell("llama3_2_3b", "train_4k", False, mesh=mesh,
                               cfg_overrides={"fsdp": True})
    assert tp["status"] == fsdp["status"] == "ok"
    assert fsdp["argument_size_in_bytes"] < tp["argument_size_in_bytes"] / 8
    assert fsdp["bytes_per_device"] < tp["bytes_per_device"]
    assert fsdp["kernels"] == tp["kernels"]
    coll = fsdp["collectives"]
    n_fsdp = 2 + 28 * 9  # emb, ln_f; each layer's 7 products and 2 norms
    assert coll["all-gather"]["count"] == 2 * n_fsdp
    assert coll["reduce-scatter"]["count"] == n_fsdp
    assert tp["collectives"]["all-gather"]["count"] == 0


# ---------------------------------------------------------------------------
# The roofline against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_points_for_matches(arch):
    assert roofline.points_for(get_config(arch)) == jroof.points_for(
        jax_get_config(arch))


def test_combine_matches():
    recs = [({"flops_per_device": 3.0, "bytes_per_device": 5.0,
              "collectives": {"all-reduce": {"count": 1, "bytes": 7.0}}},
             -2.0),
            ({"flops_per_device": 11.0, "bytes_per_device": 13.0,
              "collectives": {"all-gather": {"count": 2, "bytes": 17.0}}},
             3.0)]
    assert roofline.combine(recs) == jroof.combine(recs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_every_cell(arch, monkeypatch):
    """The JAX package's ``analyze_cell`` over stand-in point records gives
    the port's ``model_flops`` and skip records for every cell."""
    def point(*args, **kwargs):
        return {"status": "ok", "flops_per_device": 1.0,
                "bytes_per_device": 1.0, "collectives": {}}

    monkeypatch.setattr(jroof, "run_point", point)
    for name in SHAPES:
        theirs = jroof.analyze_cell(arch, name, False)
        if "skipped" in theirs:
            assert not shape_applicable(get_config(arch), SHAPES[name])[0]
            continue
        assert roofline.model_flops(get_config(arch), SHAPES[name]) == \
            theirs["model_flops"], (arch, name)


def test_h100_terms():
    assert (roofline.BF16_OPS_PER_S, roofline.HBM_BYTES_PER_S,
            roofline.NVLINK_BYTES_PER_S, roofline.IB_BYTES_PER_S) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert roofline.link_rate("model") == 450e9
    assert roofline.link_rate("pod+data") == roofline.link_rate("data") \
        == 50e9
    rec = {"mesh": {"n_devices": 2}, "flops_per_device": 989e12,
           "bytes_per_device": 3.35e12 / 2,
           "collectives": {"all-reduce": {"count": 2, "bytes": 5e11,
                                          "by_axis": {"model": 4.5e11,
                                                      "data": 5e10}}}}
    t = roofline.terms(rec, get_config("llama3_2_3b"), SHAPES["decode_32k"])
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5
    assert t["collective_s"] == 2.0 and t["dominant"] == "collective"
    assert t["traced_flops_global"] == 2 * 989e12


def test_chip_smoke_reads_the_roofline_rates():
    """One copy of the H100 rates: ``chip_smoke.py`` takes its rates and
    its bound from the roofline and states none of its own."""
    assert (CS.HBM_BYTES_PER_S, CS.FP32_OPS_PER_S) == (
        roofline.HBM_BYTES_PER_S, roofline.FP32_OPS_PER_S)
    assert CS._bound is roofline.bound_ms
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    for rate in ("989e12", "3.35e12", "67e12", "450e9", "50e9"):
        assert rate not in text


def test_kernel_costs_are_the_bounds_formulas():
    """The costs at the train shapes equal the formulas the kernel table's
    bounds were computed with."""
    M, D, F, H, Hkv, T, d = 16384, 3072, 8192, 96, 32, 4096, 128
    pairs = H * T * (T + 1) // 2
    assert cost.rmsnorm(2000, D, 2) == ((2 * 2000 * D + D) * 2,
                                        4 * 2000 * D, 67e12)
    assert cost.fused_swiglu(2000, D, F, 2) == (
        (2000 * D + 2 * D * F + 2000 * F) * 2, 4 * 2000 * D * F + 5 * 2000 * F,
        989e12)
    assert cost.flash_attention(H, Hkv, 500, d, 2)[:2] == (
        (2 * H + 2 * Hkv) * 500 * d * 2, 4 * d * H * 500 * 501 // 2)
    assert cost.rmsnorm_bwd(M, D, 2)[:2] == (3 * M * D * 2 + 2 * D * 2,
                                             10 * M * D)
    assert cost.swiglu_gate_bwd(M * F, 2)[:2] == (5 * M * F * 2, 12 * M * F)
    assert cost.flash_attention_bwd(H, Hkv, T, d, 2)[:2] == (
        (4 * H + 4 * Hkv) * T * d * 2 + H * T * 4, 10 * d * pairs)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 3, 10, 40])
def test_attention_pairs_count_the_mask(causal, window):
    S = 17
    q, k = np.arange(S)[:, None], np.arange(S)[None]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= q >= k
    if window:
        mask &= (q - k) < window
    assert cost.attention_pairs(S, causal, window) == int(mask.sum())


# ---------------------------------------------------------------------------
# The fake rule: never a fallback
# ---------------------------------------------------------------------------


def _counts():
    return (rmsnorm_cuda.launches, fused_swiglu_cuda.launches,
            flash_attention_cuda.launches)


def test_a_real_cpu_tensor_takes_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g)
    s = torch.randn(8, generator=g)
    w1, w3 = torch.randn(8, 6, generator=g), torch.randn(8, 6, generator=g)
    q = torch.randn(2, 5, 4, generator=g)
    before = _counts()
    with fake.tally("cuda") as t:
        assert torch.equal(rmsnorm(x, s), ref.rmsnorm(x, s))
        assert torch.equal(fused_swiglu(x, w1, w3),
                           ref.fused_swiglu(x, w1, w3))
        assert torch.equal(flash_attention(q, q, q), ref.flash_attention(
            q, q, q))
    assert t.calls == {} and _counts() == before
    assert not fake.modelled(x)


def test_fake_cpu_tensors_take_the_rule_only_under_a_cuda_tally():
    before = _counts()
    with FakeTensorMode():
        x = torch.empty(16, 8)
        s = torch.empty(8)
        with fake.tally("cpu") as plain:
            out = rmsnorm(x, s)  # the plain version, traced
        with fake.tally("cuda") as card:
            out2 = rmsnorm(x, s)
            q = torch.empty(2, 64, 16, dtype=torch.bfloat16)
            o, lse, o32 = flash_attention_cuda(q, q, q, train=True)
    assert plain.calls == {} and tuple(out.shape) == (16, 8)
    assert card.calls == {"rmsnorm": 1, "flash_attention": 1}
    assert tuple(out2.shape) == (16, 8) and out2.dtype == x.dtype
    assert (tuple(o.shape), o.dtype) == ((2, 64, 16), torch.bfloat16)
    assert (tuple(lse.shape), lse.dtype) == ((2, 64), torch.float32)
    assert (tuple(o32.shape), o32.dtype) == ((2, 64, 16), torch.float32)
    assert card.ops == cost.rmsnorm(16, 8, 4)[1] + cost.flash_attention(
        2, 2, 64, 16, 2, train=True)[1]
    assert _counts() == before  # a fake call is not a launch


def test_fake_cuda_tensors_take_the_rule_without_a_card():
    """Fake ``cuda`` tensors take the rule with the kernel's shapes and
    dtypes and launch nothing (without autograd and views: in a build
    without CUDA both need the device's guard)."""
    before = _counts()
    with FakeTensorMode(), fake.tally("cuda") as t:
        x = torch.empty(32, 64, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(64, 128, dtype=torch.bfloat16, device="cuda")
        out = fused_swiglu(x, w, w)
        y = rmsnorm(x, torch.empty(64, dtype=torch.bfloat16, device="cuda"))
        assert out.device.type == "cuda" and y.device.type == "cuda"
        assert (tuple(out.shape), out.dtype) == ((32, 128), torch.bfloat16)
        assert (tuple(y.shape), y.dtype) == ((32, 64), torch.bfloat16)
    assert t.calls == {"fused_swiglu": 1, "rmsnorm": 1}
    assert _counts() == before


def test_fake_routes_read_alignment_from_the_storage_offset():
    """A bf16 view 2 bytes past a 16-byte boundary takes fused_swiglu's
    SIMT route and flash's backward ``mma.sync``, as an address would; at
    d 64 and at stablelm's 160."""
    with FakeTensorMode(), fake.tally("cuda") as t:
        w = torch.empty(64, 128, dtype=torch.bfloat16)
        x = torch.empty(32 * 64 + 1, dtype=torch.bfloat16)
        fused_swiglu(x[:-1].view(32, 64), w, w)
        fused_swiglu(x[1:].view(32, 64), w, w)
        from repro_torch.kernels.flash_attention import \
            flash_attention_bwd_cuda

        for d in (64, 160):
            q = torch.empty(2 * 64 * d + 1, dtype=torch.bfloat16)
            lse, o32 = torch.empty(2, 64), torch.empty(2, 64, d)
            for view in (q[:-1], q[1:]):
                v = view.view(2, 64, d)
                flash_attention_bwd_cuda(v, v, v, o32, v, lse)
    assert t.routes == {"fused_swiglu": {"tensor cores": 1, "SIMT": 1},
                        "flash_attention_bwd": {"wgmma": 2, "mma.sync": 2}}


def test_fake_forward_records_its_route():
    """The flash forward's fake rule records :func:`fwd_route`'s route:
    bf16 at d 64 on ``wgmma``, the same q 2 bytes past a 16-byte boundary
    on ``mma.sync``, bf16 at d 160 on ``wgmma``, at d 192 on
    ``mma.sync``, float32 on ``SIMT``; in both forms, and no launch
    counted."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    before = _counts()
    with FakeTensorMode(), fake.tally("cuda") as t:
        q = torch.empty(2 * 64 * 64 + 1, dtype=torch.bfloat16)
        for train in (False, True):
            for view in (q[:-1], q[1:]):
                v = view.view(2, 64, 64)
                flash_attention_cuda(v, v, v, train=train)
            for d in (160, 192):
                w = torch.empty(2, 64, d, dtype=torch.bfloat16)
                flash_attention_cuda(w, w, w, train=train)
            f = torch.empty(2, 64, 64)
            flash_attention_cuda(f, f, f, train=train)
    assert t.calls == {"flash_attention": 10}
    assert t.routes == {"flash_attention": {"wgmma": 4, "mma.sync": 4,
                                            "SIMT": 2}}
    assert _counts() == before


def test_stablelm_train_step_runs_flash_on_wgmma():
    """stablelm_12b's train path as ``chip_smoke.py`` cuts it
    (``TRAIN_RUNS``: 4 layers, batch x sequence ``TRAIN_SHAPE``) at world 1
    on fake tensors: flash's training forward and its backward at head dim
    160 take ``wgmma``, and the kernel calls are ``train_launches``'."""
    layers = CS.TRAIN_RUNS["stablelm_12b"]
    B, T = CS.TRAIN_SHAPE
    shape = ShapeSpec("train_4k", T, B, "train")
    with host_mesh(device="cpu") as mesh:
        rec = dryrun.run_cell("stablelm_12b", shape.name, False, shape=shape,
                              mesh=mesh, cfg_overrides={"n_layers": layers})
    assert rec["status"] == "ok", rec
    cfg = get_config("stablelm_12b").replace(n_layers=layers)
    assert cfg.resolved_head_dim == 160
    assert rec["kernels"] == CS.train_launches(cfg, 1)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert rec["kernel_routes"][name] == {"wgmma": rec["kernels"][name]}


# ---------------------------------------------------------------------------
# The command line at production size
# ---------------------------------------------------------------------------


def _cli(tmp_path, *args):
    out = tmp_path / "cell.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--json",
         str(out)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    return proc, json.loads(out.read_text())


@pytest.mark.parametrize("arch,multi_pod", [("llama3_2_3b", False),
                                            ("arctic_480b", True)])
def test_production_train_cell_from_the_command_line(tmp_path, arch,
                                                     multi_pod):
    args = ["--arch", arch, "--shape", "train_4k"]
    proc, rec = _cli(tmp_path, *args + (["--multi-pod"] if multi_pod
                                        else []))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rec["status"] == "ok"
    assert rec["mesh"]["n_devices"] == (512 if multi_pod else 256)
    cfg = get_config(arch)
    assert rec["kernels"] == CS.train_launches(cfg, 1)
    # the batch of 256 splits over (pod, data): 4 or 8 sequences a device
    assert rec["argument_size_in_bytes"] > 0 and rec["temp_size_in_bytes"] > 0
    if multi_pod:  # FSDP over data, experts over model, gradients over pod
        coll = rec["collectives"]
        assert coll["all-gather"]["count"] > 0
        assert set(coll["all-gather"]["by_axis"]) == {"data"}
        assert set(coll["reduce-scatter"]["by_axis"]) == {"data"}
        assert coll["all-to-all"]["count"] == 35 * 2 * 3
        assert "pod" in coll["all-reduce"]["by_axis"]
        assert rec["local_experts"] == 16


def test_long_500k_writes_the_reference_skip_record(tmp_path):
    proc, rec = _cli(tmp_path, "--arch", "llama3_2_3b", "--shape",
                     "long_500k")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rec == {"skipped": "pure full-attention arch: long_500k skipped "
                   "per assignment"}


def test_sweep_needs_out():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--sweep"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 2 and "--out" in proc.stderr
