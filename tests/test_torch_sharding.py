"""The port's sharding rules and meshes against the JAX package
(``repro/parallel/sharding.py``, ``repro/launch/mesh.py``) on the CPU.

Every comparison hands both packages the reference's mesh extents
(``{"pod": 2, "data": 16, "model": 16}``, as
``tests/test_sharding_fusion.py`` does), so nothing depends on either
package's defaults.  The placements are checked on the port's own H100
production meshes under a fake process group of 256 and 512 ranks and
``FakeTensorMode``; every group a test makes is destroyed after it.
"""
import types

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import zoo as jzoo
from repro.parallel import sharding as jsh
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.models.layers import Spec, spec_map
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt

SIZES = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True)
def no_group_left():
    """Every test starts and ends without a default process group."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left its process group alive")


def _cells():
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if shape_applicable(get_config(a), SHAPES[s])[0]]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_arch_and_shape_lists_match():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_matches(arch):
    for name in SHAPES:
        assert shape_applicable(get_config(arch), SHAPES[name]) == \
            jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_rules_match(arch, multi_pod):
    assert sh.logical_rules(get_config(arch), multi_pod=multi_pod) == \
        jsh.logical_rules(jax_get_config(arch), multi_pod=multi_pod)


def _trees(arch, name):
    """(port trees, JAX trees) of one cell: params, optimizer state,
    inputs, and the decode cache."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = SHAPES[name], JAX_SHAPES[name]
    ocfg = opt.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    jocfg = jopt.AdamWConfig(state_dtype=jcfg.opt_state_dtype)
    mine = {"params": zoo.param_spec(cfg),
            "opt": opt.opt_state_spec(zoo.param_spec(cfg), ocfg),
            "inputs": zoo.input_spec(cfg, shape),
            "cache": zoo.cache_spec(cfg, shape.global_batch, shape.seq_len)}
    theirs = {"params": jzoo.param_spec(jcfg),
              "opt": jopt.opt_state_spec(jzoo.param_spec(jcfg), jocfg),
              "inputs": jzoo.input_spec(jcfg, jshape),
              "cache": jzoo.cache_spec(jcfg, jshape.global_batch,
                                       jshape.seq_len)}
    return cfg, jcfg, mine, theirs


@pytest.mark.parametrize("arch,name", _cells())
def test_opt_state_spec_matches(arch, name):
    _, _, mine, theirs = _trees(arch, name)
    a, b = _leaves(mine["opt"]), _leaves(theirs["opt"])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, s), (_, j) in zip(a, b):
        assert (tuple(s.shape), tuple(s.axes), _dtype_name(s.dtype)) == \
            (tuple(j.shape), tuple(j.axes), jnp.dtype(j.dtype).name), path


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,name", _cells())
def test_pspecs_match_on_every_leaf(arch, name, multi_pod):
    cfg, jcfg, mine, theirs = _trees(arch, name)
    for group in mine:
        ps = sh.pspecs_for(mine[group], cfg, multi_pod=multi_pod,
                           axis_sizes=SIZES)
        jps = jsh.pspecs_for(theirs[group], jcfg, multi_pod=multi_pod,
                             axis_sizes=SIZES)
        a = _leaves(ps)
        b = [(p, tuple(v)) for p, v in _leaves(jps)]
        assert [p for p, _ in a] == [p for p, _ in b], group
        for (path, got), (_, want) in zip(a, b):
            assert got == want, (group, path)
        # and leaf by leaf through _pspec_for itself
        rules = sh.logical_rules(cfg, multi_pod=multi_pod)
        jrules = jsh.logical_rules(jcfg, multi_pod=multi_pod)
        for (path, s), (_, j) in zip(_leaves(mine[group]),
                                     _leaves(theirs[group])):
            assert sh._pspec_for(s.axes, rules, s.shape, SIZES) == tuple(
                jsh._pspec_for(j.axes, jrules, j.shape, SIZES)), path


def test_pspec_fallbacks_match_the_reference_cases():
    rules = sh.logical_rules(get_config("whisper_tiny"))
    assert sh._pspec_for(("vocab", "embed"), rules, (51865, 384),
                         SIZES)[0] is None
    assert sh._pspec_for(("vocab", "embed"), rules, (51872, 384),
                         SIZES)[0] == "model"
    rules = sh.logical_rules(get_config("arctic_480b"))
    ps = sh._pspec_for(("expert", "embed", "mlp"), rules, (128, 7168, 4864),
                       SIZES)
    assert ps[0] == "model" and ps[2] is None  # first dim wins


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_pspec_matches_on_a_grid(multi_pod):
    for pod in (1, 2, 3):
        for data in (1, 2, 4, 16, 32):
            shape = {"pod": pod, "data": data, "model": 8}
            stand_in = types.SimpleNamespace(shape=shape)
            for batch in (1, 2, 3, 4, 8, 16, 32, 48, 64, 96, 128, 256):
                assert sh.batch_pspec(batch, stand_in, multi_pod) == tuple(
                    jsh.batch_pspec(batch, stand_in, multi_pod)), (
                        batch, shape)


def test_default_sizes_are_the_h100_layout():
    assert sh.PROD_AXIS_SIZES == {"pod": 2, "data": 32, "model": 8}
    assert jsh.PROD_AXIS_SIZES == {"pod": 2, "data": 16, "model": 16}


def test_local_shape():
    assert sh.local_shape((256, 4096, 7168), (("pod", "data"), None,
                                              "model"),
                          {"pod": 2, "data": 32, "model": 8}) == (4, 4096,
                                                                  896)
    with pytest.raises(ValueError):
        sh.local_shape((6,), ("model",), {"model": 8})


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_layout(multi_pod):
    with mesh_lib.production_mesh(multi_pod=multi_pod) as mesh:
        facts = mesh_lib.validate_mesh(mesh)
        assert dist.get_world_size() == (512 if multi_pod else 256)
    assert not dist.is_initialized()
    want = {"pod": 2, "data": 32, "model": 8} if multi_pod else \
        {"data": 32, "model": 8}
    assert facts == {"shape": want, "n_devices": 512 if multi_pod else 256,
                     "axis_names": list(want)}


def test_production_mesh_refuses_another_world():
    with mesh_lib.production_mesh(multi_pod=False):
        with pytest.raises(RuntimeError, match="world 256"):
            mesh_lib.make_production_mesh(multi_pod=True)


def test_host_mesh_world_one_over_gloo():
    with mesh_lib.host_mesh(device="cpu") as mesh:
        assert dist.get_backend() == "gloo"
        assert mesh_lib.validate_mesh(mesh) == {
            "shape": {"data": 1, "model": 1}, "n_devices": 1,
            "axis_names": ["data", "model"]}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_give_the_pspecs_local_shards(multi_pod):
    """``distribute_tensor(...).to_local().shape`` is the shape each pspec
    implies, for every parameter leaf of every arch."""
    with mesh_lib.production_mesh(multi_pod=multi_pod) as mesh:
        # outside the fake mode: the mesh's rank tensor is a real one
        sizes = sh.mesh_sizes(mesh)
        _check_placements(mesh, sizes, multi_pod)


def _check_placements(mesh, sizes, multi_pod):
    from torch.distributed.tensor import Shard, distribute_tensor

    with FakeTensorMode():
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            spec = zoo.param_spec(cfg)
            placements = sh.shardings_for(spec, mesh, cfg,
                                          multi_pod=multi_pod)
            pspecs = sh.pspecs_for(spec, cfg, multi_pod=multi_pod,
                                   axis_sizes=sizes)
            for (path, s), (_, pl), (_, ps) in zip(
                    _leaves(spec), _leaves(placements), _leaves(pspecs)):
                t = torch.empty(s.shape, dtype=s.dtype)
                local = distribute_tensor(t, mesh, list(pl)).to_local()
                assert tuple(local.shape) == sh.local_shape(
                    s.shape, ps, sizes), (arch, path, pl)
                for name, p in zip(mesh.mesh_dim_names, pl):
                    if isinstance(p, Shard):
                        assert name in sh._axes(ps[p.dim]), (arch, path)


def test_placements_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    with mesh_lib.production_mesh(multi_pod=True) as mesh:
        assert sh.placements_for((("pod", "data"), None, "model"), mesh) == (
            Shard(0), Shard(0), Shard(2))
        assert sh.placements_for((None, "data"), mesh) == (
            Replicate(), Shard(1), Replicate())


def test_constrain_is_the_identity_on_a_plain_tensor():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.constrain(x, "data", "model") is x


def test_constrain_redistributes_a_dtensor():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with mesh_lib.production_mesh(multi_pod=False) as mesh, \
            FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 16), mesh,
                              [Replicate(), Replicate()])
        y = sh.constrain(x, "data", None)
        assert y.placements == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 16)
        z = sh.constrain(y, "pod", "model")  # no pod axis: replicated
        assert z.placements == (Replicate(), Shard(1))


def test_spec_tree_helpers_keep_the_jax_leaf_order():
    cfg = get_config("llama3_2_3b")
    spec = zoo.param_spec(cfg)
    assert [p for p, _ in _leaves(spec)] == [
        p for p, _ in _leaves(jzoo.param_spec(jax_get_config(
            "llama3_2_3b")))]
    assert isinstance(spec_map(lambda s: s, spec)["emb"], Spec)
