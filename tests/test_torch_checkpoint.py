"""The port's checkpoints against the JAX package's, on the CPU: the same
on-disk layout (``step_<n>/manifest.json`` + ``arrays.npz``, the same
keys, bf16 stored as ``uint16`` bits with dtype ``"bfloat16"``), so a JAX
checkpoint restores into the port and a port checkpoint into the JAX
package, bit for bit, bf16 leaves included; garbage collection keeps the
newest ``keep``; ``shardings`` is accepted and ignored on one card.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import zoo as jzoo
from repro.models.layers import init_of
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import smoke_config
from repro_torch.models import zoo
from repro_torch.models.layers import shapes_of
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import items, tree_map


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX array or a tensor, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _jax_state(seed=0, arch="llama3_2_3b"):
    """A smoke state of the JAX package (llama3_2_3b unless ``arch``):
    bf16 params (its ``init_of``), float32 moments with values in them,
    step 3."""
    cfg = jax_smoke_config(arch)
    params = init_of(jzoo.param_spec(cfg), jax.random.PRNGKey(seed))
    state = jopt.init_opt_state(params, jopt.AdamWConfig())
    rng = np.random.default_rng(seed)
    state["m"] = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), state["m"])
    state["step"] = jnp.asarray(3, jnp.int32)
    return cfg, params, state


def _port_like(seed=1, arch="llama3_2_3b"):
    """The port's state for the same config: a model drawn from a torch
    generator (other values than the JAX draw) and a zero state."""
    cfg = smoke_config(arch)
    model = zoo.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, model, opt.init_opt_state(model.params, opt.AdamWConfig())


def _jax_flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_jax_flat(tree[key], f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = tree[key]
    return out


def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path):
    _, params, state = _jax_state()
    jckpt.save(str(tmp_path), 3, {"params": params, "opt_state": state,
                                  "extra": {"losses_tail": [1.5]}})
    _, model, tstate = _port_like()
    out = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)),
                       {"params": model.params, "opt_state": tstate})
    assert out["extra"] == {"losses_tail": [1.5]}
    assert out["params"]["emb"] is model.params["emb"]  # in place
    want = {"params": _jax_flat(params), "opt_state": _jax_flat(state)}
    for group, tree in (("params", model.params), ("opt_state", tstate)):
        for key, t in items(tree):
            w = want[group][key]
            assert str(t.dtype).split(".")[1] == str(w.dtype), key
            np.testing.assert_array_equal(_bits(t), _bits(w), err_msg=key)
    assert model.params["emb"].dtype == torch.bfloat16
    assert int(tstate["step"]) == 3
    # the model's per-layer views see the restored stacked leaves
    assert torch.equal(model.layers[1]["mlp"]["w1"],
                       model.params["layers"]["mlp"]["w1"][1])


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path):
    _, model, tstate = _port_like()
    tstate["v"] = tree_map(lambda t: torch.full_like(t, 0.25), tstate["v"])
    tstate["step"] = torch.tensor(9, dtype=torch.int32)
    ckpt.save(str(tmp_path), 9, {"params": model.params,
                                 "opt_state": tstate, "extra": {"x": 1}})
    _, params, state = _jax_state()
    out = jckpt.restore(str(tmp_path), 9, {"params": params,
                                           "opt_state": state})
    assert out["extra"] == {"x": 1}
    got = {"params": _jax_flat(out["params"]),
           "opt_state": _jax_flat(out["opt_state"])}
    for group, tree in (("params", model.params), ("opt_state", tstate)):
        for key, t in items(tree):
            g = got[group][key]
            assert str(g.dtype) == str(t.dtype).split(".")[1], key
            np.testing.assert_array_equal(_bits(g), _bits(t), err_msg=key)


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "whisper_tiny"])
def test_other_trees_restore_both_ways_bitwise(tmp_path, arch):
    """The hybrid's tree (``mamba`` stacked, ``shared`` whole) and the
    encdec's (``encoder`` and ``decoder`` stacked, ``ln_enc``) cross over
    both ways bit for bit, into the leaves the model's parameters view."""
    _, params, state = _jax_state(arch=arch)
    jckpt.save(str(tmp_path / "jax"), 3, {"params": params,
                                          "opt_state": state})
    _, model, tstate = _port_like(arch=arch)
    ckpt.restore(str(tmp_path / "jax"), 3, {"params": model.params,
                                            "opt_state": tstate})
    want = {"params": _jax_flat(params), "opt_state": _jax_flat(state)}
    for group, tree in (("params", model.params), ("opt_state", tstate)):
        got = dict(items(tree))
        assert sorted(got) == sorted(want[group])
        for key, t in got.items():
            np.testing.assert_array_equal(_bits(t), _bits(want[group][key]),
                                          err_msg=key)
    stacked = "mamba" if arch == "zamba2_1_2b" else "decoder"
    layer = getattr(model, stacked)[1]
    key = "wx" if arch == "zamba2_1_2b" else "ln_x"
    assert torch.equal(layer[key], model.params[stacked][key][1])

    tstate["step"] = torch.tensor(9, dtype=torch.int32)
    ckpt.save(str(tmp_path / "port"), 9, {"params": model.params,
                                          "opt_state": tstate})
    _, params2, state2 = _jax_state(seed=5, arch=arch)
    out = jckpt.restore(str(tmp_path / "port"), 9, {"params": params2,
                                                    "opt_state": state2})
    back = {"params": _jax_flat(out["params"]),
            "opt_state": _jax_flat(out["opt_state"])}
    for group, tree in (("params", model.params), ("opt_state", tstate)):
        for key, t in items(tree):
            np.testing.assert_array_equal(_bits(back[group][key]), _bits(t),
                                          err_msg=key)


def test_manifests_name_the_same_leaves(tmp_path):
    """Both packages write the same keys, shapes and dtype names for the
    same config's state."""
    _, params, state = _jax_state()
    jckpt.save(str(tmp_path / "jax"), 1, {"params": params,
                                          "opt_state": state})
    _, model, tstate = _port_like()
    ckpt.save(str(tmp_path / "port"), 1, {"params": model.params,
                                          "opt_state": tstate})
    read = lambda d: json.load(open(  # noqa: E731
        tmp_path / d / "step_00000001" / "manifest.json"))["leaves"]
    assert read("jax") == read("port")
    with np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as f:
        assert f["params/emb"].dtype == np.uint16
        assert f["opt_state/step"].shape == ()


def test_restore_into_meta_like_gives_new_tensors(tmp_path):
    cfg, model, tstate = _port_like()
    ckpt.save(str(tmp_path), 2, {"params": model.params,
                                 "opt_state": tstate})
    like = {"params": shapes_of(zoo.param_spec(cfg)),
            "opt_state": tree_map(lambda t: t.to("meta"), tstate)}
    out = ckpt.restore(str(tmp_path), 2, like,
                       shardings={"params": None})  # ignored on one card
    for (key, a), (_, b) in zip(items(out["params"]), items(model.params)):
        assert a.device.type == "cpu" and torch.equal(a, b), key
    assert out["opt_state"]["step"].dim() == 0


def test_restore_refuses_another_shape(tmp_path):
    _, model, tstate = _port_like()
    ckpt.save(str(tmp_path), 1, {"params": model.params,
                                 "opt_state": tstate})
    cfg2 = smoke_config("llama3_2_3b").replace(n_layers=3)
    m2 = zoo.init_model(cfg2, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(str(tmp_path), 1, {"params": m2.params,
                                        "opt_state": tstate})


def test_checkpoint_gc(tmp_path):
    params = {"a": torch.ones(2)}
    state = {"m": params, "v": params,
             "step": torch.zeros((), dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"params": params, "opt_state": state},
                  keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_save_publishes_atomically(tmp_path):
    """A leftover ``.tmp`` (a crash mid-save) is neither a step nor in the
    way of the next save of the same step."""
    os.makedirs(tmp_path / "step_00000005.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    params = {"a": torch.arange(3.0)}
    state = {"m": params, "v": params,
             "step": torch.zeros((), dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 5, {"params": params,
                                        "opt_state": state})
    assert path.endswith("step_00000005") and os.path.isdir(path)
    assert not os.path.exists(path + ".tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5
