"""AdamW's route and its two CUDA kernels' wrappers, on the CPU.

The kernels themselves (``csrc/adamw.cu``) run only on the card
(``tests/test_torch_cuda.py``: the update bit for bit against the loop,
the norm deterministic).  Here: CPU tensors take the plain loop and count
no launch; fake tensors standing for the card take the kernels' fake rule
(one ``adamw_norm`` call with ``cost.adamw_norm``'s bytes, one ``adamw``
call a combination of dtypes with ``cost.adamw``'s, the norm's scratch the
only allocation), and a leaf the kernels cannot take is refused, not sent
to the loop; what each wrapper hands its C entry; and the kernels' names,
which must stay in the benchmark's ``other`` kernel group.  The file imports neither ``jax`` nor
``repro``.
"""
import math
import os
import re

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from bench.yardstick.groups import group_of
from repro_torch.configs import get_config
from repro_torch.kernels import _launch, adamw, cost, fake
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaves, tree_map

CSRC = os.path.join(os.path.dirname(os.path.abspath(adamw.__file__)), "csrc",
                    "adamw.cu")


def _counts():
    return adamw.global_norm_cuda.launches, adamw.adamw_update_cuda.launches


def _tree(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"emb": torch.randn(6, 5, generator=g).to(dtype),
            "layers": {"w": torch.randn(3, 4, 7, generator=g).to(dtype),
                       "ln": torch.randn(3, 4, generator=g).to(dtype)},
            "ln_f": torch.randn(5, generator=g).to(dtype)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_cpu_tensors_take_the_plain_loop(state_dtype, clip):
    """On the CPU apply_updates is the loop: the norm summed slice by
    slice, the clip scale from it, :func:`optimizer.plain_update`; no
    kernel launch is counted."""
    cfg = opt.AdamWConfig(state_dtype=state_dtype, grad_clip=clip,
                          warmup_steps=2)
    params, grads = _tree(0, torch.bfloat16), _tree(1, torch.bfloat16)
    want_p = tree_map(torch.clone, params)
    state = opt.init_opt_state(params, cfg)
    want_s = tree_map(torch.clone, state)
    before = _counts()
    _, state, om = opt.apply_updates(params, grads, state, cfg)
    assert _counts() == before
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(grads)))
    torch.testing.assert_close(om["grad_norm"], norm, rtol=1e-6, atol=0)
    step = torch.ones((), dtype=torch.int32)
    scale = torch.clamp(clip / torch.clamp(om["grad_norm"], min=1e-9),
                        max=1.0) if clip else 1.0
    opt.plain_update(leaves(want_p), leaves(grads), leaves(want_s["m"]),
                     leaves(want_s["v"]), opt.schedule(cfg, step),
                     1.0 - cfg.b1 ** step.float(),
                     1.0 - cfg.b2 ** step.float(), scale, cfg)
    for got, want in zip(leaves(params) + leaves(state["m"])
                         + leaves(state["v"]),
                         leaves(want_p) + leaves(want_s["m"])
                         + leaves(want_s["v"])):
        assert torch.equal(got, want)
    assert int(state["step"]) == 1


class _Allocations(TorchDispatchMode):
    """The element counts of the tensors each op makes that are neither
    views nor 0-d."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and isinstance(out, torch.Tensor) and out.dim():
            self.made.append((func.overloadpacket.__name__, out.numel()))
        return out


def _fake_step(spec_cfg, state_dtype="float32", grad_dtype=None,
               transpose=None):
    """One apply_updates on fake CPU tensors of ``spec_cfg``'s parameter
    tree, under a tally that models the card: (tally, the tensors the
    step made, the leaves' numel, the partial sums)."""
    cfg = opt.AdamWConfig(state_dtype=state_dtype)
    spec = zoo.param_spec(spec_cfg)
    with FakeTensorMode():
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                          spec)
        grads = tree_map(lambda p: torch.empty(
            p.shape, dtype=grad_dtype or p.dtype), params)
        if transpose is not None:  # the same shape, not contiguous
            rows, cols = grads[transpose].shape
            grads[transpose] = torch.empty(cols, rows).t()
        state = opt.init_opt_state(params, cfg)
        with fake.tally("cuda") as t, _Allocations() as rec:
            _, state, om = opt.apply_updates(params, grads, state, cfg)
        assert om["grad_norm"].dtype == torch.float32
        assert om["grad_norm"].dim() == 0
    n = [p.numel() for p in leaves(params)]
    return t, rec.made, n, adamw.partials(leaves(grads))


def test_fake_card_tensors_record_one_adamw_call():
    """stablelm_12b's 11 leaves (the benchmark's 4-layer cut, bf16 params
    and grads, float32 state) on fakes standing for the card: one
    adamw_norm call with cost.adamw_norm's bytes and operations and one
    adamw call with cost.adamw's, and the norm's scratch (its partial
    sums, the norm and the scale) is the only tensor made: no float32
    temporary of a leaf or a slice."""
    before = _counts()
    t, made, n, parts = _fake_step(
        get_config("stablelm_12b").replace(n_layers=4))
    assert len(n) == 11 and 1.6e9 < sum(n) < 1.65e9
    assert t.calls == {"adamw_norm": 1, "adamw": 1} and t.routes == {}
    update, norm = cost.adamw(sum(n), 2, 2, 4), cost.adamw_norm(sum(n),
                                                                2 * sum(n))
    assert (t.bytes, t.ops) == (update[0] + norm[0], update[1] + norm[1])
    assert made == [("empty", parts + 2)]
    assert _counts() == before  # a fake call is not a launch


def test_fake_mixed_dtypes_record_a_call_per_combination():
    """granite_moe_1b_a400m's tree (bf16 weights, float32 routers) with
    bf16 state: one call per (param, grad, state) combination, their
    bytes summed."""
    spec_cfg = get_config("granite_moe_1b_a400m").replace(n_layers=2)
    t, made, n, parts = _fake_step(spec_cfg, state_dtype="bfloat16")
    by = {}
    for s in leaves(zoo.param_spec(spec_cfg)):
        by[s.dtype] = by.get(s.dtype, 0) + math.prod(s.shape)
    assert set(by) == {torch.bfloat16, torch.float32}
    assert t.calls == {"adamw_norm": 1, "adamw": 2} and t.routes == {}
    assert t.bytes == sum(cost.adamw(k, dt.itemsize, dt.itemsize, 2)[0]
                          + cost.adamw_norm(k, k * dt.itemsize)[0]
                          for dt, k in by.items())
    assert made == [("empty", parts + 2)]


def test_fake_float32_grads_of_bf16_params_take_the_kernels():
    """Gradient accumulation's float32 grads with bf16 params: one
    combination, the grads' 4 bytes in the norm and in the update."""
    t, _, n, _ = _fake_step(get_config("stablelm_12b").replace(n_layers=1),
                            grad_dtype=torch.float32)
    assert t.calls == {"adamw_norm": 1, "adamw": 1}
    assert t.bytes == cost.adamw(sum(n), 2, 4, 4)[0] \
        + cost.adamw_norm(sum(n), 4 * sum(n))[0]


def test_fake_non_contiguous_leaf_is_refused():
    """On the card the device decides and the kernels refuse what they
    cannot take: a transposed gradient leaf raises ``ValueError`` rather
    than sending the step to the loop."""
    with pytest.raises(ValueError, match="contiguous"):
        _fake_step(get_config("stablelm_12b").replace(n_layers=1),
                   transpose="emb")


def test_fake_cpu_tally_traces_the_loop():
    """Under a tally of the plain program (``cpu``) fakes are not the
    card's: the loop, and nothing recorded."""
    cfg = opt.AdamWConfig()
    with FakeTensorMode():
        params = {"w": torch.empty(4, 8)}
        grads = {"w": torch.empty(4, 8)}
        state = opt.init_opt_state(params, cfg)
        with fake.tally("cpu") as t:
            opt.apply_updates(params, grads, state, cfg)
    assert t.calls == {} and t.routes == {}


def _fakes(*specs):
    return [torch.empty(*shape, dtype=dt) for shape, dt in specs]


@pytest.mark.parametrize("case,want", [
    ("cpu", False),
    ("fake card bf16 and float32", True),
    ("fake card float16", False),
    ("fake card transposed", False),
    ("fake card offset view", True),
    ("none", False),
])
def test_route_by_device_dtype_and_contiguity(case, want):
    """The kernels' check: every tensor on the card (here fakes standing
    for it), contiguous, float32 or bf16, else ``ValueError``; an offset
    view is contiguous and taken (the kernels read it one element a
    thread)."""
    def takes(ts):
        try:
            return adamw._check("adamw", ts) is not None
        except ValueError:
            return False

    if case == "cpu":
        assert takes([torch.ones(3), torch.ones(3)]) is want
        return
    if case == "none":
        assert takes([]) is want
        return
    with FakeTensorMode(), fake.tally("cuda"):
        ts = _fakes(((4, 8), torch.bfloat16), ((4, 8), torch.float32))
        if case == "fake card float16":
            ts.append(torch.empty(3, dtype=torch.float16))
        elif case == "fake card transposed":
            ts.append(torch.empty(4, 8).t())
        elif case == "fake card offset view":
            ts.append(torch.empty(9)[1:])
        assert takes(ts) is want


def test_partials_one_a_chunk_of_each_leaf():
    C = adamw.CHUNK
    grads = [torch.empty(0), torch.empty(()), torch.empty(C),
             torch.empty(C + 1), torch.empty(3, C)]
    assert adamw.partials(grads) == 0 + 1 + 1 + 2 + 3


def test_cost_is_the_byte_bound_of_the_training_cell():
    """1.625 B parameters, bf16 params and grads, float32 state: 24 bytes
    a parameter (22 in the update, 2 in the norm), 39.0 GB."""
    n = 1_625_000_000
    n_bytes, ops, rate = cost.adamw(n, 2, 2, 4)
    assert n_bytes == 22 * n and ops == 17 * n
    assert rate == cost.FP32_OPS_PER_S
    assert cost.adamw_norm(n, 2 * n) == (2 * n, 2 * n, cost.FP32_OPS_PER_S)
    assert n_bytes + 2 * n == 39.0e9


@pytest.fixture
def launches(monkeypatch):
    """The C entry calls the wrappers make, captured instead of made; the
    operands pass the route on the CPU."""
    calls = []
    monkeypatch.setattr(adamw, "_check", lambda name, tensors: 0)
    monkeypatch.setattr(adamw._launch, "launch",
                        lambda name, argtypes, index, *args, library="":
                        calls.append((name, argtypes, index, args, library)))
    before = _counts()
    yield calls
    adamw.global_norm_cuda.launches, adamw.adamw_update_cuda.launches = \
        before


def test_norm_wrapper_hands_its_entry_the_table(launches):
    """The grads' pointers, numel and dtype codes, their count, the
    scratch, the partial sums and grad_clip, in ``_NORM_ARGS``' order;
    the norm and the scale are the scratch's last two entries."""
    grads = [torch.ones(5, 3), torch.ones((), dtype=torch.bfloat16),
             torch.ones(adamw.CHUNK + 2)]
    before = _counts()
    norm, scale = adamw.global_norm_cuda(grads, 0.5)
    assert _counts() == (before[0] + 1, before[1])
    (name, argtypes, _, args, library), = launches
    assert (name, argtypes, library) == ("adamw_norm", adamw._NORM_ARGS,
                                         "adamw")
    assert len(args) == len(adamw._NORM_ARGS)
    ptrs, n, codes, count, scratch, parts, clip = args
    assert list(ptrs) == [g.data_ptr() for g in grads]
    assert list(n) == [15, 1, adamw.CHUNK + 2] and list(codes) == [0, 1, 0]
    assert (count, parts, clip) == (3, 4, 0.5)
    assert norm.data_ptr() == scratch + 4 * 4
    assert scale.data_ptr() == scratch + 5 * 4
    assert norm.dim() == scale.dim() == 0


def test_update_wrapper_launches_once_a_dtype_combination(launches):
    """Leaves grouped by (param, grad, state) dtype in the order they
    first appear, one entry call a group: pointers and numel of the
    group's leaves, the four device scalars, the constants as Python
    floats (1 - b1 and 1 - b2 in double, as aten takes them) and the
    three dtype codes."""
    cfg = opt.AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    bf, f32 = torch.bfloat16, torch.float32
    shapes = [((3, 4), bf, f32), ((5,), f32, f32), ((2, 2, 2), bf, f32),
              ((), bf, bf)]
    ps = [torch.zeros(s, dtype=p) for s, p, _ in shapes]
    gs = [torch.zeros(s, dtype=p) for s, p, _ in shapes]
    ms = [torch.zeros(s, dtype=st) for s, _, st in shapes]
    vs = [torch.zeros(s, dtype=st) for s, _, st in shapes]
    scalars = [torch.ones((), dtype=f32) for _ in range(4)]
    before = _counts()
    adamw.adamw_update_cuda(ps, gs, ms, vs, *scalars, cfg)
    assert _counts() == (before[0], before[1] + 3)
    groups = [[0, 2], [1], [3]]
    codes = [(1, 1, 0), (0, 0, 0), (1, 1, 1)]
    assert len(launches) == 3
    for (name, argtypes, _, args, library), idx, code in zip(
            launches, groups, codes):
        assert (name, argtypes, library) == ("adamw", adamw._ARGS, "")
        assert len(args) == len(adamw._ARGS)
        for k, role in enumerate((ps, gs, ms, vs)):
            assert list(args[k]) == [role[i].data_ptr() for i in idx]
        assert list(args[4]) == [ps[i].numel() for i in idx]
        assert args[5] == len(idx)
        assert args[6:10] == tuple(s.data_ptr() for s in scalars)
        assert args[10:16] == (0.9, 1 - 0.9, 0.95, 1 - 0.95, 1e-8, 0.1)
        assert args[16:] == code


def test_update_wrapper_refuses_what_the_kernel_cannot_take(launches):
    cfg = opt.AdamWConfig()
    one = torch.ones((), dtype=torch.float32)
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="same shapes"):
        adamw.adamw_update_cuda([x], [torch.zeros(5)], [x], [x], one, one,
                                one, one, cfg)
    with pytest.raises(ValueError, match="float32 scalars"):
        adamw.adamw_update_cuda([x], [x], [x], [x], one.bfloat16(), one, one,
                                one, cfg)
    with pytest.raises(ValueError, match="m is"):
        adamw.adamw_update_cuda([x], [x], [x], [x.bfloat16()], one, one, one,
                                one, cfg)
    assert launches == []


def test_entries_refuse_cpu_tensors():
    x = torch.zeros(4)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        adamw.global_norm_cuda([x])
    with pytest.raises(ValueError, match="CUDA"):
        adamw.adamw_update_cuda([x], [x], [x], [x], one, one, one, one,
                                opt.AdamWConfig())


def test_kernel_names_stay_in_the_benchmark_group_other():
    """Every ``__global__`` of ``csrc/adamw.cu`` falls in no named kernel
    group of the benchmark's yardstick, so the optimizer's time stays in
    ``other_kernels_ms``."""
    with open(CSRC) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)", src)
    assert sorted(names) == ["adamw_norm_finish_kernel", "adamw_norm_kernel",
                             "adamw_update_kernel"]
    for name in names:
        assert group_of(name) == "other", name
    # the demangled names a trace shows carry the parameters' types too
    assert group_of("void (anonymous namespace)::adamw_update_kernel<"
                    "__nv_bfloat16, __nv_bfloat16, float>((anonymous "
                    "namespace)::LeafTable, float const*, float const*, "
                    "float const*, float const*, (anonymous namespace)::"
                    "Hyper)") == "other"


def test_table_sizes_agree_with_the_source():
    """The wrapper's CHUNK and MAX_LEAVES are the C side's kChunk and
    kMaxLeaves."""
    with open(CSRC) as f:
        src = f.read()
    assert re.search(rf"kChunk = {adamw.CHUNK};", src)
    assert re.search(rf"kMaxLeaves = {adamw.MAX_LEAVES};", src)
    assert _launch.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}
