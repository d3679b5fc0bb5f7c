"""``repro_torch.tracing``: the spans of the train step and of
``generate`` at the benchmark's CPU widths (``bench/configs/stablelm_12b``'s
``test_widths``), each inside its parent in a CPU-only profiler's own
trace, and the timed spans counted; nothing kept, no CUDA event made and
no synchronise without a profiler; the events' pair recorded without a
synchronise with one; spans off where torch lacks the private names they
need."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import zoo
from repro_torch.serve.loop import generate
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps
from repro_torch.train.data import batch_for_step
from repro_torch.train.loop import batch_to

#: stablelm_12b at the benchmark's CPU widths
CFG = get_config("stablelm_12b").replace(
    d_model=64, d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16,
    vocab_size=256, n_layers=2, dtype="float32")
SHAPE = ShapeSpec("s", 64, 2, "train")
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def clean():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    tracing.reset()
    torch.set_num_threads(before)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _train(cfg=CFG, grad_accum=1):
    """A model, its AdamW state, a step function and a batch."""
    run = RunConfig(model=cfg, shape=SHAPE, grad_accum=grad_accum)
    model = zoo.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    state = opt_lib.init_opt_state(model.params,
                                   steps.adamw_config(cfg, run))
    batch = batch_to(batch_for_step(cfg, SHAPE, 0, 0), "cpu", torch.float32)
    if grad_accum > 1:
        batch = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                 for k, v in batch.items()}
        return model, state, steps.make_grad_accum_step(cfg, run), batch
    return model, state, steps.make_train_step(cfg, run), batch


def _model():
    return zoo.init_model(CFG, torch.Generator().manual_seed(0), "cpu",
                          torch.float32)


def _prompts(T=16):
    return torch.randint(0, CFG.vocab_size, (2, T), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))


def _ranges(prof, name):
    """The host intervals of the profiler's ranges ``name``."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def _inside(prof, name, outer):
    """How many ranges ``name`` lie inside a range ``outer``."""
    outs = _ranges(prof, outer)
    return sum(any(s <= a and b <= t for s, t in outs)
               for a, b in _ranges(prof, name))


def test_train_step_spans_under_the_step():
    model, state, step, batch = _train()
    step(model, state, batch)  # the first step outside the profiler
    with _cpu_profile() as prof:
        step(model, state, batch)
    assert len(_ranges(prof, "train.step")) == 1
    for name in PHASES:
        assert len(_ranges(prof, name)) == 1, name
        assert _inside(prof, name, "train.step") == 1, name
    t = tracing.totals()
    assert "train.step" not in t  # a range alone, not timed
    assert all(t[name].count == 1 for name in PHASES)
    # device time exactly where CUDA is in use (the card's test run)
    assert all((v.device_s is None) != torch.cuda.is_initialized()
               for v in t.values())


@pytest.mark.parametrize("remat,under_backward", [
    ("dots", CFG.n_layers), ("nothing", CFG.n_layers), ("full", 0)])
def test_rope_in_the_forward_and_the_recompute(remat, under_backward):
    """``model.rope`` fires a layer in the forward, and again inside
    ``train.backward`` where the remat policy recomputes the layer."""
    model, state, step, batch = _train(CFG.replace(remat=remat))
    with _cpu_profile() as prof:
        step(model, state, batch)
    assert _inside(prof, "model.rope", "train.forward") == CFG.n_layers
    assert _inside(prof, "model.rope", "train.backward") == under_backward
    assert tracing.totals()["model.rope"].count == \
        CFG.n_layers + under_backward


def test_grad_accum_step_spans_a_forward_and_backward_a_micro_batch():
    model, state, step, batch = _train(grad_accum=2)
    with _cpu_profile() as prof:
        step(model, state, batch)
    assert len(_ranges(prof, "train.step")) == 1
    assert _inside(prof, "train.forward", "train.step") == 2
    assert _inside(prof, "train.backward", "train.step") == 2
    assert _inside(prof, "train.optimizer", "train.step") == 1
    t = tracing.totals()
    assert [t[n].count for n in PHASES] == [2, 2, 1]


def test_each_step_holds_its_own_phases():
    model, state, step, batch = _train()
    with _cpu_profile() as prof:
        step(model, state, batch)
        step(model, state, batch)
    outs = _ranges(prof, "train.step")
    assert len(outs) == 2 and outs[0][1] <= outs[1][0]
    for s, t in outs:
        for name in PHASES:
            assert sum(s <= a and b <= t
                       for a, b in _ranges(prof, name)) == 1, name


def test_generate_spans_with_one_new_token():
    with _cpu_profile() as prof:
        toks, info = generate(CFG, _model(), _prompts(), max_new_tokens=1)
    assert toks.shape == (2, 1) and info["decode_steps"] == 0
    assert len(_ranges(prof, "serve.generate")) == 1
    for name in ("serve.prefill", "serve.grow_cache", "serve.decode"):
        assert _inside(prof, name, "serve.generate") == 1, name
    assert _inside(prof, "model.rope", "serve.prefill") == CFG.n_layers
    # the serving spans are ranges alone: only RoPE is timed
    assert set(tracing.totals()) == {"model.rope"}


def test_prefill_span_times_what_prefill_s_times():
    """``serve.prefill``'s range in the profiler's trace is the interval
    ``prefill_s`` times, give or take the span's own entry and exit."""
    model = _model()
    generate(CFG, model, _prompts(), max_new_tokens=0)
    with _cpu_profile() as prof:
        _, info = generate(CFG, model, _prompts(), max_new_tokens=3)
    for name, key in (("serve.prefill", "prefill_s"),
                      ("serve.decode", "decode_s")):
        [(s, t)] = _ranges(prof, name)
        assert 1e-6 * (t - s) == pytest.approx(info[key], abs=2e-3), name
    assert tracing.totals()["model.rope"].count == CFG.n_layers * 3


def test_off_without_a_profiler(monkeypatch):
    """No profiler: one shared no-op context, nothing kept, and no CUDA
    event made and no synchronise even where CUDA is in use."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA call with tracing off")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert tracing.span("train.step") is tracing.span("model.rope")
    model, state, step, batch = _train()
    step(model, state, batch)
    generate(CFG, model, _prompts(), max_new_tokens=2)
    assert tracing.totals() == {}


class _Event:
    """A stand-in for ``torch.cuda.Event``: counts records and
    synchronises, 4 ms between a pair."""
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = self.synced = 0
        _Event.made.append(self)

    def record(self):
        self.recorded += 1

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, end):
        assert end.synced
        return 4.0


def test_on_records_events_and_resolves_them_only_in_totals(monkeypatch):
    """A timed span records a pair of events and nothing synchronises
    until :func:`tracing.totals`; the spans that are ranges alone
    (``train.step``) make no event."""
    def refuse(*a, **k):
        raise AssertionError("a synchronise inside a span")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    _Event.made = []
    model, state, step, batch = _train()
    with _cpu_profile():
        step(model, state, batch)
    timed = len(PHASES) + 2 * CFG.n_layers
    assert len(_Event.made) == 2 * timed
    assert all(e.recorded == 1 and e.synced == 0 for e in _Event.made)
    t = tracing.totals()
    assert t["train.forward"].device_s == pytest.approx(4e-3)
    assert t["model.rope"].device_s == pytest.approx(
        4e-3 * 2 * CFG.n_layers)


def test_spans_of_another_thread_are_counted():
    """Autograd's device thread runs a backward's recompute: its timed
    spans count with the caller's."""
    def recompute():
        with tracing.span("model.rope"):
            pass

    with _cpu_profile():
        with tracing.span("train.backward"):
            t = threading.Thread(target=recompute)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    t = tracing.totals()
    assert t["model.rope"].count == 1 and t["train.backward"].count == 1


def test_reset_forgets():
    with _cpu_profile():
        with tracing.span("train.forward"):
            pass
        tracing.reset()
        with tracing.span("train.forward"):
            pass
    assert tracing.totals() == {"train.forward": tracing.Total(1, None)}


def test_a_span_closes_when_its_body_raises():
    with _cpu_profile() as prof:
        with pytest.raises(ValueError):
            with tracing.span("train.forward"):
                raise ValueError("boom")
        with tracing.span("train.step"):
            pass
    assert _inside(prof, "train.forward", "train.step") == 0
    assert len(_ranges(prof, "train.forward")) == 1
    assert len(_ranges(prof, "train.step")) == 1
    assert tracing.totals()["train.forward"].count == 1


def test_spans_sit_in_the_profilers_trace_as_host_ranges():
    """Each span is a host range of the profiler's trace under its name,
    not a user annotation, which the profiler would also draw on the
    device's timeline as a device event."""
    model, state, step, batch = _train()
    with _cpu_profile() as prof:
        step(model, state, batch)
    ranges = [e for e in prof.events() if e.name in (
        "train.step", "train.forward", "train.backward", "train.optimizer",
        "model.rope")]
    assert len(ranges) == 4 + 2 * CFG.n_layers
    for e in ranges:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not getattr(e, "is_user_annotation", False), e.name


def test_the_pinned_torch_has_what_spans_need():
    """The private names spans take from torch are there: a torch that
    renamed them would leave every span off and every span metric out."""
    assert tracing.AVAILABLE


def test_spans_stay_off_where_torch_lacks_them(monkeypatch):
    """Without the private names the program still runs, with spans off
    even while a profiler records."""
    monkeypatch.setattr(tracing, "AVAILABLE", False)
    model, state, step, batch = _train()
    with _cpu_profile() as prof:
        assert tracing.span("train.forward") is tracing.span("serve.prefill")
        step(model, state, batch)
    assert _ranges(prof, "train.step") == []
    assert tracing.totals() == {}
