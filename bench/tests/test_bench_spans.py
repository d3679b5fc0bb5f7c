"""The readers of the program's spans (``repro_torch.tracing``): the device
milliseconds a step or batch from the totals, and nothing where the count
is not what ran, where no device time was taken, or where the program has
no spans."""
import sys

import pytest

from bench.tests._util import ROOT
from bench.harness import cells
from repro_torch import tracing

TRAIN = cells.as_run(cells.load_json(
    f"{ROOT}/bench/configs/stablelm_12b.json"), "train")
SERVE = cells.as_run(cells.load_json(
    f"{ROOT}/bench/configs/stablelm_12b.json"), "serve")
STEPS = 3
BATCHES = [(4, 576), (4, 3840)]

#: metric -> (cell, span, spans that ran, what it is over)
READERS = {
    "forward_ms.train": ("stablelm_12b.train_4k", "train.forward", STEPS,
                         STEPS),
    "backward_ms.train": ("stablelm_12b.train_4k", "train.backward", STEPS,
                          STEPS),
    "optimizer_ms.train": ("stablelm_12b.train_4k", "train.optimizer",
                           STEPS, STEPS),
    # a layer in the forward and in the "dots" recompute
    "rope_ms.train": ("stablelm_12b.train_4k", "model.rope",
                      STEPS * 4 * 2, STEPS),
    "rope_ms.prefill": ("stablelm_12b.prefill_mixed", "model.rope",
                        len(BATCHES) * 40, len(BATCHES)),
}


def _ctx(cell):
    if cell.endswith("train_4k"):
        return {"entry": "train", "conf": TRAIN, "steps": STEPS,
                "batch": 4, "seq": 4096, "trace": None}
    return {"entry": "prefill", "conf": SERVE, "batches": BATCHES,
            "trace": None}


def _read(metric, monkeypatch, totals):
    cell = READERS[metric][0]
    monkeypatch.setattr(tracing, "totals", lambda: totals)
    return cells.metric_reader(cells.load_cell(cell), metric).read(
        _ctx(cell))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_device_ms_per_step_or_batch(metric, monkeypatch):
    _, span, n, per = READERS[metric]
    totals = {span: tracing.Total(n, 0.6),
              "other.span": tracing.Total(1, 1.0)}
    assert _read(metric, monkeypatch, totals) == pytest.approx(600.0 / per)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_where_the_count_is_not_what_ran(metric, monkeypatch):
    _, span, n, _ = READERS[metric]
    for count in (n - 1, n + 1):
        assert _read(metric, monkeypatch,
                     {span: tracing.Total(count, 0.6)}) is None
    assert _read(metric, monkeypatch, {}) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_without_device_time(metric, monkeypatch):
    _, span, n, _ = READERS[metric]
    for dev in (None, 0.0):
        assert _read(metric, monkeypatch,
                     {span: tracing.Total(n, dev)}) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_from_the_other_entry(metric, monkeypatch):
    cell, span, n, _ = READERS[metric]
    other = "stablelm_12b.prefill_mixed" if cell.endswith("train_4k") else \
        "stablelm_12b.train_4k"
    monkeypatch.setattr(tracing, "totals",
                        lambda: {span: tracing.Total(n, 0.6)})
    reader = cells.metric_reader(cells.load_cell(cell), metric)
    assert reader.read(_ctx(other)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_from_a_program_without_spans(metric, monkeypatch):
    """A checkout whose program has no ``repro_torch.tracing`` (the
    benchmark's files laid over an older program) reads nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    cell = READERS[metric][0]
    reader = cells.metric_reader(cells.load_cell(cell), metric)
    assert reader.read(_ctx(cell)) is None


def test_rope_counts_one_pass_without_a_recompute(monkeypatch):
    conf = dict(TRAIN, remat="full")
    monkeypatch.setattr(tracing, "totals", lambda: {
        "model.rope": tracing.Total(STEPS * 4, 0.03)})
    reader = cells.metric_reader(cells.load_cell("stablelm_12b.train_4k"),
                                 "rope_ms.train")
    assert reader.read(dict(_ctx("stablelm_12b.train_4k"), conf=conf)) == \
        pytest.approx(10.0)
