"""The frozen work counts give the values the port's
``launch.train.model_flops`` gave when they were copied, and the per-layer
readers leave out what a trace does not hold."""
import pytest

from bench.tests._util import ROOT
from bench.harness import cells
from bench.harness.trace import Trace
from bench.yardstick import flops

STABLELM = cells.as_run(cells.load_json(
    f"{ROOT}/bench/configs/stablelm_12b.json"), "train")
GRANITE = cells.as_run(cells.load_json(
    f"{ROOT}/bench/configs/granite_moe_1b_a400m.json"), "train")
SERVE = cells.as_run(cells.load_json(
    f"{ROOT}/bench/configs/stablelm_12b.json"), "serve")


@pytest.mark.parametrize("conf,batch,want", [
    (STABLELM, 4, 1.6802516e14), (GRANITE, 8, 1.0407357e14)])
def test_train_step_flops_pinned(conf, batch, want):
    assert flops.train_step_flops(conf, batch, 4096)["total"] == \
        pytest.approx(want, rel=1e-7)


def test_parameter_counts():
    assert flops.param_count(STABLELM) == 1_625_333_760
    assert flops.param_count(SERVE) == 11_629_117_440
    assert flops.param_count(GRANITE) == 1_334_627_328
    assert flops.param_count(GRANITE, active_only=True) == 428_657_664


def test_prefill_counts_the_head_once_a_sequence():
    f = flops.prefill_flops(SERVE, 4, 1024)
    layers = flops.param_count(SERVE) - 100352 * 5120
    assert f["products"] == 2.0 * layers * 4 * 1024 + 2.0 * 100352 * 5120 * 4
    assert f["attention"] == 4.0 * 160 * 32 * 4 * 40 * (1024 * 1025 // 2)


def _trace(ops, window_s=1.0):
    return Trace(busy_s=sum(s for s, _ in ops.values()), window_s=window_s,
                 ops=ops, idle_gaps=[], kernels=sum(n for _, n in
                                                    ops.values()))


@pytest.mark.parametrize("metric", [
    "attention_roofline.train", "swiglu_roofline.train",
    "other_kernels_ms.train"])
def test_reader_without_its_kernels_reads_nothing(metric):
    cell = cells.load_cell("stablelm_12b.train_4k")
    reader = cells.metric_reader(cell, metric)
    ctx = {"entry": "train", "conf": STABLELM, "steps": 2, "batch": 4,
           "seq": 4096, "trace": _trace({"nvjet_tst_x": (0.4, 10)})}
    if metric == "other_kernels_ms.train":
        assert reader.read(ctx) is None
        ctx["trace"] = _trace({"vectorized_elementwise_kernel": (0.1, 5)})
        assert reader.read(ctx) == pytest.approx(50.0)
    else:
        assert reader.read(ctx) is None


def test_roofline_reading():
    cell = cells.load_cell("stablelm_12b.train_4k")
    reader = cells.metric_reader(cell, "attention_roofline.train")
    work = flops.attention_flops(STABLELM, 4, 4096, train=True)
    ctx = {"entry": "train", "conf": STABLELM, "steps": 1, "batch": 4,
           "seq": 4096, "trace": _trace({
               "flash_fwd_wgmma_kernel<160, true>": (work / 989e12, 8)})}
    assert reader.read(ctx) == pytest.approx(100.0)
