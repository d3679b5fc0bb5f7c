"""The traffic is a pure function of ``--seed``, and every seed gets the
same sizes and arrivals."""
import numpy as np
import pytest

from bench.tests._util import ROOT  # noqa: F401
from bench.harness import cells, traffic

PREFILL = cells.traffic_as_run(dict(cells.load_json(
    f"{ROOT}/bench/traffic/prefill_mixed.json"), name="prefill_mixed"))
TRAIN = cells.traffic_as_run(dict(cells.load_json(
    f"{ROOT}/bench/traffic/train_4x4096.json"), name="train_4x4096"))
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_lengths(seed):
    """Each block holds every length of the set once, in the mix's own
    order: the same for every ``--seed``, another for another
    ``order_seed``."""
    n = PREFILL["lengths_per_block"]
    lengths = [traffic.prefill_length(PREFILL, i) for i in range(4 * n)]
    assert all(512 <= L <= 4096 for L in lengths)
    blocks = [sorted(lengths[b * n:(b + 1) * n]) for b in range(4)]
    assert all(b == sorted(traffic.length_set(PREFILL)) for b in blocks)
    assert lengths[:n] != lengths[n:2 * n]
    other = dict(PREFILL, order_seed=PREFILL["order_seed"] + seed + 1)
    assert lengths != [traffic.prefill_length(other, i)
                       for i in range(4 * n)]
    mean = np.mean(traffic.length_set(PREFILL))
    assert 1600 < mean < 1850  # log-uniform over [512, 4096]: 1723


@pytest.mark.parametrize("seed", SEEDS)
def test_prompts_and_rows_repeat(seed):
    a = traffic.prompts(PREFILL, seed, 3, 640, 100352)
    assert a.shape == (4, 640) and a.max() < 100352 and a.min() >= 0
    assert (a == traffic.prompts(PREFILL, seed, 3, 640, 100352)).all()
    assert not (a == traffic.prompts(PREFILL, seed + 1, 3, 640,
                                     100352)).all()
    rows = traffic.train_batch(TRAIN, seed, 2, 49155)
    assert rows["tokens"].shape == (4, 4096)
    assert (rows["labels"] == np.roll(rows["tokens"], -1, 1)).all()
    again = traffic.train_batch(TRAIN, seed, 2, 49155)
    assert (again["tokens"] == rows["tokens"]).all()
    other = traffic.train_batch(TRAIN, seed, 3, 49155)
    assert not (other["tokens"] == rows["tokens"]).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_holds_the_longest(seed):
    """One sampled batch of the longest length, and one from each other
    span of the window: the whole window is sampled, not its start."""
    n = traffic.window_batches(PREFILL, 51)
    sample = traffic.sample_batches(PREFILL, seed, n)
    k = PREFILL["sample_batches"]
    assert len(sample) == k == len(set(sample))
    assert all(0 <= i < n for i in sample)
    assert max(traffic.prefill_length(PREFILL, i) for i in sample) \
        == max(traffic.length_set(PREFILL))
    spans = {i * k // n for i in sample}
    assert len(spans) == k
    assert sample == traffic.sample_batches(PREFILL, seed, n)


def test_arrivals_are_evenly_spaced():
    rate = PREFILL["rate_batches_per_s"]
    assert traffic.arrival_s(PREFILL, 10) == pytest.approx(10 / rate)
    n = traffic.window_batches(PREFILL, 51)
    assert traffic.arrival_s(PREFILL, n - 1) < 51 <= traffic.arrival_s(
        PREFILL, n)
