"""What the benchmark's CPU tests share: the checkout's paths on
``sys.path`` (the driver's ``PYTHONPATH`` holds ``src`` only), and one
CPU thread for torch while a test runs, since the suite runs in several
worker processes at once."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cell(name: str):
    """A cell of ``BENCHMARK.json``, or the MoE training cell that it does
    not name yet (its files are kept; ``PERF.md``, Open questions)."""
    from bench.harness import cells

    if name != MOE:
        return cells.load_cell(name)
    train = cells.load_cell("stablelm_12b.train_4k")
    return cells.from_files(MOE, "granite_moe_1b_a400m", "train_8x4096",
                            train.end_to_end, [])


MOE = "granite_moe_1b_a400m.train_4k"
