"""What ``correct`` has to catch, at the CPU tests' small widths: the
control (the reference in float8 in the program's place) and every fault
a cell can have, planted in the program underneath a whole run, come out
not correct.

The MoE cell's control is left to the card: at any width small enough
for these tests its bfloat16 routing flips (a token's k-th and next
expert swapped) move the gradient norms as far as float8 does, so no
limit there separates the two; at the cell's own size it does
(``PERF.md``)."""
import time

import pytest

from bench.tests._util import MOE, cell as load, one_thread  # noqa: F401
from bench.harness import cells, compare, faults, runner

CELLS = ["stablelm_12b.train_4k", MOE, "stablelm_12b.prefill_mixed"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c != MOE])
def test_control_is_not_correct(cell, one_thread):
    c = load(cell)
    nums = cells.entry_module(c).control(c, 23, "cpu", test=True)
    assert not compare.passed(compare.checks(nums, c.limits["test"])), nums


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in cells.entry_module(load(c)).FAULTS])
def test_fault_is_not_correct(cell, fault, one_thread):
    c = load(cell)
    with faults.planted(fault):
        out = runner.run(c, 29, 0.1, False, "cpu", time.perf_counter(),
                         test=True)
    assert not out["correct"], out["checks"]
