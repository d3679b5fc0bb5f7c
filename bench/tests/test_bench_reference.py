"""The plain reference agrees with the port at the CPU tests' small
widths: a whole run of each cell (set-up, window, comparison) on the CPU
comes out correct under the limits set for those widths (``test`` in
``bench/limits``), for the dense and the MoE training step and for the
prefill."""
import time

import pytest

from bench.tests._util import MOE, cell as load, one_thread  # noqa: F401
from bench.harness import runner

CELLS = ["stablelm_12b.train_4k", MOE, "stablelm_12b.prefill_mixed"]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 17])
@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell, seed, one_thread):
    c = load(cell)
    out = runner.run(c, seed, 0.1, False, "cpu", time.perf_counter(),
                     test=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in c.end_to_end}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
