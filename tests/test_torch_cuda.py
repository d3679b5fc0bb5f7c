"""``repro_torch`` on the card: the CUDA ``sim_alu`` kernel against its
plain version, and the cycle loop on ``cuda`` against the CPU run.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import CORPUS_DIR
from repro_torch.compiler.artifact import CompileResult
from repro_torch.kernels import ref
from repro_torch.kernels.sim_alu import sim_alu, sim_alu_cuda
from repro_torch.sim.batch import prepare_batch, simulate_batch
from repro_torch.sim.step import run_bucket

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _mappings():
    out = []
    for fn in ("atax_u2__plaid.json", "dwconv_u1__plaid.json",
               "jacobi_u1__plaid.json", "atax_u2__spatial.json"):
        art = CompileResult.load(f"{CORPUS_DIR}/{fn}")
        out += art.rebuild_mappings()
    return out


@pytest.mark.parametrize("shape", [(1, 1), (7, 129), (300, 1000)])
def test_sim_alu_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    opcode = torch.from_numpy(
        rng.integers(-1, 21, shape).astype(np.int32)).to(cuda)
    a, b, c, leaf = (torch.from_numpy(
        rng.integers(-2 ** 15, 2 ** 15 + 1, shape).astype(np.float32)
    ).to(cuda) for _ in range(4))
    before = sim_alu_cuda.launches
    got = sim_alu(opcode, a, b, c, leaf)
    torch.cuda.synchronize()
    assert sim_alu_cuda.launches == before + 1
    want = ref.sim_alu(opcode, a, b, c, leaf)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sim_alu_kernel_rejects_bad_operands(cuda):
    x = torch.zeros(4, 4, device=cuda)
    op = torch.zeros(4, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        sim_alu_cuda(op.float(), x, x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        sim_alu_cuda(op.t(), x.t(), x.t(), x.t(), x.t())


def test_cycle_loop_on_card_equals_cpu(cuda):
    ms = _mappings()
    dev = run_bucket(prepare_batch(ms, iterations=3, device=cuda).packed)
    cpu = run_bucket(prepare_batch(ms, iterations=3, device="cpu").packed)
    for x, y in zip(dev, cpu):
        np.testing.assert_array_equal(x, y)


def test_verdicts_on_card_equal_cpu(cuda):
    ms = _mappings()
    bad = copy.deepcopy(ms[0])
    bad.routes.pop(next(iter(bad.routes)))
    ms.append(bad)
    on_card = simulate_batch(ms, iterations=3, device=cuda)
    on_cpu = simulate_batch(ms, iterations=3, device="cpu")
    assert on_card.backend == "cuda"
    assert [(v.ok, v.reason) for v in on_card] == \
        [(v.ok, v.reason) for v in on_cpu]
    assert not on_card[-1].ok and all(v.ok for v in on_card[:-1])
