"""``repro_torch.kernels`` ALU stage vs the JAX package.

The plain PyTorch version (``repro_torch.kernels.ref.sim_alu``) must equal
the JAX Pallas kernel ``repro.kernels.sim_alu.sim_alu`` (interpret mode on
the CPU, as the JAX package's own tests run it) and ``apply_ops_jnp``
bit for bit on every opcode, except ``mac``: XLA may contract ``a*b + c``
into one fused multiply-add, so ``mac`` is held within 2 ulp.  The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its entry must refuse CPU tensors and its module
must import without ``nvcc``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sim_alu import sim_alu as jax_sim_alu
from repro.sim.lower import OP_INDEX, OPS
from repro.sim.step import apply_ops_jnp
from repro_torch.kernels import ref
from repro_torch.kernels.sim_alu import sim_alu, sim_alu_cuda
from repro_torch.sim.lower import OPS as TORCH_OPS

SHAPES = [(1, 1), (7, 129), (64, 256)]
#: every opcode plus one on each side of the valid range (those give 0.0)
CODES = list(range(-1, len(OPS) + 1))
MAC = OP_INDEX["mac"]


def _inputs(shape, seed):
    """Integer values in [-2**15, 2**15] with ~10% exact zeros, as float32."""
    rng = np.random.default_rng(seed)
    return [np.where(rng.random(shape) < 0.1, 0.0,
                     rng.integers(-2 ** 15, 2 ** 15 + 1, shape))
            .astype(np.float32) for _ in range(4)]


def _assert_alu_equal(got, want, opcode):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    exact = opcode != MAC
    np.testing.assert_array_equal(got.view(np.int32)[exact],
                                  want.view(np.int32)[exact])
    ulp = np.spacing(np.abs(want[~exact]))
    assert (np.abs(got[~exact] - want[~exact]) <= 2 * ulp).all()


def test_opcode_table_matches_jax():
    assert TORCH_OPS == OPS


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("code", CODES)
def test_plain_alu_matches_jax_per_opcode(shape, code):
    a, b, c, leaf = _inputs(shape, seed=code + 1)
    opcode = np.full(shape, code, dtype=np.int32)
    got = ref.sim_alu(*map(torch.from_numpy, (opcode, a, b, c, leaf)))
    jargs = [jnp.asarray(x) for x in (opcode, a, b, c, leaf)]
    _assert_alu_equal(got.numpy(), jax_sim_alu(*jargs, interpret=True),
                      opcode)
    _assert_alu_equal(got.numpy(), apply_ops_jnp(*jargs), opcode)
    if not 0 <= code < len(OPS):
        assert (got == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_alu_matches_jax_mixed_opcodes(shape):
    rng = np.random.default_rng(17)
    opcode = rng.integers(-1, len(OPS) + 1, shape).astype(np.int32)
    a, b, c, leaf = _inputs(shape, seed=18)
    got = ref.sim_alu(*map(torch.from_numpy, (opcode, a, b, c, leaf)))
    jargs = [jnp.asarray(x) for x in (opcode, a, b, c, leaf)]
    _assert_alu_equal(got.numpy(), jax_sim_alu(*jargs, interpret=True),
                      opcode)
    # the wrapper takes the plain version for CPU tensors
    wrapped = sim_alu(*map(torch.from_numpy, (opcode, a, b, c, leaf)))
    assert torch.equal(wrapped.view(torch.int32), got.view(torch.int32))


def test_cuda_entry_refuses_cpu_tensors():
    x = torch.zeros(2, 3)
    op = torch.zeros(2, 3, dtype=torch.int32)
    before = sim_alu_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        sim_alu_cuda(op, x, x, x, x)
    assert sim_alu_cuda.launches == before


def test_module_imports_without_nvcc(tmp_path):
    # no nvcc on PATH and a CUDA_HOME without one: importing the kernel
    # module (and the cycle loop that uses it) must still work, and only
    # the build itself reports the missing compiler
    code = (
        "import repro_torch.sim.step, repro_torch.kernels.sim_alu\n"
        "from repro_torch.kernels import _build\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', e)\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc:" in proc.stdout
