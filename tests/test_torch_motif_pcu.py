"""The port's PCU kernel entry and its ``ops`` dispatchers vs the JAX
package, on the CPU.

The plain ``repro_torch.kernels.ref.motif_pcu``, the wrapper
``repro_torch.kernels.motif_pcu.motif_pcu`` and ``repro_torch.kernels.ops.
motif_pcu`` given CPU tensors must agree with the Pallas kernel run in
interpret mode (``repro.kernels.ops.motif_pcu``) and with the JAX oracle
(``repro.kernels.ref.motif_pcu``) under ``tests/test_kernels.py``'s
rtol/atol 1e-5 (XLA and PyTorch may differ in the sign of a zero from
max/min).  In bfloat16 only the Pallas kernel computes the port's function
(a float32 table, cast once); the oracle rounds every step.  The port's
``DFG.add`` + ``DFG.eval`` (Track A) must give the table exactly.  The CUDA
kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its entry must refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dfg import DFG as JaxDFG
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.dfg import DFG
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_swiglu import fused_swiglu_cuda
from repro_torch.kernels.motif_pcu import (FANIN, FANOUT, MAX_SLOTS, UNICAST,
                                           check_schedule, motif_pcu,
                                           motif_pcu_cuda, random_schedule)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

SCHEDULES = {"fanin": FANIN, "fanout": FANOUT, "unicast": UNICAST}
#: tests/test_kernels.py's motif tolerance, and its float32 one for the rest
MOTIF_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=2e-4, atol=2e-3)
#: one bfloat16 ulp (2**-7 of a value) plus a little near zero
BF16_TOL = dict(rtol=1e-2, atol=5e-3)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _inputs(shape, seed, low=None):
    """Standard normal float32, or uniform in [low, -low]."""
    rng = np.random.default_rng(seed)
    if low is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(low, -low, shape).astype(np.float32)


def test_canonical_schedules_match_jax_package():
    from repro.kernels import motif_pcu as jax_mp

    assert (FANIN, FANOUT, UNICAST) == (jax_mp.FANIN, jax_mp.FANOUT,
                                        jax_mp.UNICAST)
    assert list(ref.PCU_OPS) == list(jax_ref.PCU_OPS)


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("N", [256, 2048])
def test_motif_pcu_matches_jax(name, N):
    sched = SCHEDULES[name]
    x = _inputs((3, N), seed=N)
    want_ref = jax_ref.motif_pcu(sched, 3, jnp.asarray(x))
    want_pallas = jax_ops.motif_pcu(jnp.asarray(x), schedule=sched,
                                    n_inputs=3, block_n=min(N, 1024))
    t = torch.from_numpy(x)
    for got in (ref.motif_pcu(sched, 3, t), motif_pcu(sched, 3, t),
                ops.motif_pcu(t, schedule=sched, n_inputs=3)):
        assert got.dtype == torch.float32 and got.shape == (6, N)
        _close(got, want_ref, **MOTIF_TOL)
        _close(got, want_pallas, **MOTIF_TOL)


@pytest.mark.parametrize("name", SCHEDULES)
def test_motif_pcu_bfloat16_matches_pallas(name):
    sched = SCHEDULES[name]
    x = jnp.asarray(_inputs((3, 2048), seed=5), jnp.bfloat16)
    want = jax_ops.motif_pcu(x, schedule=sched, n_inputs=3)
    t = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    for got in (motif_pcu(sched, 3, t),
                ops.motif_pcu(t, schedule=sched, n_inputs=3)):
        assert got.dtype == torch.bfloat16 and got.shape == (6, 2048)
        _close(got, want, **BF16_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_schedules_match_jax_oracle(seed):
    steps = (16, 40, 64)[seed]
    sched = random_schedule(seed, n_inputs=3, steps=steps)
    x = _inputs((3, 1000), seed=seed, low=-100.0)
    got = motif_pcu(sched, 3, torch.from_numpy(x))
    want = jax_ref.motif_pcu(sched, 3, jnp.asarray(x))
    assert got.shape == (3 + steps, 1000)
    assert torch.isfinite(got).all()
    _close(got, want, **MOTIF_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_schedule_covers_the_rules(seed):
    steps = (16, 40, 64)[seed]
    sched = random_schedule(seed, n_inputs=3, steps=steps)
    n_slots = 3 + steps
    assert len(sched) == steps and check_schedule(
        sched, 3, torch.zeros(3, 1)) == sched
    assert {op for _, op, _, _ in sched} == set(ref.PCU_OPS)
    dsts = [dst for dst, _, _, _ in sched]
    assert len(set(dsts)) < len(dsts)  # a slot written twice
    assert min(dsts) < 3  # an input slot overwritten
    written = set()
    read_early = False
    for dst, _, a, b in sched:
        read_early |= any(s >= 3 and s not in written and s in dsts
                          for s in (a, b))
        written.add(dst)
    assert read_early  # a slot read before a later step writes it
    assert max(dsts) < n_slots


def test_unwritten_slot_reads_zero():
    sched = ((4, "add", 3, 0), (3, "mul", 0, 1))
    x = torch.tensor([[2.0], [5.0], [7.0]])
    got = motif_pcu(sched, 3, x)
    assert got[:, 0].tolist() == [2.0, 5.0, 7.0, 10.0, 2.0]


def _ops_case(row):
    """A row of ``benchmarks/run.py``'s kernel table: the JAX ``ops`` call,
    the port's ``ops`` call on the same numpy-seeded inputs, the tolerance."""
    rng = np.random.default_rng(0)

    def pair(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    (x, tx), (w1, tw1), (w3, tw3) = (pair((128, 256)), pair((256, 128)),
                                     pair((256, 128)))
    (s, ts), (q, tq), (m, tm) = pair((256,)), pair((2, 128, 64)), pair((3, 1024))
    return {
        "fused_swiglu": (lambda: jax_ops.fused_swiglu(x, w1, w3),
                         lambda: ops.fused_swiglu(tx, tw1, tw3), F32_TOL),
        "rmsnorm": (lambda: jax_ops.rmsnorm(x, s),
                    lambda: ops.rmsnorm(tx, ts), F32_TOL),
        "flash_attention": (
            lambda: jax_ops.flash_attention(q, q, q, block_q=64, block_k=64),
            lambda: ops.flash_attention(tq, tq, tq, block_q=64, block_k=64),
            F32_TOL),
        "motif_pcu": (
            lambda: jax_ops.motif_pcu(m, schedule=FANIN, n_inputs=3),
            lambda: ops.motif_pcu(tm, schedule=FANIN, n_inputs=3),
            MOTIF_TOL),
    }[row]


@pytest.mark.parametrize("row", ["fused_swiglu", "rmsnorm", "flash_attention",
                                 "motif_pcu"])
def test_ops_rows_match_jax_ops(row):
    """The four kernel rows of ``benchmarks/run.py`` at its shapes."""
    want, got, tol = _ops_case(row)
    before = (fused_swiglu_cuda.launches, rmsnorm_cuda.launches,
              flash_attention_cuda.launches, motif_pcu_cuda.launches)
    out = got()
    _close(out, want(), **tol)
    # the CPU runs the plain versions: no kernel launch is counted
    assert (fused_swiglu_cuda.launches, rmsnorm_cuda.launches,
            flash_attention_cuda.launches, motif_pcu_cuda.launches) == before


@pytest.mark.parametrize("bad", [0, -1, 1.5, True, "64"])
def test_ops_refuse_bad_block_keywords(bad):
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="positive int"):
        ops.fused_swiglu(x, torch.ones(8, 8), torch.ones(8, 8), block_m=bad)
    with pytest.raises(ValueError, match="positive int"):
        ops.rmsnorm(x, torch.ones(8), block_m=bad)
    with pytest.raises(ValueError, match="positive int"):
        ops.flash_attention(x[None], x[None], x[None], block_k=bad)
    with pytest.raises(ValueError, match="positive int"):
        ops.motif_pcu(torch.ones(3, 4), schedule=FANIN, n_inputs=3,
                      block_n=bad)


def test_ops_take_any_n():
    """The Pallas wrapper asserts N % block_n == 0; the port takes any N."""
    x = _inputs((3, 1000), seed=9)
    got = ops.motif_pcu(torch.from_numpy(x), schedule=FANOUT, n_inputs=3,
                        block_n=512)
    _close(got, jax_ref.motif_pcu(FANOUT, 3, jnp.asarray(x)), **MOTIF_TOL)


def _track_a(sched):
    """The DFG of a canonical schedule: three inputs, then one node per
    step fed by its two source slots (node id = slot)."""
    g = DFG()
    for _ in range(3):
        g.add("input")
    for dst, op, a, b in sched:
        assert g.add(op, inputs=[a, b]) == dst
    return g


@pytest.mark.parametrize("name", SCHEDULES)
def test_motif_pcu_matches_track_a_semantics(name):
    """Over 64 iterations, each with its own inputs (``DFG.eval``'s default
    leaves ``it + 1 + nid % 5``), the table equals the Track-A interpreter's
    history, and the port's interpreter equals the JAX package's."""
    sched = SCHEDULES[name]
    g = _track_a(sched)
    hist = g.eval({}, iterations=64)
    x = torch.tensor([[float(it + 1 + i % 5) for it in range(64)]
                      for i in range(3)])
    table = ops.motif_pcu(x, schedule=sched, n_inputs=3, block_n=1)
    for nid in g.nodes:
        assert table[nid].tolist() == hist[nid]
    jg = JaxDFG()
    for _ in range(3):
        jg.add("input")
    for dst, op, a, b in sched:
        jg.add(op, inputs=[a, b])
    assert jg.eval({}, iterations=64) == hist
    # the original single-iteration tie
    h1 = g.eval({0: 2.0, 1: 3.0, 2: 4.0}, iterations=1)
    t1 = motif_pcu(sched, 3, torch.tensor([[2.0], [3.0], [4.0]]))
    assert [float(v) for v in t1[:, 0]] == [h1[n][0] for n in range(6)]


def test_dfg_add_after_from_json_takes_a_fresh_id():
    g = _track_a(FANIN)
    h = DFG.from_json(g.to_json())
    nid = h.add("add", inputs=[5, 0])
    assert nid == 6 and len(h.nodes) == 7
    assert h.nodes[0].op == "input"  # node 0 kept
    jh = JaxDFG.from_json(g.to_json())
    assert jh.add("add", inputs=[5, 0]) == nid
    with pytest.raises(ValueError, match="unknown DFG op"):
        h.add("fma")


@pytest.mark.parametrize("sched,n_inputs,shape,match", [
    (FANIN, 2, (3, 8), "n_inputs=2"),
    (FANIN, 3, (3, 0), "N >= 1"),
    (((6, "add", 0, 1),), 3, (3, 8), "dst < n_slots"),
    (((3, "add", 3, 1),), 3, (3, 8), "a, b < dst"),
    (((3, "add", 0, 4),), 3, (3, 8), "a, b < dst"),
    (((3, "add", -1, 1),), 3, (3, 8), "0 <= a"),
    (((3, "fma", 0, 1),), 3, (3, 8), "op must be one of"),
], ids=["n_inputs", "empty_n", "dst", "a", "b", "negative", "op"])
def test_schedule_rules_raise_value_error(sched, n_inputs, shape, match):
    x = torch.ones(shape)
    with pytest.raises(ValueError, match=match):
        motif_pcu(sched, n_inputs, x)
    with pytest.raises(ValueError, match=match):
        ops.motif_pcu(x, schedule=sched, n_inputs=n_inputs)
    with pytest.raises(ValueError):
        motif_pcu_cuda(sched, n_inputs, x)


def test_cuda_entry_refuses_cpu_tensors():
    before = motif_pcu_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        motif_pcu_cuda(FANIN, 3, torch.ones(3, 8))
    assert motif_pcu_cuda.launches == before
    assert MAX_SLOTS * 256 * 4 + MAX_SLOTS * 16 <= 232448 < \
        (MAX_SLOTS + 1) * (256 * 4 + 16)
