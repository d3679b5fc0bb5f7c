"""The batched simulator's cycle loop on tensors (port of the jnp backend
of ``repro/sim/step.py``: ``PackedBucket``, ``_jit_runner``,
``run_bucket_jnp``).

One call executes every cycle of every mapping in a bucket.  State is four
flat tensors on the bucket's device:

* ``val``   — produced values, ``B * (N+2) * I`` float32: node rows, a read
  sentinel row ``N`` (never written, reads 0.0) and a dump row ``N+1``
  whose last instance soaks up the masked-out scatters of every lane;
* ``done``  — which (node, iteration) values exist, same layout, bool;
* ``avail`` — which route-step reservations hold a readable value,
  ``B * (S+2) * I`` bool (step sentinel row ``S``, dump row ``S+1``);
* ``fail``  — sticky per-mapping read failure (missing operand or
  unrouted-edge read), exactly where the scalar oracle asserts.

Per cycle ``t``: phase 1 executes every node whose issue slot matches
(``(t - issue) % ii == 0``), gathering every operand before any write of
the cycle, so reads see state as of the start of the cycle; phase 2
commits the route-step writes that become readable at cycle ``t + 1``,
gated on the producer's value existing (it sees phase 1's writes).  This
is the scalar oracle's two-phase loop, vectorized over batch x nodes x
steps.

On a CUDA device the whole loop is one kernel launch,
:func:`repro_torch.kernels.sim_loop.sim_loop_cuda`: one block per mapping
runs every cycle of it, with block barriers where the eager loop has
implicit ones, and gives back the same state bit for bit.  On the CPU the
loop runs eagerly (:func:`run_bucket_eager`), its ALU stage through
:func:`repro_torch.kernels.sim_alu.sim_alu`, which is the plain version
there.  The eager loop also runs on the card when called explicitly, with
the ``sim_alu`` kernel as its ALU: about seventy small launches per cycle
plus the kernel's one, bound by host dispatch (``PERF.md``); it is the
yardstick the fused kernel is held and timed against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.sim_alu import sim_alu
from repro_torch.kernels.sim_loop import STATICS, sim_loop_cuda
from repro_torch.sim.lower import K_BROKEN, K_FEED, K_ROUTED

#: step_abs padding: far enough out that no in-horizon cycle matches
NEVER = 1 << 30

_FIELDS = ("ii", "horizon", "opcode", "exec_mask", "issue", "compare",
           "leaf", "ref", "op_kind", "op_src", "op_dist", "op_feed",
           "op_steps", "step_src", "step_abs")


@dataclass
class PackedBucket:
    """A batch of same-shape-padded ``CompiledSim`` forms (see
    :func:`repro_torch.sim.batch.pack_bucket`) as numpy arrays, plus the
    device the cycle loop runs on.  Sentinel conventions: ``op_src`` /
    ``step_src`` use row ``N`` (never written, reads 0.0 / not-done),
    ``op_steps`` uses step row ``S`` (never available), padded steps carry
    ``step_abs = NEVER``."""

    iterations: int
    hmax: int
    ii: np.ndarray         # (B,)   int32
    horizon: np.ndarray    # (B,)   int32
    opcode: np.ndarray     # (B,N)  int32
    exec_mask: np.ndarray  # (B,N)  bool
    issue: np.ndarray      # (B,N)  int32
    compare: np.ndarray    # (B,N)  bool
    leaf: np.ndarray       # (B,N)  f64
    ref: np.ndarray        # (B,N,I) f64
    op_kind: np.ndarray    # (B,N,K) int8
    op_src: np.ndarray     # (B,N,K) int32 (sentinel N)
    op_dist: np.ndarray    # (B,N,K) int32
    op_feed: np.ndarray    # (B,N,K) f64
    op_steps: np.ndarray   # (B,N,K,M) int32 (sentinel S)
    step_src: np.ndarray   # (B,S)  int32 (sentinel N)
    step_abs: np.ndarray   # (B,S)  int32 (pad NEVER)
    device: torch.device   # where the cycle loop runs

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        b, n, k, m = self.op_steps.shape
        return b, n, k, m, self.step_src.shape[1]

    @classmethod
    def from_numpy(cls, arrays: Dict[str, object],
                   device: torch.device) -> "PackedBucket":
        """Build from the ``vars()`` of a JAX-side ``PackedBucket`` (its
        numpy arrays, ``iterations`` and ``hmax``; other keys ignored)."""
        return cls(iterations=int(arrays["iterations"]),
                   hmax=int(arrays["hmax"]),
                   device=torch.device(device),
                   **{f: np.asarray(arrays[f]) for f in _FIELDS})


def _floordiv(x, y):
    return torch.div(x, y, rounding_mode="floor")


def _statics(pb: PackedBucket) -> Dict[str, object]:
    """Per-bucket constants of the cycle loop, on ``pb.device``: flat
    gather/scatter bases (int64, as ``torch.take`` and indexing need) and
    the float32 inputs."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    dev = pb.device

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    bidx = torch.arange(B, device=dev, dtype=torch.int64)
    op_kind = t(pb.op_kind, torch.int8)
    return {
        "I": I,
        "iiB": t(pb.ii)[:, None],
        "horB": t(pb.horizon)[:, None],
        "opcode": t(pb.opcode, torch.int32),
        "exec_mask": t(pb.exec_mask, torch.bool),
        "issue": t(pb.issue),
        "leaf": t(pb.leaf, torch.float32),
        "op_dist": t(pb.op_dist),
        "op_feed": t(pb.op_feed, torch.float32),
        "routed": op_kind == K_ROUTED,
        "broken": op_kind == K_BROKEN,
        "feed": op_kind == K_FEED,
        "step_abs": t(pb.step_abs),
        "node_base": (bidx[:, None] * (N + 2)
                      + torch.arange(N, device=dev)[None, :]) * I,
        "dump": (B * (N + 2) - 1) * I,  # last mapping's dump row, iter 0
        "src_base": (bidx[:, None, None] * (N + 2) + t(pb.op_src)) * I,
        "step_read_base": (bidx[:, None, None, None] * (S + 2)
                           + t(pb.op_steps)) * I,
        "wsrc_base": (bidx[:, None] * (N + 2) + t(pb.step_src)) * I,
        "wstep_base": (bidx[:, None] * (S + 2)
                       + torch.arange(S, device=dev)[None, :]) * I,
        "wdump": (B * (S + 2) - 1) * I,
    }


def _cycle(s: Dict[str, object], t: int, val, done, avail, fail):
    """Advance the state tensors by cycle ``t`` in place; returns the
    phase-1 and phase-2 scatter indices (the dump slots ``s["dump"]`` /
    ``s["wdump"]`` are the only ones that may repeat)."""
    I, iiB, horB = s["I"], s["iiB"], s["horB"]
    issue = s["issue"]
    # -- phase 1: execute (every gather precedes every write) --------------
    d = t - issue
    q = _floordiv(d, iiB)
    act = (s["exec_mask"] & (issue <= t) & (t < horB)
           & (d - q * iiB == 0) & (q < I))
    itq = torch.where(act, q, 0)
    want = itq[:, :, None] - s["op_dist"]
    needs = want >= 0
    in_range = needs & (want < I)
    wc = want.clamp(0, I - 1)
    vr = torch.take(val, s["src_base"] + wc)
    present = torch.take(avail, s["step_read_base"] + wc[..., None]).any(3)
    actk = act[:, :, None]
    routed = s["routed"]
    fail |= (actk & routed & needs & ~(present & in_range)).flatten(1).any(1)
    fail |= (actk & s["broken"] & needs).flatten(1).any(1)
    itf = itq.to(torch.float32)
    opv = torch.where(routed & in_range, vr, 0.0)
    opv = torch.where(s["feed"], s["op_feed"] + itf[:, :, None], opv)
    opv = opv[:, :, :3].permute(2, 0, 1).contiguous()  # (3, B, N)
    newv = sim_alu(s["opcode"], opv[0], opv[1], opv[2], s["leaf"] + itf)
    idx = torch.where(act, s["node_base"] + itq, s["dump"]).flatten()
    val[idx] = newv.flatten()
    done[idx] = True
    # -- phase 2: route-step writes readable at t + 1 ----------------------
    kd = (t + 1) - s["step_abs"]
    kq = _floordiv(kd, iiB)
    wok = (kd - kq * iiB == 0) & (kq >= 0) & (kq < I) & (t < horB)
    kqc = torch.where(wok, kq, 0)
    fire = wok & torch.take(done, s["wsrc_base"] + kqc)
    widx = torch.where(fire, s["wstep_base"] + kqc, s["wdump"]).flatten()
    avail[widx] = True
    return idx, widx


def _kernel_statics(pb: PackedBucket) -> Dict[str, torch.Tensor]:
    """The bucket's arrays in the dtypes of
    :data:`repro_torch.kernels.sim_loop.STATICS`, on ``pb.device`` (float64
    rounds to float32 on the host, to nearest, as the eager loop's cast
    does on the device)."""
    return {name: torch.as_tensor(getattr(pb, name)).to(dtype).contiguous()
            .to(pb.device) for name, (dtype, _) in STATICS.items()}


def _result(pb: PackedBucket, val, done, fail):
    """``(val (B,N,I) f64, done, fail)`` as numpy from the flat state."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    val = val.view(B, N + 2, I)[:, :N, :]
    done = done.view(B, N + 2, I)[:, :N, :]
    return (val.cpu().numpy().astype(np.float64), done.cpu().numpy(),
            fail.cpu().numpy())


def run_bucket(pb: PackedBucket):
    """Run every cycle of the bucket on ``pb.device``: one launch of the
    ``sim_loop`` kernel on a CUDA device, the eager loop on the CPU.
    Returns ``(val (B,N,I) f64, done (B,N,I) bool, fail (B,) bool)`` as
    numpy; ``val`` is float32 widened to float64 (compare under
    ``F32_TOL``) and ``fail`` marks read failures only (the final
    comparison against the reference is the caller's)."""
    if pb.device.type == "cpu":
        return run_bucket_eager(pb)
    val, done, fail = sim_loop_cuda(_kernel_statics(pb), pb.iterations)
    return _result(pb, val, done, fail)


def run_bucket_eager(pb: PackedBucket):
    """The eager cycle loop on ``pb.device``, ``pb.hmax`` cycles of small
    tensor ops with :func:`~repro_torch.kernels.sim_alu.sim_alu` as the ALU
    stage (the plain version on the CPU, the kernel on a card).  Returns
    what :func:`run_bucket` returns."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    dev = pb.device
    s = _statics(pb)
    val = torch.zeros(B * (N + 2) * I, dtype=torch.float32, device=dev)
    done = torch.zeros(B * (N + 2) * I, dtype=torch.bool, device=dev)
    avail = torch.zeros(B * (S + 2) * I, dtype=torch.bool, device=dev)
    fail = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(pb.hmax):
        _cycle(s, t, val, done, avail, fail)
    return _result(pb, val, done, fail)
