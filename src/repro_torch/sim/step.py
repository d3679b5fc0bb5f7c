"""The batched simulator's cycle loops (port of ``repro/sim/step.py``:
``PackedBucket``, the jnp backend's ``_jit_runner`` / ``run_bucket_jnp`` on
tensors, and the numpy backend's ``run_bucket_numpy``).

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

:func:`run_bucket_numpy` is the JAX package's float64 host loop, copied
line for line (its static-availability fast path: ``done`` and ``fail``
are timing functions computed once, and only values propagate cycle by
cycle).  It gives the reference's ``val``/``done``/``fail`` bit for bit
and runs only when a caller asks for the ``numpy`` backend
(:func:`repro_torch.sim.batch.select_backend`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.sim_alu import sim_alu
from repro_torch.kernels.sim_loop import STATICS, sim_loop_cuda
from repro_torch.sim.lower import K_BROKEN, K_FEED, K_ROUTED, OPS

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
    #: the numpy backend's derived-data memo (static predicates, event
    #: schedule), so its warm reruns skip every precomputation
    cache: Dict[str, object] = field(
        default_factory=dict, repr=False, compare=False)

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


# -- numpy backend (float64, on the host) ----------------------------------


def _np_alu(code: int, a, b, c, leaf):
    op = OPS[code]
    if op in ("const", "input", "load"):
        return leaf
    if op in ("store", "output"):
        return a
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "mac":
        return a * b + c
    if op == "shl":
        return a * 2.0
    if op == "shr":
        return a / 2.0
    if op == "and":
        return (a.astype(np.int64) & b.astype(np.int64)).astype(np.float64)
    if op == "or":
        return (a.astype(np.int64) | b.astype(np.int64)).astype(np.float64)
    if op == "xor":
        return (a.astype(np.int64) ^ b.astype(np.int64)).astype(np.float64)
    if op == "not":
        return (~a.astype(np.int64) & 0xFFFF).astype(np.float64)
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    if op == "abs":
        return np.abs(a)
    if op == "cmp":
        return (a > b).astype(np.float64)
    if op == "select":
        return np.where(a != 0.0, b, c)
    raise ValueError(op)


def _np_static(pb: PackedBucket):
    """One-time static predicates (derivation in the module docstring):
    ``done`` (B,N,I) — a pure timing function — and ``fail`` (B,) — every
    read-failure check hoisted out of the cycle loop."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    ii3 = pb.ii[:, None, None]
    hor3 = pb.horizon[:, None, None]
    routed = pb.op_kind == K_ROUTED
    broken = pb.op_kind == K_BROKEN

    it_r = np.arange(I, dtype=np.int32)
    done = pb.exec_mask[:, :, None] & (
        pb.issue[:, :, None] + it_r * ii3 < hor3)                # (B,N,I)

    b2 = np.arange(B)[:, None]
    exec_pad = np.concatenate(
        [pb.exec_mask, np.zeros((B, 1), dtype=bool)], axis=1)    # (B,N+1)
    issue_pad = np.concatenate(
        [pb.issue, np.zeros((B, 1), dtype=np.int32)], axis=1)
    # a step holds iteration k's value iff its producer committed before
    # the write cycle: exec(src) and issue_src < step_abs (sentinel row N
    # is never exec; padded steps carry step_abs = NEVER)
    step_ok = (exec_pad[b2, pb.step_src]
               & (issue_pad[b2, pb.step_src] < pb.step_abs))     # (B,S)
    sa_pad = np.concatenate(
        [pb.step_abs, np.full((B, 1), NEVER, dtype=np.int32)], axis=1)
    so_pad = np.concatenate(
        [step_ok, np.zeros((B, 1), dtype=bool)], axis=1)
    b4 = np.arange(B)[:, None, None, None]
    sa = sa_pad[b4, pb.op_steps]                                 # (B,N,K,M)
    so = so_pad[b4, pb.op_steps]
    # presence is iteration-independent: arrival step_abs + (it-dist)*ii
    # <= read cycle issue_dst + it*ii  ⇔  step_abs <= issue_dst + dist*ii
    deadline = pb.issue[:, :, None] + pb.op_dist * ii3           # (B,N,K)
    ok_col = ((sa <= deadline[:, :, :, None]) & so).any(axis=3)
    # the first needy read is iteration `dist`; it happens iff that
    # execution lands inside the horizon (deadline is exactly its cycle)
    reads = (pb.exec_mask[:, :, None] & (pb.op_dist < I)
             & (deadline < hor3))
    fail = (reads & (broken | (routed & ~ok_col))).any(axis=(1, 2))
    return done, fail


def _np_schedule(pb: PackedBucket):
    """One-time event schedule for the value recurrence: every (mapping,
    node, iteration) execution becomes an event with prebuilt gather /
    scatter indices into one flat buffer, sorted by (cycle, opcode) and
    grouped into per-cycle opcode segments.

    Buffer layout: ``[0, V)`` node values (b, node-row incl. the 0.0
    sentinel row N, iter; reset each run), ``[V, V+P)`` the static feed
    pool (const/input operand values per (b, n, k, it)), ``[V+P]`` a 0.0
    slot for absent / pre-loop operands."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    ii3 = pb.ii[:, None, None]
    hor3 = pb.horizon[:, None, None]
    routed = pb.op_kind == K_ROUTED
    feed = pb.op_kind == K_FEED
    it_r = np.arange(I, dtype=np.int32)
    V = B * (N + 1) * I
    P = B * N * K * I

    t_ev = pb.issue[:, :, None] + it_r * ii3                     # (B,N,I)
    valid = pb.exec_mask[:, :, None] & (t_ev < hor3)
    node_flat = ((np.arange(B)[:, None] * (N + 1)
                  + np.arange(N)[None, :])[:, :, None] * I + it_r)

    src_base = (np.arange(B)[:, None, None] * (N + 1)
                + pb.op_src) * I                                 # (B,N,K)
    want = it_r[None, None, None, :] - pb.op_dist[:, :, :, None]  # (B,N,K,I)
    rd = src_base[:, :, :, None] + want
    feed_idx = V + np.arange(P, dtype=np.int64).reshape(B, N, K, I)
    idx_full = np.where(routed[..., None] & (want >= 0), rd,
                        np.where(feed[..., None], feed_idx, V + P))
    feedpool = (pb.op_feed[:, :, :, None] + it_r).ravel()

    mask = valid.ravel()
    t_flat = t_ev.ravel()[mask]
    code_flat = np.broadcast_to(
        pb.opcode[:, :, None], (B, N, I)).ravel()[mask]
    gidx = idx_full.transpose(0, 1, 3, 2).reshape(B * N * I, K)[:, :3][mask]
    widx = node_flat.ravel()[mask]
    leafv = (pb.leaf[:, :, None] + it_r).ravel()[mask]

    order = np.lexsort((code_flat, t_flat))
    t_s = t_flat[order]
    code_s = code_flat[order]
    gidx = np.ascontiguousarray(gidx[order])
    widx = np.ascontiguousarray(widx[order])
    leafv = np.ascontiguousarray(leafv[order])

    # cycles: [(clo, chi, [(opcode, lo, hi), ...]), ...] in cycle order
    cycles = []
    E = len(t_s)
    if E:
        seg_key = t_s.astype(np.int64) * len(OPS) + code_s
        starts = np.concatenate(
            ([0], np.flatnonzero(np.diff(seg_key) != 0) + 1, [E]))
        cur_t = None
        for a0, a1 in zip(starts[:-1], starts[1:]):
            t = int(t_s[a0])
            if t != cur_t:
                cycles.append((int(a0), [a1], []))
                cur_t = t
            cycles[-1][1][0] = int(a1)
            cycles[-1][2].append((int(code_s[a0]), int(a0), int(a1)))
        cycles = [(lo, hi[0], segs) for lo, hi, segs in cycles]

    buf = np.zeros(V + P + 1, dtype=np.float64)
    buf[V:V + P] = feedpool
    return {"V": V, "buf": buf, "gidx": gidx, "widx": widx,
            "leaf": leafv, "cycles": cycles}


def run_bucket_numpy(pb: PackedBucket):
    """Returns ``(val (B,N,I) f64, done (B,N,I) bool, fail (B,) bool)``;
    ``fail`` marks read failures only (final ref comparison is the
    caller's, under its tolerance policy).

    Static-availability fast path: ``done``/``fail`` and the event
    schedule are computed once per bucket (memoized on ``pb.cache``); a
    run is one operand gather plus a few opcode-segment ALU calls per
    cycle — reads still see start-of-cycle state because each cycle's
    gather happens before any of its writes."""
    B, N, K, M, S = pb.shape
    I = pb.iterations
    static = pb.cache.get("np_static")
    if static is None:
        static = pb.cache["np_static"] = _np_static(pb)
    done, fail = static
    sched = pb.cache.get("np_sched")
    if sched is None:
        sched = pb.cache["np_sched"] = _np_schedule(pb)

    buf = sched["buf"]
    V = sched["V"]
    buf[:V] = 0.0
    gidx, widx, leafv = sched["gidx"], sched["widx"], sched["leaf"]
    for clo, chi, segs in sched["cycles"]:
        vals = buf[gidx[clo:chi]]                                # (E,3)
        a, b, c = vals[:, 0], vals[:, 1], vals[:, 2]
        for code, lo, hi in segs:
            buf[widx[lo:hi]] = _np_alu(
                code, a[lo - clo:hi - clo], b[lo - clo:hi - clo],
                c[lo - clo:hi - clo], leafv[lo:hi])
    val = buf[:V].reshape(B, N + 1, I)[:, :N, :].copy()
    return val, done, fail
