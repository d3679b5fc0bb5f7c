"""``simulate_batch`` — verify many mappings per vectorized call (port of
``repro/sim/batch.py``).

Lowered mappings are padded into one bucket, packed into dense arrays, and
the whole bucket runs through one call of the cycle loop
(:func:`repro_torch.sim.step.run_bucket`) on the card — or on the CPU when
the caller passes ``device="cpu"``, or through the JAX package's float64
host loop (:func:`repro_torch.sim.step.run_bucket_numpy`) when the caller
asks for ``backend="numpy"`` (:func:`select_backend`).  Each mapping gets
a :class:`SimVerdict` with the same accept/reject decision — and, on
accept, the same ``(node, iter) -> value`` map within the backend's
tolerance (``F32_TOL`` for the tensor loop, ``DEFAULT_TOL`` for numpy) —
as the scalar oracle.  Mappings the lowering cannot express
(:class:`LoweringUnsupported`) run through the scalar oracle itself,
inside the same call.

Packing: one bucket per call.  Mappings pad to the batch max in every
dimension (node/step counts round up to a power of two); the per-mapping
``horizon`` masks the tail cycles of shorter members.

Lowering is the expensive half of a cold call (it includes one
``dfg.eval`` per mapping), so it is exposed separately:
:func:`prepare_batch` lowers + packs once, and ``simulate_batch(...,
prepared=...)`` reruns only the cycle loop on the cached
:class:`PreparedBatch`.

A fault of the device path (a kernel that does not build or launch, a
CUDA error) raises; nothing degrades to the CPU or the scalar oracle.  The
``sim.batch`` fault-injection site (``REPRO_FAULTS``,
:mod:`repro_torch.compiler.faultinject`) fires at entry, so chaos tests
can fault the batched path; its ``OSError`` propagates like any other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compiler import faultinject
from repro_torch.device import resolve_device
from repro_torch.sim.check import Tolerance, close_array, tolerance_for
from repro_torch.sim.lower import CompiledSim, LoweringUnsupported, lower_mapping
from repro_torch.sim.step import (NEVER, PackedBucket, run_bucket,
                                  run_bucket_numpy)

#: the one backend a caller may name: numpy's float64 host loop.  Without
#: it the float32 tensor loop runs on the caller's device (``sim_loop`` on
#: a card), labelled by that device's type, ``cuda`` or ``cpu``.
BACKENDS = ("numpy",)


def select_backend(backend: Optional[str] = None, device=None) -> str:
    """What runs the cycle loop: ``numpy`` when the caller asks for it,
    else the tensor loop on ``device``
    (:func:`~repro_torch.device.resolve_device`: ``cuda`` unless the caller
    asks for the CPU, raising when CUDA is absent), labelled ``cuda`` or
    ``cpu``.  A label this function returned may be passed back as
    ``backend``.  A ``backend`` that disagrees with ``device`` is refused
    (``ValueError``), never resolved in favour of one.  Nothing is read
    from the environment: the JAX package's ``REPRO_SIM_BACKEND`` names
    its own backends, and the host runs only when asked."""
    if backend is None:
        return resolve_device(device).type
    if backend not in BACKENDS + ("cuda", "cpu"):
        raise ValueError(f"unknown sim backend {backend!r} (choose from "
                         f"{', '.join(BACKENDS)}, or pass a device)")
    want = "cpu" if backend == "numpy" else backend
    if device is not None and torch.device(device).type != want:
        raise ValueError(f"sim backend {backend!r} does not run on "
                         f"{device}")
    if backend != "numpy":
        resolve_device(device if device is not None else backend)
    return backend


def bucket_device(backend: str, device=None) -> torch.device:
    """Where a bucket for ``backend`` (a :func:`select_backend` label)
    lives: the host for ``numpy``, else ``device`` or the backend's own
    device."""
    if backend == "numpy":
        return torch.device("cpu")
    return resolve_device(device if device is not None else backend)


class SimVerdict:
    """One mapping's batched-verification outcome.

    ``values`` materializes lazily: the ``(node, iter) -> value`` dict is
    built from the dense result on first access, so throughput paths that
    only consume verdicts never pay for dict construction."""

    __slots__ = ("ok", "reason", "backend", "_values", "_thunk")

    def __init__(self, ok: bool, reason: Optional[str] = None,
                 values: Optional[Dict[Tuple[int, int], float]] = None,
                 backend: str = "cuda", values_thunk=None):
        self.ok = ok
        self.reason = reason                  # None iff ok
        self.backend = backend                # "cuda"/"cpu"/"numpy"/"scalar"
        self._values = values
        self._thunk = values_thunk

    @property
    def values(self) -> Optional[Dict[Tuple[int, int], float]]:
        if self._values is None and self._thunk is not None:
            self._values = self._thunk()
            self._thunk = None
        return self._values

    def __repr__(self) -> str:
        return (f"SimVerdict(ok={self.ok!r}, reason={self.reason!r}, "
                f"backend={self.backend!r})")


class BatchResult(list):
    """``list[SimVerdict]`` plus run metadata (backend, wall seconds,
    bucket count, scalar fallbacks)."""

    backend: str = "cuda"
    wall_s: float = 0.0
    n_buckets: int = 0
    n_scalar_fallback: int = 0

    @property
    def mappings_per_s(self) -> float:
        return len(self) / self.wall_s if self.wall_s > 0 else 0.0


def _pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def pack_bucket(forms: List[CompiledSim], device=None) -> PackedBucket:
    """Pad a batch's ``CompiledSim`` forms to common shape and stack, for
    the cycle loop on ``device`` (resolved by
    :func:`~repro_torch.device.resolve_device`).

    Node and step counts round up to a power of two (floors 8 / 16).
    Sentinels (see :mod:`repro_torch.sim.step`): absent operand sources
    and padded step producers point at node row ``N`` (reads 0.0, never
    done); unmatched/padded step slots point at step row ``S`` (never
    available); padded steps get ``step_abs = NEVER`` so no cycle fires
    them."""
    device = resolve_device(device)
    B = len(forms)
    I = forms[0].iterations
    N = _pow2(max(max(cs.n_nodes for cs in forms), 8))
    S = _pow2(max(max(cs.n_steps for cs in forms), 16))
    K = max(cs.n_operands for cs in forms)
    M = max(cs.n_matches for cs in forms)
    hmax = max(cs.horizon for cs in forms)

    ii = np.ones(B, dtype=np.int32)
    horizon = np.zeros(B, dtype=np.int32)
    opcode = np.zeros((B, N), dtype=np.int32)
    exec_mask = np.zeros((B, N), dtype=bool)
    issue = np.zeros((B, N), dtype=np.int32)
    compare = np.zeros((B, N), dtype=bool)
    leaf = np.zeros((B, N), dtype=np.float64)
    ref = np.zeros((B, N, I), dtype=np.float64)
    op_kind = np.zeros((B, N, K), dtype=np.int8)
    op_src = np.full((B, N, K), N, dtype=np.int32)
    op_dist = np.zeros((B, N, K), dtype=np.int32)
    op_feed = np.zeros((B, N, K), dtype=np.float64)
    op_steps = np.full((B, N, K, M), S, dtype=np.int32)
    step_src = np.full((B, S), N, dtype=np.int32)
    step_abs = np.full((B, S), NEVER, dtype=np.int32)

    for b, cs in enumerate(forms):
        n, s = cs.n_nodes, cs.n_steps
        k, m = cs.n_operands, cs.n_matches
        ii[b] = cs.ii
        horizon[b] = cs.horizon
        opcode[b, :n] = cs.opcode
        exec_mask[b, :n] = cs.exec_mask
        issue[b, :n] = cs.issue
        compare[b, :n] = cs.compare
        leaf[b, :n] = cs.leaf_base
        ref[b, :n, :] = cs.ref
        op_kind[b, :n, :k] = cs.op_kind
        op_src[b, :n, :k] = np.where(cs.op_src >= 0, cs.op_src, N)
        op_dist[b, :n, :k] = cs.op_dist
        op_feed[b, :n, :k] = cs.op_feed
        op_steps[b, :n, :k, :m] = np.where(cs.op_steps >= 0, cs.op_steps, S)
        if s:
            step_src[b, :s] = cs.step_src
            step_abs[b, :s] = cs.step_abs
    return PackedBucket(
        iterations=I, hmax=hmax, ii=ii, horizon=horizon, opcode=opcode,
        exec_mask=exec_mask, issue=issue, compare=compare, leaf=leaf,
        ref=ref, op_kind=op_kind, op_src=op_src, op_dist=op_dist,
        op_feed=op_feed, op_steps=op_steps, step_src=step_src,
        step_abs=step_abs, device=device,
    )


@dataclass
class PreparedBatch:
    """Lowered + packed form of one ``mappings`` list: the reusable half
    of a batched verification (build once with :func:`prepare_batch`,
    rerun cheaply via ``simulate_batch(..., prepared=...)``)."""

    iterations: int
    n_mappings: int
    scalar_idx: List[int]            # inputs needing the scalar oracle
    batch_idx: List[int]             # inputs lowered into `forms`/`packed`
    forms: List[CompiledSim]
    packed: Optional[PackedBucket]   # None when every input fell back


def prepare_batch(mappings, iterations: int = 4, device=None,
                  backend: Optional[str] = None) -> PreparedBatch:
    """Lower every mapping (``LoweringUnsupported`` ones are earmarked for
    the scalar oracle) and pack the rest into one padded bucket for
    ``backend`` on ``device`` (:func:`select_backend`)."""
    device = bucket_device(select_backend(backend, device), device)
    scalar_idx: List[int] = []
    batch_idx: List[int] = []
    forms: List[CompiledSim] = []
    for i, m in enumerate(mappings):
        try:
            cs = lower_mapping(m, iterations=iterations)
        except LoweringUnsupported:
            scalar_idx.append(i)
            continue
        batch_idx.append(i)
        forms.append(cs)
    return PreparedBatch(
        iterations=iterations, n_mappings=len(mappings),
        scalar_idx=scalar_idx, batch_idx=batch_idx, forms=forms,
        packed=pack_bucket(forms, device) if forms else None,
    )


def _values_thunk(val_b: np.ndarray, done_b: np.ndarray, node_ids):
    def build() -> Dict[Tuple[int, int], float]:
        return {
            (node_ids[r], int(it)): float(val_b[r, it])
            for r, it in np.argwhere(done_b)
        }
    return build


def _bucket_verdicts(forms: List[CompiledSim], pb: PackedBucket,
                     backend: str, tol: Tolerance) -> List[SimVerdict]:
    if backend == "numpy":
        val, done, read_fail = run_bucket_numpy(pb)
    else:
        val, done, read_fail = run_bucket(pb)
    # whole-batch checks (padding rows carry compare=False, so they never
    # contribute); the per-form loop below only details the failures
    cmpI = pb.compare[:, :, None]
    missing = cmpI & ~done
    bad = cmpI & done & ~close_array(val, pb.ref, tol)
    missing_any = missing.any(axis=(1, 2))
    bad_any = bad.any(axis=(1, 2))
    out: List[SimVerdict] = []
    for b, cs in enumerate(forms):
        n = cs.n_nodes
        if cs.fail_static is not None:
            out.append(SimVerdict(False, cs.fail_static, backend=backend))
        elif read_fail[b]:
            out.append(SimVerdict(
                False, "operand value not present at read time "
                       "(missing / unrouted / mistimed route)",
                backend=backend))
        elif missing_any[b]:
            r, it = np.argwhere(missing[b])[0]
            out.append(SimVerdict(
                False, f"node {cs.node_ids[r]} iter {it}: no value produced",
                backend=backend))
        elif bad_any[b]:
            r, it = np.argwhere(bad[b])[0]
            out.append(SimVerdict(
                False,
                f"node {cs.node_ids[r]} iter {it}: got {val[b, r, it]}, "
                f"want {cs.ref[r, it]}", backend=backend))
        else:
            out.append(SimVerdict(
                True, backend=backend,
                values_thunk=_values_thunk(
                    val[b, :n, :], done[b, :n, :], cs.node_ids)))
    return out


def _scalar_fallback(mapping, iterations: int) -> SimVerdict:
    from repro_torch.sim.check import scalar_verdict

    ok, values, reason = scalar_verdict(mapping, iterations=iterations)
    return SimVerdict(ok, reason=reason, values=values, backend="scalar")


def simulate_batch(mappings, iterations: int = 4, device=None,
                   tol: Optional[Tolerance] = None,
                   prepared: Optional[PreparedBatch] = None,
                   backend: Optional[str] = None) -> BatchResult:
    """Batched cycle-accurate verification (see module docstring) on
    ``device`` (default ``cuda``; :func:`~repro_torch.device.resolve_device`),
    or by ``backend`` (:func:`select_backend`).

    Returns a :class:`BatchResult` — one :class:`SimVerdict` per input
    mapping, in input order, plus throughput metadata.  Never raises on a
    *failing mapping* (that is a ``False`` verdict); raises on device
    faults.

    Pass ``prepared`` (from :func:`prepare_batch` over the *same*
    mappings/iterations/device) to skip the lowering + packing half and
    rerun only the cycle loop."""
    t0 = time.perf_counter()
    backend = select_backend(backend, device)
    device = bucket_device(backend, device)
    faultinject.check("sim.batch", f"batch={len(mappings)}")
    tol = tol if tol is not None else tolerance_for(backend)

    if prepared is None:
        prepared = prepare_batch(mappings, iterations=iterations,
                                 device=device, backend=backend)
    elif (prepared.n_mappings != len(mappings)
          or prepared.iterations != iterations
          or (prepared.packed is not None
              and prepared.packed.device != device)):
        raise ValueError(
            f"prepared batch is for {prepared.n_mappings} mappings x "
            f"{prepared.iterations} iterations"
            + (f" on {prepared.packed.device}" if prepared.packed else "")
            + f", got {len(mappings)} x {iterations} on {device}")

    out = BatchResult([None] * len(mappings))
    out.backend = backend
    for i in prepared.scalar_idx:
        out[i] = _scalar_fallback(mappings[i], iterations)
    out.n_scalar_fallback = len(prepared.scalar_idx)
    if prepared.packed is not None:
        verdicts = _bucket_verdicts(prepared.forms, prepared.packed,
                                    backend, tol)
        for i, v in zip(prepared.batch_idx, verdicts):
            out[i] = v
        out.n_buckets = 1
    out.wall_s = time.perf_counter() - t0
    return out


def verify_mappings(mappings, iterations: int = 3, device=None,
                    prepared: Optional[PreparedBatch] = None,
                    backend: Optional[str] = None,
                    ) -> List[Dict[Tuple[int, int], float]]:
    """Batched verification with the scalar oracle's disproof contract:
    returns the per-mapping value dicts, raising ``AssertionError`` on the
    first failing mapping.  ``prepared`` (e.g. rebuilt from an artifact's
    stored ``compiled_sim`` forms) skips the lowering half."""
    verdicts = simulate_batch(mappings, iterations=iterations,
                              device=device, prepared=prepared,
                              backend=backend)
    for i, v in enumerate(verdicts):
        assert v.ok, (
            f"mapping[{i}] failed batched verification "
            f"({v.backend} backend): {v.reason}")
    return [v.values for v in verdicts]
