"""Shared numeric-tolerance policy for the simulators (port of
``repro/sim/check.py``).

The scalar oracle (:mod:`repro_torch.core.simulate`) and the batched
backends (:mod:`repro_torch.sim.batch`) accept a value iff :func:`close`
does — one mixed absolute/relative policy, so a large-magnitude workload
(``gemm`` at high unroll grows values into the 1e5 range) cannot pass one
simulator and spuriously fail the other.

:data:`DEFAULT_TOL` is the float64 policy of the scalar oracle and the
numpy backend; :data:`F32_TOL` the looser one the tensor loop compares
under, since it computes in float32 on every device.

Leaf-level: numpy and the standard library only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Tolerance:
    """``|got - want| <= atol + rtol * |want|`` acceptance policy."""

    atol: float = 1e-6
    rtol: float = 1e-6


#: scalar oracle + numpy backend (float64 end to end)
DEFAULT_TOL = Tolerance()
#: the tensor loop accumulates in float32; comparisons against the
#: float64 reference need headroom for rounding over deep mul/mac chains
F32_TOL = Tolerance(atol=1e-3, rtol=1e-4)


def close(got: float, want: float, tol: Tolerance = DEFAULT_TOL) -> bool:
    """Scalar acceptance under the shared mixed abs/rel policy."""
    return abs(got - want) <= tol.atol + tol.rtol * abs(want)


def close_array(got, want, tol: Tolerance = DEFAULT_TOL):
    """Vectorized :func:`close`: elementwise boolean array."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want) <= tol.atol + tol.rtol * np.abs(want)


def tolerance_for(backend: str) -> Tolerance:
    """The comparison policy a backend's results are judged under: the
    scalar oracle and ``numpy`` are float64, the tensor loop (``cpu``,
    ``cuda``) float32."""
    return DEFAULT_TOL if backend in ("scalar", "numpy") else F32_TOL


def scalar_verdict(mapping, iterations: int = 4):
    """Run the scalar oracle on one mapping; returns
    ``(ok, values_or_None, reason_or_None)`` instead of raising, so it can
    be compared 1:1 against a batched verdict (including on deliberately
    corrupted mappings, where both sides must *fail*, not crash)."""
    from repro_torch.core.simulate import simulate  # late: keeps check leaf-level

    try:
        values = simulate(mapping, iterations=iterations)
    except (AssertionError, KeyError, ValueError, TypeError, IndexError) as e:
        return False, None, f"{type(e).__name__}: {e}"
    return True, values, None
