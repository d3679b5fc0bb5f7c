"""Typed error taxonomy for the compile/collect execution tier (port of
``repro/compiler/errors.py``: the same classes, exit codes and
``VERIFY_FAILURES``, so both packages' CLIs exit alike).

Every failure the toolchain can survive has a class here, rooted at
:class:`CompileError`, so callers (the CLI, the supervised grid runner,
the serving tier) can branch on *what went wrong* instead of pattern
matching message strings or blanket-catching ``Exception``:

========================  ===================================================
class                     meaning
========================  ===================================================
:class:`MappingInfeasible`  the mapper exhausted its II range / restarts
                            without producing a valid mapping
:class:`CompileTimeout`     a wall-clock deadline expired — either the
                            cooperative ``compile(..., deadline_s=)`` check
                            inside the pass pipeline, or the supervised
                            runner's hard per-cell timeout; carries the
                            partial per-pass stats collected so far
:class:`WorkerCrashed`      a grid worker process died without reporting a
                            result (OOM kill, segfault, ``kill -9``)
:class:`StoreIOError`       the artifact store could not be read or written
                            (transient or persistent I/O failure)
:class:`ArtifactError`      an artifact/store entry is corrupt, misfiled,
                            or structurally unloadable
:class:`LockTimeout`        an advisory ``flock`` could not be acquired
                            within its timeout (dead lock-holder)
:class:`ServiceOverloaded`  the compile-farm daemon shed the request (its
                            bounded job queue was full)
:class:`FarmUnavailable`    the compile-farm daemon is unreachable after
                            bounded retries (clients fall back to a local
                            compile)
========================  ===================================================

Dual inheritance keeps old call sites working: code that caught
``ValueError`` from a corrupt artifact, ``OSError`` from the store, or
``TimeoutError`` generically keeps catching the taxonomy classes.

This module is **leaf-level** (stdlib only) so every layer — ``fsio``,
the store, the mapping pass pipeline, the runner — can import it without
creating cycles.

Exit codes: each class carries a distinct ``exit_code`` so shell callers
of ``plaid-compile`` can branch on the failure kind (see
:func:`exit_code_for` and ``docs/robustness.md``).  0/1/2 keep their
conventional meanings (success / generic failure / usage error); the
taxonomy occupies 10+.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class CompileError(Exception):
    """Base of the toolchain failure taxonomy.

    ``details`` is a JSON-safe dict of structured context (cell key,
    attempts, deadline, ...) that failure records and CLI ``--debug``
    output surface verbatim.
    """

    exit_code = 10

    def __init__(self, message: str = "", **details: object):
        super().__init__(message)
        self.details: Dict[str, object] = dict(details)

    def to_json(self) -> Dict[str, object]:
        """Structured failure payload (what grid failure records store)."""
        out: Dict[str, object] = {
            "error": type(self).__name__,
            "message": str(self),
        }
        if self.details:
            out["details"] = self.details
        return out


class MappingInfeasible(CompileError, ValueError):
    """The mapper found no valid mapping within its II range/budget.

    Also raised when an artifact holds no routed mapping to act on
    (``CompileResult.simulate`` on an unmapped result) — ``ValueError``
    ancestry preserves the pre-taxonomy contract of those sites.
    """

    exit_code = 11


class CompileTimeout(CompileError, TimeoutError):
    """A wall-clock deadline expired.

    Raised cooperatively by the pass pipeline's deadline checks
    (``compile(..., deadline_s=)``) and by the supervised runner when a
    cell exceeds its hard per-cell timeout.  Attributes:

    * ``deadline_s`` — the configured budget (seconds);
    * ``elapsed_s``  — wall time actually spent when the check fired;
    * ``pass_stats`` — the partial uniform per-pass stats rows collected
      up to the timeout (``None`` when the producer records none), so a
      timeout is still attributable to the pass that consumed the budget;
    * ``where``      — the checkpoint that fired (e.g. ``"negotiate
      round 7"``).
    """

    exit_code = 12

    def __init__(self, message: str = "", *,
                 deadline_s: Optional[float] = None,
                 elapsed_s: Optional[float] = None,
                 where: str = "",
                 pass_stats: Optional[List[Dict[str, object]]] = None,
                 **details: object):
        super().__init__(message, **details)
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s
        self.where = where
        self.pass_stats = pass_stats

    def to_json(self) -> Dict[str, object]:
        out = super().to_json()
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
        if self.elapsed_s is not None:
            out["elapsed_s"] = round(self.elapsed_s, 3)
        if self.where:
            out["where"] = self.where
        if self.pass_stats:
            out["pass_stats"] = self.pass_stats
        return out


class WorkerCrashed(CompileError):
    """A grid worker process died without delivering a result (OOM,
    segfault, ``kill -9``).  ``exitcode`` is the process exit status the
    supervisor observed (negative = killed by that signal)."""

    exit_code = 13

    def __init__(self, message: str = "", *,
                 exitcode: Optional[int] = None, **details: object):
        super().__init__(message, **details)
        self.exitcode = exitcode

    def to_json(self) -> Dict[str, object]:
        out = super().to_json()
        if self.exitcode is not None:
            out["exitcode"] = self.exitcode
        return out


class StoreIOError(CompileError, OSError):
    """The artifact store could not be read/written (I/O level, not
    content level — corrupt content is :class:`ArtifactError`).  Often
    transient: the supervised runner retries cells that fail with it."""

    exit_code = 14


class ArtifactError(CompileError, ValueError):
    """An artifact or store entry is corrupt, misfiled, or structurally
    unloadable.  ``ValueError`` ancestry keeps pre-taxonomy handlers
    (``from_json`` schema rejections, store integrity checks) working."""

    exit_code = 15


class LockTimeout(CompileError, TimeoutError):
    """An advisory flock was not acquired within its timeout — the
    canonical cause is a dead lock-holder.  Callers degrade (sidecar
    write + warning) rather than hang."""

    exit_code = 16


class ServiceOverloaded(CompileError):
    """The compile-farm daemon shed this request: its bounded job queue
    was full.  Explicit load-shedding, not a hang — clients retry with
    backoff or fall back to a local compile."""

    exit_code = 17

    def __init__(self, message: str = "", *,
                 queue_depth: Optional[int] = None,
                 queue_limit: Optional[int] = None, **details: object):
        super().__init__(message, **details)
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit

    def to_json(self) -> Dict[str, object]:
        out = super().to_json()
        if self.queue_depth is not None:
            out["queue_depth"] = self.queue_depth
        if self.queue_limit is not None:
            out["queue_limit"] = self.queue_limit
        return out


class FarmUnavailable(CompileError, ConnectionError):
    """The compile-farm daemon could not be reached (connection refused /
    reset, dead socket, protocol violation) after the client's bounded
    retries — or its circuit breaker is open.  ``compile(..., remote=)``
    treats this as "degrade to a local compile", so a dying daemon slows
    a sweep down but never fails it."""

    exit_code = 18


#: Exceptions that mean "this stored/served mapping is disproven or
#: unreplayable" when raised by a verification replay
#: (``CompileResult.simulate`` on untrusted content).  Shared by the
#: store's verify policies, the pipeline's hit-path re-verification, and
#: ``plaid-compile inspect --verify`` — a deliberate, bounded list
#: instead of the bare ``except Exception`` they used to carry.
VERIFY_FAILURES = (
    AssertionError,  # Mapping.validate / simulate oracle mismatch
    ValueError,      # null-ii records, schema violations, MappingInfeasible
    KeyError,        # dangling node/edge references in mangled records
    TypeError,       # structurally wrong JSON shapes
    IndexError,      # out-of-range resource/FU ids
    AttributeError,  # records that are not dicts at all
)

#: What the simulation of a rebuilt, validated mapping may raise that is a
#: fault of the simulation path (a wrapper's input check, a packing bug),
#: not a verdict on the mapping: only ``AssertionError`` disproves one.
SIM_FAULTS = tuple(t for t in VERIFY_FAILURES if t is not AssertionError)


class SimulationFault(RuntimeError):
    """The simulation path failed on a mapping that loaded and validated
    (a kernel wrapper refused its inputs, a bucket did not pack).  The
    port's own: not in :data:`VERIFY_FAILURES`, so a verifying ``get``
    lets it propagate and leaves the entry and the index alone."""


#: Exception classes (by name, matched against the raised type's MRO)
#: the supervised runner treats as *transient* and retries with backoff.
RETRYABLE_ERRORS = ("OSError", "StoreIOError", "WorkerCrashed",
                    "LockTimeout", "BrokenPipeError", "EOFError")


def exit_code_for(exc: BaseException) -> int:
    """Distinct CLI exit code for a failure: taxonomy classes carry their
    own; anything else maps to the generic 1."""
    return getattr(exc, "exit_code", 1) if isinstance(exc, CompileError) \
        else 1


def classify(exc: BaseException) -> str:
    """Stable taxonomy label for a failure record: the most specific
    :class:`CompileError` subclass name, else the raw exception type."""
    if isinstance(exc, CompileError):
        return type(exc).__name__
    return type(exc).__name__
