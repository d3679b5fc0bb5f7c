"""Supervised process runner for embarrassingly-parallel grids (port of
``repro/core/runner.py``).

``repro_torch.core.collect`` fans its (workload x job) cells out through
:class:`SupervisedRunner`, and the compile farm runs each compile job
through one.  The supervisor treats worker death and wall-clock overruns
as *data*:

* **one process per cell attempt** — a crash or kill is isolated, and
  the next attempt or cell gets a fresh worker;
* **hard per-cell timeouts** — a cell past ``timeout_s`` is terminated
  (SIGTERM, then SIGKILL) and reported as a
  :class:`~repro_torch.compiler.errors.CompileTimeout` failure;
* **dead-worker detection** — a worker that exits without delivering a
  result (EOF on its result pipe) is a
  :class:`~repro_torch.compiler.errors.WorkerCrashed` failure carrying
  the observed exit status;
* **bounded deterministic retry** — crashes and *transient* errors
  (:data:`~repro_torch.compiler.errors.RETRYABLE_ERRORS`, matched
  against the raised type's MRO) are retried up to ``retries`` extra
  attempts with exponential backoff (``backoff_s * 2**(attempt-1)``);
  deterministic failures fail fast;
* **structured failure records** — the caller receives a
  :class:`CellFailure` per exhausted cell instead of an exception.

Workers learn their attempt index through ``REPRO_RUNNER_ATTEMPT``
(:data:`~repro_torch.compiler.faultinject.ATTEMPT_VAR`).

CUDA does not survive ``fork``: a child forked from a process that holds
a CUDA context cannot use the card.  A grid whose workers run on a card
(``device``) therefore never forks from the supervisor
(:func:`start_method_for`): by default it starts its workers from a
``forkserver`` — a fresh interpreter that has imported the task
function's module and never touches the card, so each worker forks
cheaply from a clean process.  The outcome is the start method's alone:
the same results, the same failures.  A worker that cannot reach the
card raises, and that is its cell's failure.

The task function and the task payloads must be picklable top-level
objects under ``spawn`` and ``forkserver``; under ``fork`` anything goes.
Results stream back in completion order, like ``Pool.imap_unordered``.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing import connection, get_context
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from repro_torch.compiler.errors import (
    RETRYABLE_ERRORS,
    CompileTimeout,
    WorkerCrashed,
    classify,
)
from repro_torch.compiler.faultinject import ATTEMPT_VAR

#: grace between SIGTERM and SIGKILL when reclaiming a timed-out worker
_TERM_GRACE_S = 1.0


def start_method_for(requested: Optional[str], device,
                     parent_holds_cuda: bool) -> Optional[str]:
    """The multiprocessing start method of a grid whose workers run on
    ``device`` (``None``: they touch no card), given the method the caller
    ``requested`` (``None``: the platform default) and whether the
    supervising process holds a CUDA context.

    Workers that touch no card start as requested.  Workers on a card
    start from a ``forkserver`` unless the caller names a method, and a
    request to ``fork`` them from a process that holds a CUDA context is
    refused (``ValueError``): such a child cannot use the card."""
    if device is None or torch.device(device).type != "cuda":
        return requested
    if requested is None:
        return "forkserver"
    if requested == "fork" and parent_holds_cuda:
        raise ValueError(
            "cannot fork workers that run on a CUDA device from a process "
            "that holds a CUDA context; use the forkserver or spawn start "
            "method")
    return requested


@dataclass
class CellFailure:
    """Structured record of one cell that exhausted its attempts."""

    label: str                      # caller-supplied cell label
    error: str                      # taxonomy class name (classify())
    message: str
    attempts: int                   # attempts actually made
    wall_s: float                   # wall time across all attempts
    exitcode: Optional[int] = None  # crash exit status (negative = signal)
    traceback: Optional[str] = None  # worker-side traceback, when reported

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "error": self.error,
            "message": self.message,
            "attempts": self.attempts,
            "wall_s": round(self.wall_s, 3),
        }
        if self.exitcode is not None:
            out["exitcode"] = self.exitcode
        if self.traceback:
            out["traceback"] = self.traceback
        return out


def _child_main(fn: Callable, task, attempt: int, conn_w) -> None:
    """Worker entry: run one task, report ("ok", result) or ("err", mro
    names, taxonomy label, message, traceback) over the pipe, exit.
    Top-level so the ``spawn`` and ``forkserver`` start methods can
    import it."""
    os.environ[ATTEMPT_VAR] = str(attempt)
    try:
        result = fn(task)
        payload = ("ok", result)
    except BaseException as e:  # noqa: BLE001 - the supervisor classifies
        import traceback as _tb

        payload = ("err", [c.__name__ for c in type(e).__mro__],
                   classify(e), str(e), _tb.format_exc())
    try:
        conn_w.send(payload)
    except (BrokenPipeError, OSError):
        pass  # supervisor already gave up on us (timeout); nothing to do
    finally:
        conn_w.close()


@dataclass
class _Pending:
    idx: int
    task: object
    attempt: int = 0          # next attempt index (0 = first try)
    not_before: float = 0.0   # monotonic backoff gate
    spent_s: float = 0.0      # wall time burned by previous attempts


@dataclass
class _InFlight:
    pend: _Pending
    proc: object
    conn_r: object
    t_start: float
    deadline: Optional[float]


@dataclass
class SupervisedRunner:
    """See module docstring.

    ``fn``           — picklable task function, called as ``fn(task)``;
    ``jobs``         — concurrent worker slots;
    ``timeout_s``    — hard per-cell wall-clock limit (``None`` = none);
    ``retries``      — extra attempts for crashes/transient errors;
    ``backoff_s``    — base retry backoff (exponential, deterministic);
    ``retry_timeouts`` — also retry timed-out cells (off by default: a
    deterministic compile that hung once will hang again);
    ``start_method`` — multiprocessing start method (``None`` = the
    platform default, or ``forkserver`` for workers on a card:
    :func:`start_method_for`);
    ``label``        — maps a task to the cell label used in failure
    records and fault matching;
    ``device``       — where the workers run their tensors (``None``:
    they touch no card).
    """

    fn: Callable
    jobs: int = 1
    timeout_s: Optional[float] = None
    retries: int = 1
    backoff_s: float = 0.1
    retry_timeouts: bool = False
    start_method: Optional[str] = None
    label: Callable[[object], str] = field(default=repr)
    device: Optional[str] = None

    def _context(self):
        method = start_method_for(self.start_method, self.device,
                                  torch.cuda.is_initialized())
        ctx = get_context(method)
        if method == "forkserver":
            # the server imports the task's module once (torch and the
            # pipeline with it); workers fork from it without the import.
            # "__main__" is the forkserver's own default; the list only
            # takes effect when this process starts its server
            ctx.set_forkserver_preload(["__main__", self.fn.__module__])
        return ctx

    def run(self, tasks: Iterable) -> Iterator[Tuple[object, str, object]]:
        """Yield ``(task, "ok", result)`` / ``(task, "failed",
        CellFailure)`` in completion order; every input task yields
        exactly once."""
        ctx = self._context()
        pending = deque(_Pending(i, t) for i, t in enumerate(tasks))
        inflight: Dict[object, _InFlight] = {}  # conn_r -> record
        try:
            while pending or inflight:
                now = time.monotonic()
                # dispatch into free slots (skip cells still in backoff)
                n_ready = sum(1 for p in pending if p.not_before <= now)
                while len(inflight) < max(1, self.jobs) and n_ready > 0:
                    pend = pending.popleft()
                    if pend.not_before > now:
                        pending.append(pend)  # rotate past backoff gates
                        continue
                    n_ready -= 1
                    rec = self._spawn(ctx, pend)
                    inflight[rec.conn_r] = rec
                if not inflight:
                    # everything runnable is in backoff: sleep to the gate
                    gate = min(p.not_before for p in pending)
                    time.sleep(max(0.0, gate - time.monotonic()))
                    continue
                yield from self._reap(pending, inflight)
        finally:
            for rec in inflight.values():  # GeneratorExit/KeyboardInterrupt
                self._reclaim(rec.proc)

    # -- internals -----------------------------------------------------------
    def _spawn(self, ctx, pend: _Pending) -> _InFlight:
        conn_r, conn_w = ctx.Pipe(duplex=False)
        proc = ctx.Process(
            target=_child_main,
            args=(self.fn, pend.task, pend.attempt, conn_w),
            daemon=True,
        )
        proc.start()
        # the parent MUST drop its copy of the write end: EOF (= worker
        # died without reporting) is only observable once the child holds
        # the last open handle
        conn_w.close()
        now = time.monotonic()
        deadline = None if self.timeout_s is None else now + self.timeout_s
        return _InFlight(pend, proc, conn_r, now, deadline)

    def _wait_timeout(self, pending, inflight) -> float:
        now = time.monotonic()
        horizon = now + 0.5
        for rec in inflight.values():
            if rec.deadline is not None:
                horizon = min(horizon, rec.deadline)
        for p in pending:
            if p.not_before > now:
                horizon = min(horizon, p.not_before)
        return max(0.0, horizon - now)

    def _reap(self, pending, inflight) -> Iterator[Tuple[object, str, object]]:
        ready = connection.wait(list(inflight),
                                timeout=self._wait_timeout(pending, inflight))
        for conn_r in ready:
            rec = inflight.pop(conn_r)
            try:
                msg = conn_r.recv()
            except (EOFError, OSError):
                msg = None  # died without a result: crash
            conn_r.close()
            self._reclaim(rec.proc)
            yield from self._settle(pending, rec, msg)
        now = time.monotonic()
        for conn_r, rec in list(inflight.items()):
            if rec.deadline is not None and now >= rec.deadline:
                del inflight[conn_r]
                self._reclaim(rec.proc, force=True)
                conn_r.close()
                yield from self._settle(pending, rec, ("timeout",))

    def _settle(self, pending, rec: _InFlight,
                msg) -> Iterator[Tuple[object, str, object]]:
        pend = rec.pend
        wall = pend.spent_s + (time.monotonic() - rec.t_start)
        attempt = pend.attempt
        made = attempt + 1
        if msg is not None and msg[0] == "ok":
            yield pend.task, "ok", msg[1]
            return
        if msg is None:  # crashed
            exitcode = rec.proc.exitcode
            retryable = True
            fail = CellFailure(
                label=self.label(pend.task),
                error=classify(WorkerCrashed("")),
                message=(f"worker exited with status {exitcode} before "
                         f"reporting a result"),
                attempts=made, wall_s=wall, exitcode=exitcode,
            )
        elif msg[0] == "timeout":
            retryable = self.retry_timeouts
            fail = CellFailure(
                label=self.label(pend.task),
                error=classify(CompileTimeout("")),
                message=(f"cell exceeded the per-cell timeout of "
                         f"{self.timeout_s}s"),
                attempts=made, wall_s=wall,
            )
        else:  # ("err", mro_names, taxonomy_label, message, traceback)
            _, mro, label, text, tb = msg
            retryable = any(name in RETRYABLE_ERRORS for name in mro)
            fail = CellFailure(
                label=self.label(pend.task), error=label, message=text,
                attempts=made, wall_s=wall, traceback=tb,
            )
        if retryable and attempt < self.retries:
            pend.attempt += 1
            pend.spent_s = wall
            pend.not_before = (time.monotonic()
                               + self.backoff_s * (2 ** attempt))
            pending.append(pend)
            return
        yield pend.task, "failed", fail

    @staticmethod
    def _reclaim(proc, force: bool = False):
        """Join a finished worker; terminate (then kill) one we gave up
        on so no zombie or stray compute outlives its cell."""
        if force and proc.is_alive():
            proc.terminate()
            proc.join(_TERM_GRACE_S)
            if proc.is_alive():
                proc.kill()
        proc.join()


def run_supervised(fn: Callable, tasks: Iterable, **cfg
                   ) -> Iterator[Tuple[object, str, object]]:
    """Convenience wrapper: ``SupervisedRunner(fn, **cfg).run(tasks)``."""
    return SupervisedRunner(fn, **cfg).run(tasks)
