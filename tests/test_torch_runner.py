"""The port's supervised runner (``repro_torch.core.runner``) on the JAX
package's scenarios (``tests/test_robustness.py``'s runner tests), held
against ``repro.core.runner`` on the same grid: the same failure records
(taxonomy label, message, attempts, exit status; wall time and the
traceback's text aside), and the start-method rule that keeps workers on a
card from forking off a process that holds a CUDA context.
"""
import os
import time

import pytest

from repro.core.runner import run_supervised as jax_run_supervised
from repro_torch.compiler import faultinject
from repro_torch.core.runner import (
    SupervisedRunner,
    run_supervised,
    start_method_for,
)

# task functions must be top-level (picklable under spawn and forkserver)


def _task_ok(task):
    return task * 2


def _task_crash(task):
    os._exit(137)


def _task_hang(task):
    time.sleep(60)
    return task


def _task_flaky(task):
    # transient: fails on the first attempt, heals on retry
    if int(os.environ.get(faultinject.ATTEMPT_VAR, "0")) == 0:
        raise OSError("transient I/O blip")
    return task


def _task_boom(task):
    raise ValueError("deterministic bug")


def _task_mixed(task):
    kind, value = task
    return {"ok": _task_ok, "crash": _task_crash, "flaky": _task_flaky,
            "boom": _task_boom}[kind](value)


MIXED = [("ok", 1), ("crash", 2), ("flaky", 3), ("boom", 4), ("ok", 5),
         ("flaky", 6), ("ok", 7)]


def _drain(stream):
    oks, fails = {}, {}
    for task, status, payload in stream:
        assert task not in oks and task not in fails  # exactly-once
        (oks if status == "ok" else fails)[task] = payload
    return oks, fails


def _record(fail):
    out = fail.to_json()
    out.pop("wall_s")
    out.pop("traceback", None)
    return fail.label, out


def test_runner_all_ok_streams_every_task():
    oks, fails = _drain(run_supervised(_task_ok, [1, 2, 3, 4, 5], jobs=3))
    assert oks == {i: i * 2 for i in (1, 2, 3, 4, 5)}
    assert fails == {}


def test_runner_detects_dead_worker_and_retries():
    oks, fails = _drain(
        run_supervised(_task_crash, ["c"], retries=1, backoff_s=0.01))
    assert oks == {}
    f = fails["c"]
    assert f.error == "WorkerCrashed"
    assert f.attempts == 2  # crash is retryable: first try + one retry
    assert f.exitcode == 137
    assert "137" in f.message
    assert f.to_json()["exitcode"] == 137


def test_runner_transient_error_heals_on_retry():
    oks, fails = _drain(
        run_supervised(_task_flaky, ["t"], retries=1, backoff_s=0.01))
    assert fails == {}
    assert oks == {"t": "t"}


def test_runner_deterministic_error_fails_fast():
    oks, fails = _drain(
        run_supervised(_task_boom, ["b"], retries=3, backoff_s=0.01))
    f = fails["b"]
    assert f.error == "ValueError"
    assert f.attempts == 1  # not retryable: retries must not be burned
    assert "deterministic bug" in f.message
    assert "deterministic bug" in f.traceback


def test_runner_hard_timeout_reclaims_hung_worker():
    t0 = time.monotonic()
    oks, fails = _drain(
        run_supervised(_task_hang, ["h"], timeout_s=1.0))
    assert time.monotonic() - t0 < 10.0  # not the 60s the task sleeps
    f = fails["h"]
    assert f.error == "CompileTimeout"
    assert f.attempts == 1  # timeouts are not retried by default
    assert "1.0" in f.message


@pytest.mark.parametrize("start_method", [None, "forkserver"])
def test_runner_mixed_grid_matches_the_jax_runner(start_method):
    """Every start method gives the same outcome, and the JAX package's
    runner gives it too: the results of the tasks that heal or succeed,
    and one failure record a failing task, field for field."""
    cfg = dict(jobs=3, retries=1, backoff_s=0.01,
               label=lambda t: f"cell/{t[0]}{t[1]}")
    oks, fails = _drain(SupervisedRunner(
        _task_mixed, start_method=start_method, **cfg).run(MIXED))
    assert oks == {("ok", 1): 2, ("flaky", 3): 3, ("ok", 5): 10,
                   ("flaky", 6): 6, ("ok", 7): 14}
    assert sorted(fails) == [("boom", 4), ("crash", 2)]
    assert fails[("crash", 2)].attempts == 2
    assert fails[("boom", 4)].attempts == 1
    j_oks, j_fails = _drain(jax_run_supervised(_task_mixed, MIXED, **cfg))
    assert j_oks == oks
    assert ({t: _record(f) for t, f in fails.items()}
            == {t: _record(f) for t, f in j_fails.items()})


@pytest.mark.parametrize("requested, device, holds, want", [
    # workers that touch no card start as asked (the JAX package's rule)
    (None, None, False, None),
    (None, "cpu", True, None),
    ("fork", "cpu", True, "fork"),
    ("spawn", None, True, "spawn"),
    # workers on a card start from a forkserver unless told otherwise
    (None, "cuda", False, "forkserver"),
    (None, "cuda", True, "forkserver"),
    (None, "cuda:0", True, "forkserver"),
    ("spawn", "cuda", True, "spawn"),
    ("forkserver", "cuda", True, "forkserver"),
    # forking is safe only from a process that holds no CUDA context
    ("fork", "cuda", False, "fork"),
])
def test_start_method_rule(requested, device, holds, want):
    assert start_method_for(requested, device, holds) == want


def test_start_method_rule_refuses_fork_from_a_cuda_context():
    with pytest.raises(ValueError, match="CUDA context"):
        start_method_for("fork", "cuda", True)
    with pytest.raises(ValueError, match="CUDA context"):
        start_method_for("fork", "cuda:1", True)


def test_runner_on_a_card_starts_workers_from_a_forkserver():
    """The runner applies the rule when it builds its context (no card
    needed to choose one), and preloads the task's module there."""
    ctx = SupervisedRunner(_task_ok, device="cuda")._context()
    assert ctx.get_start_method() == "forkserver"
    assert SupervisedRunner(_task_ok, device="cpu")._context() \
        .get_start_method() == "fork"
