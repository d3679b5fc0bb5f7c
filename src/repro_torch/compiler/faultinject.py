"""Fault-injection harness for chaos-testing the execution tier (port of
``repro/compiler/faultinject.py``: the same ``REPRO_FAULTS`` variable and
spec format, so one chaos plan drives both packages).

Faults are declared in the ``REPRO_FAULTS`` environment variable — a JSON
list of fault specs — so they cross process boundaries under **both** the
``fork`` and ``spawn`` multiprocessing start methods (a worker re-reads
the spec from its inherited environment; nothing needs pickling).  The
production hot path pays one cached ``os.environ`` lookup when the
variable is unset.

Spec fields (one dict per fault)::

    {"mode":  "crash" | "hang" | "oserror" | "corrupt",   # required
     "site":  "worker" | "store.get" | "store.put" | ...,  # default: any
     "match": fnmatch pattern against the cell/key label,  # default: "*"
     "attempts": [0, 1, ...],   # only fire on these runner attempts
                                # (default: every attempt)
     "times": N,                # max firings per process (default: no cap)
     "seconds": S,              # hang duration (default 3600)
     "exitcode": C}             # crash exit status (default 137, i.e. the
                                # observable effect of an OOM SIGKILL)

Modes:

* ``crash``   — ``os._exit(exitcode)``: the process dies without cleanup,
  exactly like a segfault/OOM kill as seen by the supervisor.
* ``hang``    — ``time.sleep(seconds)``: simulates a stuck route search;
  only a hard per-cell timeout can reclaim the worker.
* ``oserror`` — raises ``OSError(EIO)`` at the instrumented site
  (transient store I/O failure).
* ``corrupt`` — flips bytes in a just-written file
  (:func:`maybe_corrupt`), producing a torn/bit-rotted artifact that the
  store's integrity digest must catch.

Instrumentation points call :func:`check` (raise/crash/hang faults) or
:func:`maybe_corrupt` (post-write corruption) with their site name and
the cell/key label; everything else is declarative.  The test suite uses
the :func:`inject` context manager instead of exporting the variable by
hand.

This module is **leaf-level** (stdlib only): the store, the collect
worker, and the runner all import it without cycles.
"""
from __future__ import annotations

import errno
import json
import os
import time
from contextlib import contextmanager
from fnmatch import fnmatch
from typing import Dict, List

ENV_VAR = "REPRO_FAULTS"
#: set per worker attempt by the supervised runner (string int); attempt
#: scoping lets a spec model a *transient* fault that heals on retry
ATTEMPT_VAR = "REPRO_RUNNER_ATTEMPT"

_MODES = ("crash", "hang", "oserror", "corrupt")

# (env string) -> parsed spec list cache, and per-process firing counters
_cache: Dict[str, List[Dict[str, object]]] = {}
_fired: Dict[int, int] = {}


class FaultSpecError(ValueError):
    """REPRO_FAULTS is present but unparseable / structurally invalid —
    raised loudly: a chaos run with a silently-ignored fault plan would
    pass CI while testing nothing."""


def _parse(raw: str) -> List[Dict[str, object]]:
    try:
        specs = json.loads(raw)
    except ValueError as e:
        raise FaultSpecError(f"{ENV_VAR} is not valid JSON: {e}")
    if not isinstance(specs, list):
        raise FaultSpecError(f"{ENV_VAR} must be a JSON list of fault specs")
    for spec in specs:
        if not isinstance(spec, dict):
            raise FaultSpecError(f"fault spec {spec!r} is not an object")
        mode = spec.get("mode")
        if mode not in _MODES:
            raise FaultSpecError(
                f"fault spec {spec!r}: mode must be one of {_MODES}")
        attempts = spec.get("attempts")
        if attempts is not None and not (
                isinstance(attempts, list)
                and all(isinstance(a, int) for a in attempts)):
            raise FaultSpecError(
                f"fault spec {spec!r}: attempts must be a list of ints")
    return specs


def active_faults() -> List[Dict[str, object]]:
    """Parsed fault specs from the environment (cached per env value);
    the empty list when ``REPRO_FAULTS`` is unset/empty."""
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return []
    specs = _cache.get(raw)
    if specs is None:
        specs = _cache[raw] = _parse(raw)
    return specs


def current_attempt() -> int:
    """The supervised runner's attempt index for this worker process
    (0 = first try); 0 outside a supervised worker."""
    try:
        return int(os.environ.get(ATTEMPT_VAR, "0"))
    except ValueError:
        return 0


def _matches(spec: Dict[str, object], mode: str, site: str,
             label: str) -> bool:
    if spec.get("mode") != mode:
        return False
    want_site = spec.get("site")
    if want_site is not None and want_site != site:
        return False
    if not fnmatch(label, str(spec.get("match", "*"))):
        return False
    attempts = spec.get("attempts")
    if attempts is not None and current_attempt() not in attempts:
        return False
    times = spec.get("times")
    if times is not None and _fired.get(id(spec), 0) >= int(times):
        return False
    return True


def _fire(spec: Dict[str, object]):
    _fired[id(spec)] = _fired.get(id(spec), 0) + 1


def check(site: str, label: str = "") -> None:
    """Fire any matching ``crash``/``hang``/``oserror`` fault for this
    instrumentation site.  No-op (one env lookup) when no faults are
    declared."""
    specs = active_faults()
    if not specs:
        return
    for spec in specs:
        mode = str(spec.get("mode"))
        if mode == "corrupt" or not _matches(spec, mode, site, label):
            continue
        _fire(spec)
        if mode == "crash":
            # no cleanup, no atexit, no exception: indistinguishable from
            # a segfault / OOM SIGKILL to the supervising parent
            os._exit(int(spec.get("exitcode", 137)))
        elif mode == "hang":
            time.sleep(float(spec.get("seconds", 3600)))
        elif mode == "oserror":
            raise OSError(
                errno.EIO,
                f"injected transient I/O fault at {site} ({label})")


def maybe_corrupt(path: str, site: str, label: str = "") -> bool:
    """Corrupt the file at ``path`` in place if a ``corrupt`` fault
    matches; returns whether it fired.  Flips a byte in the middle and
    truncates the tail so both digest checks and JSON parsing notice."""
    specs = active_faults()
    if not specs:
        return False
    for spec in specs:
        if not _matches(spec, "corrupt", site, label):
            continue
        _fire(spec)
        try:
            with open(path, "r+b") as f:
                data = f.read()
                if not data:
                    continue
                mid = len(data) // 2
                f.seek(mid)
                f.write(bytes([data[mid] ^ 0xFF]))
                f.truncate(max(mid + 1, len(data) - len(data) // 8))
        except OSError:
            return False
        return True
    return False


@contextmanager
def inject(*specs: Dict[str, object]):
    """Test helper: declare faults for the duration of a ``with`` block
    (sets/restores ``REPRO_FAULTS``; children forked/spawned inside the
    block inherit the plan)."""
    prev = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = json.dumps(list(specs))
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = prev
