"""Remote-compile client (port of ``repro/serve_farm/client.py``): bounded
deterministic retry, idempotent resubmission, and a circuit breaker in
front of the farm daemon.

Retry policy
------------
Connection-level failures (refused socket, peer died mid-frame, recv
timeout) and ``ServiceOverloaded`` sheds are retried up to ``retries``
times with exponential backoff plus *deterministic* jitter — the jitter
is hashed from ``(addr, attempt, salt)``, never ``random``, so a failing
sweep replays identically.  Resubmission is safe by construction: the
daemon keys jobs by ``CompileKey`` and dedups in-flight work, so a
retried request either attaches to the original job or serves its
cached artifact.

Circuit breaker
---------------
``BREAKER_THRESHOLD`` *consecutive* connection failures open the breaker
for ``BREAKER_COOLDOWN_S``; while open every call raises
:class:`FarmUnavailable` immediately (no socket churn), and
``compile(..., remote=)`` degrades to a local cache-first compile.
After the cooldown one probe is allowed through (half-open); success
closes the breaker.  Breakers are per-address and per-process.

Typed sheds propagate: a request the daemon refused with
``ServiceOverloaded`` exhausts its retries and then raises the same
class locally, so ``python -m repro_torch compile --remote`` exits with
the same code (17) a local overload would produce.
"""
from __future__ import annotations

import hashlib
import socket
import threading
import time
from typing import Dict, Optional

from repro_torch.compiler import errors as _errors
from repro_torch.compiler.artifact import CompileResult
from repro_torch.compiler.errors import (
    CompileError,
    FarmUnavailable,
    ServiceOverloaded,
)
from repro_torch.serve_farm.protocol import recv_msg, send_msg

DEFAULT_RETRIES = 4
DEFAULT_BACKOFF_S = 0.05
DEFAULT_TIMEOUT_S = 600.0
BREAKER_THRESHOLD = 3
BREAKER_COOLDOWN_S = 5.0


class _Breaker:
    def __init__(self):
        self.failures = 0
        self.open_until = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            return time.monotonic() >= self.open_until

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.failures >= BREAKER_THRESHOLD:
                self.open_until = time.monotonic() + BREAKER_COOLDOWN_S

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.open_until = 0.0


_BREAKERS: Dict[str, _Breaker] = {}
_BREAKERS_LOCK = threading.Lock()


def _breaker(addr: str) -> _Breaker:
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(addr)
        if br is None:
            br = _BREAKERS[addr] = _Breaker()
        return br


def reset_breakers() -> None:
    """Forget breaker state (tests; long-lived callers after a redeploy)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


def _jitter(addr: str, attempt: int, salt: str) -> float:
    """Deterministic jitter in [0, 1): same sweep → same schedule."""
    h = hashlib.sha256(f"{addr}:{attempt}:{salt}".encode()).hexdigest()
    return int(h[:8], 16) / 0xFFFFFFFF


def _call(addr: str, request: Dict, timeout_s: float) -> Dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout_s)
        s.connect(addr)
        send_msg(s, request)
        return recv_msg(s)


def farm_request(addr: str, request: Dict, *,
                 retries: int = DEFAULT_RETRIES,
                 backoff_s: float = DEFAULT_BACKOFF_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 salt: str = "") -> Dict:
    """One request against the farm with the full retry/breaker policy.

    Returns the response dict (which may still be ``{"ok": false}`` for
    non-retryable typed errors — callers map those).  Raises
    :class:`FarmUnavailable` when the daemon is unreachable and
    :class:`ServiceOverloaded` when sheds outlast the retries.
    """
    br = _breaker(addr)
    if not br.allow():
        raise FarmUnavailable(
            f"circuit breaker open for {addr} after "
            f"{br.failures} consecutive connection failures")
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt:
            delay = backoff_s * (2 ** (attempt - 1))
            time.sleep(delay * (1.0 + _jitter(addr, attempt, salt)))
        try:
            resp = _call(addr, request, timeout_s)
        except (ConnectionError, socket.timeout, OSError) as e:
            last = e
            br.record_failure()
            if not br.allow():
                break  # breaker tripped mid-loop: stop hammering
            continue
        br.record_success()
        if not resp.get("ok") and resp.get("error") == "ServiceOverloaded":
            last = ServiceOverloaded(
                resp.get("message", "farm shed the request"),
                queue_depth=resp.get("queue_depth"),
                queue_limit=resp.get("queue_limit"))
            continue  # backoff, then try again: the queue may drain
        if not resp.get("ok") and resp.get("error") == "FarmUnavailable":
            last = FarmUnavailable(
                resp.get("message", "daemon is draining"))
            br.record_failure()
            continue  # a draining daemon counts as unreachable
        return resp
    if isinstance(last, ServiceOverloaded):
        raise last
    raise FarmUnavailable(
        f"compile farm at {addr} unreachable after "
        f"{retries + 1} attempt(s): {last}")


def _raise_typed(resp: Dict) -> None:
    """Re-raise a daemon error response as its taxonomy class."""
    name = resp.get("error", "CompileError")
    message = resp.get("message", "remote compile failed")
    cls = getattr(_errors, str(name), None)
    if isinstance(cls, type) and issubclass(cls, CompileError):
        if cls is ServiceOverloaded:
            raise cls(message, queue_depth=resp.get("queue_depth"),
                      queue_limit=resp.get("queue_limit"))
        raise cls(message)
    raise CompileError(f"{name}: {message}")


def remote_compile(addr: str, *, workload: str,
                   unroll: Optional[int] = None,
                   arch: str = "plaid2x2", mapper: str = "hierarchical",
                   seed: int = 0, budget=None,
                   iterations: Optional[int] = None,
                   verify: bool = False,
                   deadline_s: Optional[float] = None,
                   retries: int = DEFAULT_RETRIES,
                   backoff_s: float = DEFAULT_BACKOFF_S,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> CompileResult:
    """Compile ``workload`` on the farm at ``addr`` and return the
    artifact, marked ``store_hit`` when it was served warm."""
    request = {"op": "compile", "workload": workload, "unroll": unroll,
               "arch": arch, "mapper": mapper, "seed": seed,
               "budget": budget, "iterations": iterations,
               "verify": verify, "deadline_s": deadline_s}
    salt = f"{workload}/u{unroll}/{mapper}/s{seed}"
    resp = farm_request(addr, request, retries=retries,
                        backoff_s=backoff_s, timeout_s=timeout_s,
                        salt=salt)
    if not resp.get("ok"):
        _raise_typed(resp)
    out = CompileResult.from_json(resp["artifact"])
    out.store_hit = bool(resp.get("hit"))
    return out


def farm_status(addr: str, *, timeout_s: float = 10.0) -> Dict:
    """One unretried ``status`` probe (monitoring; bench sidecars)."""
    return _call(addr, {"op": "status"}, timeout_s)


def farm_ping(addr: str, *, timeout_s: float = 10.0) -> bool:
    try:
        return bool(_call(addr, {"op": "ping"}, timeout_s).get("ok"))
    except (ConnectionError, OSError):
        return False
