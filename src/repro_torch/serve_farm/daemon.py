"""``python -m repro_torch serve``: the compile-farm daemon (port of
``repro/serve_farm/daemon.py``).

A :class:`CompileFarm` owns one journaled :class:`ArtifactStore`, a
Unix-domain listener and a device, resolved at construction (``cuda``
unless the caller passes ``"cpu"``; without a card it raises).  Every
request follows the same path:

1. **cache first** — the request's ``CompileKey`` is recomputed
   daemon-side (clients send compile *inputs*, never keys, so a stale
   client cannot poison the cache) and served from the store when warm;
   an unverified hit of a verifying request is proven on the daemon's
   device first (one ``sim_loop`` launch on a card);
2. **in-flight dedup** — a second request for a key already compiling
   attaches to the first one's job instead of spawning a duplicate;
3. **bounded queue** — when queued + running jobs reach ``queue_limit``
   the daemon sheds load with a typed ``ServiceOverloaded`` response
   rather than queueing unboundedly;
4. **supervised workers** — each compile runs in a child process driven
   by :class:`repro_torch.core.runner.SupervisedRunner` (per-request
   ``deadline_s`` with SIGTERM→SIGKILL reclaim, a crashed worker becomes a
   structured failure response, never a hung daemon), on the daemon's
   device.  Once the daemon has proven a hit on a card it holds a CUDA
   context, so workers on a card start from a ``forkserver``, never
   forked from the daemon
   (:func:`repro_torch.core.runner.start_method_for`).

On SIGTERM the daemon drains: the listener closes, queued jobs finish,
new compiles are refused, the store journal is compacted, and the
process exits 0.  A ``kill -9`` instead is exactly the crash the
journaled index recovers from on the next start.
"""
from __future__ import annotations

import os
import queue
import signal
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.compiler.errors import CompileError, CompileTimeout
from repro_torch.compiler.pipeline import (
    compile as _compile,
    compile_key,
    serve_from_store,
)
from repro_torch.compiler.store import ArtifactStore, open_store
from repro_torch.core.runner import SupervisedRunner
from repro_torch.device import resolve_device
from repro_torch.serve_farm.protocol import recv_msg, send_msg

#: compile requests wait on their job at most request deadline + this;
#: the grace covers worker start/reclaim overhead around the runner's
#: own timeout enforcement
_WAIT_GRACE_S = 30.0
_DEFAULT_DEADLINE_S = 600.0

_STOP = object()


def _farm_compile(task):
    """Worker-process entry point (module-level: must pickle under any
    multiprocessing start method).  Runs a normal local compile against
    the shared store on the daemon's device, so served artifacts are
    bit-identical to local ones by construction."""
    (store_path, name, unroll, arch, mapper, seed, budget, iterations,
     verify, device) = task
    out = _compile(
        name, arch=arch, mapper=mapper, seed=seed, budget=budget,
        unroll=unroll, iterations=iterations, verify=verify,
        store=store_path, device=device)
    return out.to_json()


@dataclass
class _Job:
    digest: str
    task: tuple
    label: str
    deadline_s: Optional[float]
    retries: int
    done: threading.Event = field(default_factory=threading.Event)
    response: Optional[Dict] = None
    waiters: int = 1


class CompileFarm:
    """The serve daemon.  ``start()``/``shutdown()`` embed it in-process
    (tests); ``serve_forever()`` is the CLI entry and owns signals.
    ``device`` is where hits are proven and workers compile (``cuda``
    unless ``"cpu"`` is passed; raises without a card)."""

    def __init__(self, store_path: str, socket_path: str, *,
                 workers: int = 2, queue_limit: int = 8,
                 default_deadline_s: Optional[float] = _DEFAULT_DEADLINE_S,
                 retries: int = 1, start_method: Optional[str] = None,
                 device=None):
        self.device = str(resolve_device(device))
        self.store_path = str(store_path)
        self.socket_path = str(socket_path)
        self.workers = max(1, int(workers))
        self.queue_limit = max(1, int(queue_limit))
        self.default_deadline_s = default_deadline_s
        self.retries = retries
        self.start_method = start_method
        self.store: ArtifactStore = open_store(self.store_path,
                                               device=self.device)
        self._queue: "queue.Queue" = queue.Queue()
        self._jobs: Dict[str, _Job] = {}
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._threads = []
        self._listener: Optional[socket.socket] = None
        self._t0 = time.time()
        self.counters = {"requests": 0, "hits": 0, "compiles": 0,
                         "dedup_attached": 0, "shed": 0, "failures": 0}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a kill -9
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        # poll rather than block: closing a socket does not wake a thread
        # parked in accept(), so a blocking listener would hang the drain
        self._listener.settimeout(0.2)
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"farm-worker-{i}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="farm-listener")
        t.start()
        self._threads.append(t)

    def serve_forever(self) -> int:
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        self.start()
        print(f"serving store {self.store_path} on {self.socket_path} "
              f"(pid {os.getpid()}, {self.workers} workers, "
              f"queue_limit {self.queue_limit}, device {self.device})",
              flush=True)
        stop.wait()
        print("draining: finishing in-flight jobs, refusing new ones",
              flush=True)
        self.shutdown()
        print("drained; journal compacted; bye", flush=True)
        return 0

    def shutdown(self) -> None:
        """Graceful drain: stop accepting, finish queued + in-flight
        jobs, compact the store journal."""
        self._draining.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for _ in range(self.workers):
            self._queue.put(_STOP)  # after real jobs: workers drain first
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=self.default_deadline_s or 600.0)
        try:
            self.store.compact()
        except OSError:
            pass
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    # -- request handling ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by drain
            conn.settimeout(None)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            try:
                req = recv_msg(conn)
            except (ConnectionError, OSError):
                return
            try:
                resp = self._dispatch(req)
            except Exception as e:  # a handler bug must not kill the daemon
                resp = {"ok": False, "error": type(e).__name__,
                        "message": str(e)}
            try:
                send_msg(conn, resp)
            except (ConnectionError, OSError):
                pass  # client went away; the job (if any) still caches

    def _dispatch(self, req: Dict) -> Dict:
        op = req.get("op")
        self.counters["requests"] += 1
        if op == "ping":
            return {"ok": True, "op": "ping", "pid": os.getpid()}
        if op == "status":
            return self._status()
        if op == "shutdown":
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True, "op": "shutdown", "draining": True}
        if op == "compile":
            return self._handle_compile(req)
        return {"ok": False, "error": "ProtocolError",
                "message": f"unknown op {op!r}"}

    def _status(self) -> Dict:
        with self._lock:
            in_flight = len(self._jobs)
        return {
            "ok": True, "op": "status", "pid": os.getpid(),
            "uptime_s": round(time.time() - self._t0, 3),
            "draining": self._draining.is_set(),
            "workers": self.workers,
            "queue_limit": self.queue_limit,
            "queue_depth": self._queue.qsize(),
            "in_flight": in_flight,
            "counters": dict(self.counters),
            "store": self.store.counters.to_json(),
        }

    def _handle_compile(self, req: Dict) -> Dict:
        if self._draining.is_set():
            return {"ok": False, "error": "FarmUnavailable",
                    "message": "daemon is draining; retry elsewhere"}
        name = req.get("workload")
        if not isinstance(name, str):
            return {"ok": False, "error": "ProtocolError",
                    "message": "compile request needs a workload name"}
        unroll = req.get("unroll")
        arch = req.get("arch", "plaid2x2")
        mapper = req.get("mapper", "hierarchical")
        seed = int(req.get("seed", 0))
        budget = req.get("budget")
        iterations = req.get("iterations")
        verify = bool(req.get("verify"))
        deadline_s = req.get("deadline_s")
        if deadline_s is None:
            deadline_s = self.default_deadline_s

        try:
            key = compile_key(name, arch=arch, mapper=mapper, seed=seed,
                              budget=budget, unroll=unroll,
                              iterations=iterations)
        except CompileError as e:
            return self._error_response(e)
        except KeyError as e:
            return {"ok": False, "error": "CompileError",
                    "message": f"unknown workload or arch: {e}"}

        cached = serve_from_store(self.store, key, verify=verify,
                                  device=self.device)
        if cached is not None:
            self.counters["hits"] += 1
            return {"ok": True, "hit": True, "artifact": cached.to_json()}

        task = (self.store_path, name, unroll, arch, mapper, seed, budget,
                iterations, verify, self.device)
        label = key.describe()
        with self._lock:
            job = self._jobs.get(key.digest)
            if job is not None:
                job.waiters += 1
                self.counters["dedup_attached"] += 1
            else:
                if len(self._jobs) >= self.queue_limit:
                    self.counters["shed"] += 1
                    return {"ok": False, "error": "ServiceOverloaded",
                            "message": f"farm at capacity "
                                       f"({len(self._jobs)} jobs queued or "
                                       f"running); retry with backoff",
                            "queue_depth": len(self._jobs),
                            "queue_limit": self.queue_limit}
                job = _Job(digest=key.digest, task=task, label=label,
                           deadline_s=deadline_s, retries=self.retries)
                self._jobs[key.digest] = job
                self._queue.put(job)

        wait_s = None
        if deadline_s is not None:
            # cover queueing + one reclaimed retry attempt
            wait_s = deadline_s * (1 + max(0, job.retries)) + _WAIT_GRACE_S
        if not job.done.wait(timeout=wait_s):
            timeout = CompileTimeout(
                f"farm job {label} still running after {wait_s:.0f}s wait",
                deadline_s=deadline_s)
            return self._error_response(timeout)
        return dict(job.response)

    def _error_response(self, err: Exception) -> Dict:
        resp = {"ok": False, "error": type(err).__name__,
                "message": str(err)}
        to_json = getattr(err, "to_json", None)
        if callable(to_json):
            try:
                resp["detail"] = to_json()
            except Exception:
                pass
        return resp

    # -- workers -------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is _STOP:
                return
            runner = SupervisedRunner(
                fn=_farm_compile, jobs=1, timeout_s=job.deadline_s,
                retries=job.retries, start_method=self.start_method,
                label=lambda _task, label=job.label: label,
                device=self.device)
            response = None
            try:
                for _task, status, payload in runner.run([job.task]):
                    if status == "ok":
                        self.counters["compiles"] += 1
                        response = {"ok": True, "hit": False,
                                    "artifact": payload}
                    else:
                        self.counters["failures"] += 1
                        response = {"ok": False, "error": payload.error,
                                    "message": payload.message,
                                    "failure": payload.to_json()}
            except Exception as e:  # runner itself blew up
                self.counters["failures"] += 1
                response = {"ok": False, "error": type(e).__name__,
                            "message": str(e)}
            if response is None:
                self.counters["failures"] += 1
                response = {"ok": False, "error": "WorkerCrashed",
                            "message": "runner yielded no result"}
            with self._lock:
                self._jobs.pop(job.digest, None)
                job.response = response
                job.done.set()


def serve(store_path: str, socket_path: str, **kwargs) -> int:
    """CLI entry: build a farm and block until SIGTERM/SIGINT drain."""
    return CompileFarm(store_path, socket_path, **kwargs).serve_forever()
