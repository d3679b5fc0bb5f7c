"""The port's compile farm (``repro_torch.serve_farm``) on the CPU
(``device="cpu"``): the ports of ``tests/test_serve_farm.py``'s protocol,
daemon and client tests, and the wire between the packages — the JAX
package's client against the port's daemon and the port's client against
the JAX package's daemon, each artifact equal to a local compile of either
package.  Tolerance: exact equality (frames byte for byte, mappings and
headline numbers of every artifact).

Also: ``CompileFarm()`` with no device refuses without a card, and
``compile(..., fallback_mapper=, fallback_deadline_s=)`` stamps the
``degraded`` block as the JAX package does.
"""
import os
import socket
import struct
import threading
import time

import pytest
import torch

from repro.compiler import compile as jax_compile
from repro.compiler.errors import CompileTimeout as JaxCompileTimeout
from repro.serve_farm import client as jax_client
from repro.serve_farm import protocol as jax_protocol
from repro.serve_farm.daemon import CompileFarm as JaxCompileFarm
from repro_torch.compiler.errors import (
    CompileTimeout,
    FarmUnavailable,
    ServiceOverloaded,
)
from repro_torch.compiler.pipeline import compile as port_compile
from repro_torch.compiler.pipeline import compile_key
from repro_torch.serve_farm.client import (
    _jitter,
    farm_ping,
    farm_request,
    farm_status,
    remote_compile,
    reset_breakers,
)
from repro_torch.serve_farm.daemon import _STOP, CompileFarm, _Job
from repro_torch.serve_farm.protocol import (
    MAX_FRAME,
    ProtocolError,
    recv_msg,
    send_msg,
)


@pytest.fixture(autouse=True)
def full_budget(monkeypatch):
    monkeypatch.delenv("REPRO_QUICK", raising=False)


def _headline(res):
    return (res.ii, res.cycles, res.makespan, res.mappings)


# -- wire protocol -----------------------------------------------------------


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def test_protocol_round_trip():
    a, b = _pair()
    with a, b:
        msg = {"op": "compile", "workload": "atax", "unroll": 2,
               "budget": None, "nested": {"x": [1, 2.5, "s"]}}
        send_msg(a, msg)
        assert recv_msg(b) == msg
        send_msg(b, {"ok": True})
        assert recv_msg(a) == {"ok": True}


def test_protocol_frames_equal_the_jax_package_bytes():
    msg = {"op": "compile", "workload": "atax", "unroll": 2, "seed": 0,
           "budget": None, "verify": True, "deadline_s": 1.5}
    frames = []
    for send in (send_msg, jax_protocol.send_msg):
        a, b = _pair()
        with a, b:
            send(a, msg)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(65536):
                data += chunk
            frames.append(data)
    assert frames[0] == frames[1]
    assert MAX_FRAME == jax_protocol.MAX_FRAME


def test_protocol_peer_closed_mid_frame():
    a, b = _pair()
    with b:
        a.sendall(struct.pack(">I", 100) + b"abc")
        a.close()
        with pytest.raises(ConnectionError):
            recv_msg(b)


def test_protocol_rejects_oversized_frame_before_buffering():
    a, b = _pair()
    with a, b:
        a.sendall(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(ProtocolError):
            recv_msg(b)


@pytest.mark.parametrize("payload", [b"not json at all", b"[1,2,3]"])
def test_protocol_rejects_non_object_payload(payload):
    a, b = _pair()
    with a, b:
        a.sendall(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(ProtocolError):
            recv_msg(b)


# -- daemon ------------------------------------------------------------------


@pytest.fixture
def farm(tmp_path):
    reset_breakers()
    sock = str(tmp_path / "f.sock")
    f = CompileFarm(str(tmp_path / "store"), sock, workers=2,
                    queue_limit=4, default_deadline_s=120.0, retries=0,
                    device="cpu")
    f.start()
    yield f, sock
    f.shutdown()
    reset_breakers()


def test_ping_and_status(farm):
    f, sock = farm
    assert farm_ping(sock) is True
    st = farm_status(sock)
    assert st["ok"] and st["pid"] == os.getpid()
    assert st["workers"] == 2 and st["queue_limit"] == 4
    assert st["draining"] is False
    assert st["counters"] == {"requests": 2, "hits": 0, "compiles": 0,
                              "dedup_attached": 0, "shed": 0, "failures": 0}
    assert f.device == "cpu"


def test_unknown_op_is_a_protocol_error(farm):
    _, sock = farm
    resp = farm_request(sock, {"op": "frobnicate"}, retries=0)
    assert resp["ok"] is False and resp["error"] == "ProtocolError"


def test_compile_without_workload_is_rejected(farm):
    _, sock = farm
    resp = farm_request(sock, {"op": "compile"}, retries=0)
    assert resp["ok"] is False and resp["error"] == "ProtocolError"


def test_remote_cold_then_warm_equal_to_local(farm):
    f, sock = farm
    local = port_compile("atax", unroll=2, arch="plaid2x2",
                         mapper="hierarchical", seed=0, verify=True,
                         device="cpu")
    cold = remote_compile(sock, workload="atax", unroll=2, verify=True,
                          retries=0, timeout_s=120.0)
    assert cold.store_hit is False and cold.verified is True
    warm = remote_compile(sock, workload="atax", unroll=2, verify=True,
                          retries=0, timeout_s=120.0)
    assert warm.store_hit is True and warm.verified is True
    assert _headline(cold) == _headline(warm) == _headline(local)
    assert f.counters["compiles"] == 1
    assert f.counters["hits"] == 1


def test_unverified_hit_is_proven_on_the_farm_device(farm):
    f, sock = farm
    cold = remote_compile(sock, workload="atax", unroll=2, retries=0,
                          timeout_s=120.0)
    assert cold.verified is None  # stored unverified
    key = compile_key("atax", unroll=2)
    assert f.store.is_verified(key) is False
    warm = remote_compile(sock, workload="atax", unroll=2, verify=True,
                          retries=0, timeout_s=120.0)
    assert warm.store_hit is True and warm.verified is True
    assert f.store.is_verified(key) is True
    assert f.counters == {**f.counters, "compiles": 1, "hits": 1}


def test_failed_compile_answers_with_its_failure_record(farm):
    """A worker past its deadline is the runner's structured failure,
    typed: each package's client raises its own ``CompileTimeout``."""
    f, sock = farm
    req = {"op": "compile", "workload": "jacobi", "unroll": 4,
           "deadline_s": 0.05}
    resp = farm_request(sock, req, retries=0, timeout_s=120.0)
    assert resp["ok"] is False and resp["error"] == "CompileTimeout"
    assert resp["failure"]["attempts"] == 1
    assert f.counters["failures"] == 1
    with pytest.raises(CompileTimeout):
        remote_compile(sock, workload="jacobi", unroll=4, deadline_s=0.05,
                       retries=0, timeout_s=120.0)
    jax_client.reset_breakers()
    with pytest.raises(JaxCompileTimeout):
        jax_client.remote_compile(sock, workload="jacobi", unroll=4,
                                  deadline_s=0.05, retries=0,
                                  timeout_s=120.0)


def test_inflight_dedup_attaches_instead_of_recompiling(farm):
    f, sock = farm
    key = compile_key("atax", unroll=2)
    # park a fake in-flight job for that key (never enqueued, so no
    # worker can complete it behind the test's back)
    job = _Job(digest=key.digest, task=(), label="t", deadline_s=60.0,
               retries=0)
    with f._lock:
        f._jobs[key.digest] = job
    sentinel = {"ok": True, "hit": False, "artifact": {"fake": 1}}
    results = []
    t = threading.Thread(target=lambda: results.append(farm_request(
        sock, {"op": "compile", "workload": "atax", "unroll": 2},
        retries=0, timeout_s=60.0)))
    t.start()
    deadline = time.monotonic() + 10.0
    while f.counters["dedup_attached"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert f.counters["dedup_attached"] == 1
    assert job.waiters == 2
    with f._lock:
        f._jobs.pop(key.digest, None)
        job.response = sentinel
        job.done.set()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert results and results[0]["artifact"] == {"fake": 1}
    assert f.counters["compiles"] == 0


def test_overload_sheds_with_typed_error(farm):
    f, sock = farm
    with f._lock:
        for i in range(f.queue_limit):
            f._jobs[f"fake-{i}"] = _Job(digest=f"fake-{i}", task=(),
                                        label="t", deadline_s=1.0, retries=0)
    try:
        with pytest.raises(ServiceOverloaded) as ei:
            farm_request(sock, {"op": "compile", "workload": "atax",
                                "unroll": 2}, retries=1, backoff_s=0.01)
        assert ei.value.queue_depth == f.queue_limit
        assert ei.value.queue_limit == f.queue_limit
        assert ei.value.exit_code == 17
        assert f.counters["shed"] == 2  # the shed was retried once
    finally:
        with f._lock:
            f._jobs.clear()


def test_draining_daemon_refuses_new_compiles(farm):
    f, _ = farm
    f._draining.set()
    resp = f._handle_compile({"op": "compile", "workload": "atax",
                              "unroll": 2})
    assert resp["ok"] is False and resp["error"] == "FarmUnavailable"
    f._draining.clear()


def test_drain_compacts_the_journal_and_removes_the_socket(tmp_path):
    reset_breakers()
    store = str(tmp_path / "store")
    sock = str(tmp_path / "f.sock")
    f = CompileFarm(store, sock, workers=1, default_deadline_s=120.0,
                    retries=0, device="cpu")
    f.start()
    remote_compile(sock, workload="atax", unroll=2, retries=0,
                   timeout_s=120.0)
    with open(os.path.join(store, "journal.jsonl")) as jf:
        assert len(jf.read().splitlines()) > 1
    f.shutdown()
    with open(os.path.join(store, "journal.jsonl")) as jf:
        assert len(jf.read().splitlines()) == 1  # the header alone
    assert not os.path.exists(sock)
    assert all(not t.is_alive() for t in f._threads)


def test_restart_over_stale_socket_serves_previous_artifacts_warm(tmp_path):
    reset_breakers()
    store = str(tmp_path / "store")
    sock = str(tmp_path / "f.sock")
    f1 = CompileFarm(store, sock, workers=1, default_deadline_s=120.0,
                     retries=0, device="cpu")
    f1.start()
    try:
        cold = remote_compile(sock, workload="atax", unroll=2, retries=0,
                              timeout_s=120.0)
    finally:
        # unclean stop: no drain, no compaction, the socket file left
        f1._draining.set()
        f1._listener.close()
        for _ in range(f1.workers):
            f1._queue.put(_STOP)
    assert os.path.exists(sock)

    f2 = CompileFarm(store, sock, workers=1, default_deadline_s=120.0,
                     retries=0, device="cpu")
    f2.start()
    try:
        warm = remote_compile(sock, workload="atax", unroll=2,
                              retries=2, backoff_s=0.05, timeout_s=120.0)
        assert warm.store_hit is True
        assert warm.mappings == cold.mappings
        assert f2.counters["hits"] == 1 and f2.counters["compiles"] == 0
    finally:
        f2.shutdown()
        reset_breakers()


# -- the wire between the packages -------------------------------------------


def test_jax_client_against_the_port_daemon(farm):
    f, sock = farm
    jax_client.reset_breakers()
    local = jax_compile("atax", unroll=2, arch="plaid2x2",
                        mapper="hierarchical", seed=0)
    cold = jax_client.remote_compile(sock, workload="atax", unroll=2,
                                     retries=0, timeout_s=120.0)
    warm = jax_client.remote_compile(sock, workload="atax", unroll=2,
                                     retries=0, timeout_s=120.0)
    assert (cold.store_hit, warm.store_hit) == (False, True)
    assert _headline(cold) == _headline(warm) == _headline(local)
    assert _headline(local) == _headline(port_compile(
        "atax", unroll=2, device="cpu"))
    assert jax_client.farm_status(sock)["counters"]["compiles"] == 1


def test_port_client_against_the_jax_daemon(tmp_path):
    reset_breakers()
    sock = str(tmp_path / "j.sock")
    jf = JaxCompileFarm(str(tmp_path / "store"), sock, workers=1,
                        default_deadline_s=120.0, retries=0)
    jf.start()
    try:
        cold = remote_compile(sock, workload="atax", unroll=2, retries=0,
                              timeout_s=120.0)
        warm = remote_compile(sock, workload="atax", unroll=2, retries=0,
                              timeout_s=120.0)
    finally:
        jf.shutdown()
        reset_breakers()
    local = port_compile("atax", unroll=2, device="cpu")
    assert (cold.store_hit, warm.store_hit) == (False, True)
    assert _headline(cold) == _headline(warm) == _headline(local)
    assert _headline(local) == _headline(jax_compile("atax", unroll=2))
    assert jf.counters["compiles"] == 1 and jf.counters["hits"] == 1


# -- client retry / circuit breaker ------------------------------------------


def test_jitter_is_deterministic_bounded_and_the_jax_package_schedule():
    vals = {_jitter("/tmp/a.sock", k, "atax/u2") for k in range(8)}
    assert all(0.0 <= v < 1.0 for v in vals)
    assert len(vals) > 1  # attempts actually spread
    for k in range(8):
        assert _jitter("/tmp/a.sock", k, "s") \
            == jax_client._jitter("/tmp/a.sock", k, "s")


def test_dead_socket_raises_farm_unavailable_and_opens_breaker(tmp_path):
    reset_breakers()
    addr = str(tmp_path / "nobody.sock")
    with pytest.raises(FarmUnavailable) as ei:
        farm_request(addr, {"op": "ping"}, retries=4, backoff_s=0.001)
    assert ei.value.exit_code == 18
    t0 = time.monotonic()
    with pytest.raises(FarmUnavailable) as ei:
        farm_request(addr, {"op": "ping"}, retries=4, backoff_s=0.5)
    assert time.monotonic() - t0 < 0.2
    assert "breaker" in str(ei.value)
    reset_breakers()


def test_farm_ping_false_on_dead_socket(tmp_path):
    assert farm_ping(str(tmp_path / "nobody.sock")) is False


def test_compile_remote_degrades_to_local_when_farm_is_down(tmp_path,
                                                            capsys):
    reset_breakers()
    out = port_compile("atax", unroll=2, store=str(tmp_path / "store"),
                       remote=str(tmp_path / "nobody.sock"), device="cpu")
    assert out.ii is not None and out.mappings  # local fallback compiled
    assert "compiling locally" in capsys.readouterr().out
    reset_breakers()


def test_raw_dfg_compiles_locally_with_remote(tmp_path, capsys):
    from repro_torch.core.workloads import build_workload, workload_by_name

    g = build_workload(workload_by_name("atax", 2))
    out = port_compile(g, remote=str(tmp_path / "nobody.sock"),
                       device="cpu")
    assert out.ii is not None
    assert "cannot be farmed" in capsys.readouterr().out


# -- device, fallback deadline -----------------------------------------------


def test_farm_without_a_card_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        CompileFarm(str(tmp_path / "store"), str(tmp_path / "f.sock"))
    assert not os.path.exists(tmp_path / "f.sock")


def test_fallback_deadline_degrades_as_the_jax_package():
    cell = dict(unroll=2, deadline_s=1e-6, fallback_mapper="node_greedy",
                fallback_deadline_s=600.0)
    port = port_compile("atax", device="cpu", **cell)
    ref = jax_compile("atax", **cell)
    for res in (port, ref):
        assert res.degraded["reason"] == "timeout"
        assert res.mapper == "node_greedy"
    drop = ("elapsed_s", "where")
    assert ({k: v for k, v in port.degraded.items() if k not in drop}
            == {k: v for k, v in ref.degraded.items() if k not in drop})
    assert _headline(port) == _headline(ref)
    # an unmeetable fallback deadline raises in both packages
    cell["fallback_deadline_s"] = 1e-6
    with pytest.raises(CompileTimeout):
        port_compile("atax", device="cpu", **cell)
    with pytest.raises(JaxCompileTimeout):
        jax_compile("atax", **cell)
