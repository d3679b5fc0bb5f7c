"""Wire format of the compile farm (port of ``repro/serve_farm/protocol.py``,
byte for byte): length-prefixed JSON over a Unix-domain stream socket.

One frame = a 4-byte big-endian payload length followed by that many
bytes of UTF-8 JSON.  The prefix makes message boundaries explicit (no
sentinel scanning, binary-safe payloads) and lets the receiver reject an
oversized or garbage frame *before* buffering it.  Requests and
responses are single frames; a connection carries one request/response
exchange (idempotent resubmission after a dropped connection is the
client's retry loop, not connection state).

Ops (all requests carry ``{"op": ...}``):

* ``ping``     → liveness probe
* ``status``   → queue depth, in-flight jobs, hit/shed counters, uptime
* ``compile``  → ``{workload, unroll, arch, mapper, seed, budget,
  iterations, verify, deadline_s}``; the response carries the artifact
  JSON and whether it was served warm (``hit``)
* ``shutdown`` → ask the daemon to drain and exit

Error responses are ``{"ok": false, "error": <taxonomy class name>,
"message": ...}`` plus class-specific fields (``queue_depth`` /
``queue_limit`` for ``ServiceOverloaded``); the client re-raises them as
the matching :mod:`repro_torch.compiler.errors` class, so a shed request
exits a CLI with the same typed code remotely as locally.  Requests carry
no device: the daemon proves what it serves on its own.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Dict

#: hard cap on one frame — far above any artifact, far below a runaway
MAX_FRAME = 64 * 1024 * 1024
_HEADER = struct.Struct(">I")


class ProtocolError(ConnectionError):
    """The peer sent bytes that are not a valid frame (bad length,
    oversized payload, non-JSON body).  A ``ConnectionError`` so client
    retry loops treat a mid-frame-died daemon like a refused one."""


def send_msg(sock: socket.socket, obj: Dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(data)} bytes exceeds "
                            f"MAX_FRAME ({MAX_FRAME})")
    sock.sendall(_HEADER.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Dict:
    """Receive one frame; raises :class:`ProtocolError` on a malformed
    one and ``ConnectionError`` when the peer closes mid-frame."""
    header = _recv_exact(sock, _HEADER.size)
    (n,) = _HEADER.unpack(header)
    if n > MAX_FRAME:
        raise ProtocolError(f"peer announced a {n}-byte frame "
                            f"(> MAX_FRAME {MAX_FRAME})")
    payload = _recv_exact(sock, n)
    try:
        obj = json.loads(payload)
    except ValueError as e:
        raise ProtocolError(f"frame payload is not valid JSON: {e}")
    if not isinstance(obj, dict):
        raise ProtocolError("frame payload must be a JSON object")
    return obj


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed the connection mid-frame "
                f"({len(buf)}/{n} bytes received)")
        buf += chunk
    return buf
