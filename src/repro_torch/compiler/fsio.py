"""Durable JSON I/O shared by the artifact store, ``CompileResult.save``
and the bench writer (port of ``repro/compiler/fsio.py``; the canonical
serialization is byte for byte the JAX package's, so digests bind in both
packages).

Three primitives, kept leaf-level (stdlib only) so every layer can import
them without cycles:

* :func:`atomic_write_json` / :func:`atomic_write_bytes` — write to a
  temp file **in the destination directory** and ``os.replace`` it into
  place.  A crash (including ``kill -9``) at any point leaves either the
  old file or the new file, never a truncated hybrid; stray ``.tmp-*``
  files are the only possible residue and are ignored by every reader.
* :func:`canonical_json_bytes` / :func:`sha256_of_json` — the canonical
  serialization (sorted keys, minimal separators) that content-addressed
  digests are computed over.  Two value-equal payloads always hash
  equally, regardless of dict insertion order or indentation.
* :func:`locked` — an advisory exclusive lock (``fcntl.flock``) held on a
  sidecar ``<path>.lock`` file for the duration of a read-modify-write.
  With ``timeout_s`` set, a lock that cannot be acquired in time raises
  :class:`~repro_torch.compiler.errors.LockTimeout` instead of blocking forever
  behind a dead lock-holder.  On platforms without ``fcntl`` it degrades
  to a no-op (the atomic replace still guarantees per-file integrity,
  just not lost-update protection).

This module stays leaf-level: stdlib plus the (equally leaf-level) error
taxonomy, so every layer can import it without cycles.
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, Optional

from repro_torch.compiler.errors import LockTimeout

try:  # POSIX; the no-op fallback keeps imports working elsewhere
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platforms
    fcntl = None


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``data`` to ``path`` atomically (temp file + ``os.replace``)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    # hidden name, non-.json suffix: readers that scan the directory
    # (store index rebuild) must never mistake an in-flight temp file for
    # a committed entry
    fd, tmp = tempfile.mkstemp(dir=d, prefix=f".tmp-{os.path.basename(path)}-",
                               suffix=".part")
    try:
        # mkstemp creates 0600; restore normal umask-governed permissions
        # so shared stores/artifacts stay readable by other users
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_json(path: str, obj: object, *, indent: Optional[int] = 1,
                      sort_keys: bool = False) -> str:
    """Atomically serialize ``obj`` as JSON to ``path``."""
    data = json.dumps(obj, indent=indent, sort_keys=sort_keys).encode()
    return atomic_write_bytes(path, data)


def canonical_json_bytes(obj: object) -> bytes:
    """The canonical byte serialization digests are computed over."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def sha256_of_json(obj: object) -> str:
    return hashlib.sha256(canonical_json_bytes(obj)).hexdigest()


@contextmanager
def locked(path: str, timeout_s: Optional[float] = None):
    """Exclusive advisory lock on ``<path>.lock`` for a read-modify-write.

    Lock the *sidecar*, never the data file: the data file is swapped out
    from under its inode by ``os.replace``, which would silently break
    ``flock`` on it.

    ``timeout_s`` bounds the wait: ``None`` blocks indefinitely (the
    pre-existing behaviour); otherwise the lock is polled non-blockingly
    and :class:`~repro_torch.compiler.errors.LockTimeout` is raised once the
    budget is spent — a worker that died (or hung) while holding the lock
    must not strand every later writer forever.
    """
    if fcntl is None:  # pragma: no cover - non-POSIX platforms
        yield
        return
    lock_path = path + ".lock"
    d = os.path.dirname(lock_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(lock_path, "a+") as lf:
        if timeout_s is None:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        else:
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError as e:
                    if e.errno not in (errno.EAGAIN, errno.EACCES,
                                       errno.EWOULDBLOCK):
                        raise
                    if time.monotonic() >= deadline:
                        raise LockTimeout(
                            f"could not acquire {lock_path} within "
                            f"{timeout_s}s (dead or hung lock-holder?)",
                            lock_path=lock_path, timeout_s=timeout_s,
                        )
                    time.sleep(0.05)
        try:
            yield
        finally:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)


def quarantine(path: str, reason: str = "corrupt") -> Optional[str]:
    """Move an unparseable/tampered file aside (never delete user data);
    returns the quarantine path, or ``None`` if the file vanished first."""
    for i in range(1000):
        suffix = f".{reason}" if i == 0 else f".{reason}.{i}"
        target = path + suffix
        if os.path.exists(target):
            continue
        try:
            os.replace(path, target)
            return target
        except FileNotFoundError:
            return None
    raise OSError(f"could not quarantine {path}: too many {reason} files")


def load_json_or_quarantine(path: str, default) -> Dict:
    """Read JSON from ``path``; an unparseable file is quarantined (not
    deleted) and ``default`` is returned — callers never crash on a file a
    previous interrupted/duplicated writer mangled.  Only parse failures
    mean corruption: transient I/O errors (EIO, EACCES) propagate rather
    than destroy an intact file."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return default
    except ValueError:
        q = quarantine(path)
        if q:
            print(f"warning: {path} was unparseable; quarantined to {q}",
                  flush=True)
        return default
