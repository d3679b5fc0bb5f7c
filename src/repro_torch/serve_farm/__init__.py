"""The compile farm (port of ``repro/serve_farm``): a long-lived ``python
-m repro_torch serve`` daemon over a Unix-domain socket, plus the retrying
remote client behind ``compile(..., remote=)`` and ``collect --remote``.

* :mod:`repro_torch.serve_farm.protocol` — length-prefixed JSON frames;
* :mod:`repro_torch.serve_farm.daemon` — :class:`CompileFarm`:
  cache-first lookup (a verifying hit proven on the daemon's device),
  in-flight dedup of identical ``CompileKey``s, a bounded job queue with
  explicit load-shedding, supervised worker processes, and graceful drain
  on SIGTERM;
* :mod:`repro_torch.serve_farm.client` — bounded deterministic retry with
  exponential backoff + jitter, idempotent resubmission, and a circuit
  breaker that degrades to local compiles.

Frames, ops, error responses and counters are the JAX package's, so
either package's client talks to either package's daemon.
"""
from repro_torch.serve_farm.client import (
    farm_request,
    farm_status,
    remote_compile,
)
from repro_torch.serve_farm.daemon import CompileFarm

__all__ = ["CompileFarm", "farm_request", "farm_status", "remote_compile"]
