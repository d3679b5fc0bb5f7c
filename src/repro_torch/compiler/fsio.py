"""Canonical JSON serialization (port of the digest half of
``repro/compiler/fsio.py``): sorted keys and minimal separators, byte for
byte the same as the JAX package's, so an artifact's ``mappings_sha256``
binds in both packages."""
from __future__ import annotations

import hashlib
import json


def canonical_json_bytes(obj: object) -> bytes:
    """The canonical byte serialization digests are computed over."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def sha256_of_json(obj: object) -> str:
    return hashlib.sha256(canonical_json_bytes(obj)).hexdigest()
