"""Append-only journaled index for the artifact store (port of
``repro/compiler/journal.py``: the same snapshot and journal schemas,
records and checksums, so either package replays the other's index).

A whole-file ``index.json`` rewritten atomically under one flock on
**every** mutation costs O(entries) serialization per put/touch — fine at
70 entries, hopeless at 100k.  This module gives the index a write-ahead
shape instead:

* ``index.json`` — the **snapshot**: ``{"schema":
  "repro.compiler/store-index@2", "epoch": E, "base_seq": N,
  "entries": {digest: row}}``.  Rewritten only by compaction / rebuild,
  never on the hot path.
* ``journal.jsonl`` — the **journal**: one JSON record per line, each
  carrying a truncated-SHA-256 checksum of itself (``"c"``).  The first
  line is a header naming the journal schema and the snapshot epoch it
  extends.  Appends are O(1): open in append mode, write one line, done —
  no read-modify-write, no index deserialization.

Record ops (all under the store's single ``index.json.lock``):

* ``put``    — insert/replace a row (carries the full row minus ``seq``)
* ``touch``  — a serve: bump hits + LRU recency; carries a fallback row so
  an *orphan* entry (writer died between the entry write and its journal
  append) self-heals on its first hit
* ``verify`` — persist a positive verification verdict
* ``del``    — drop a row (eviction, quarantine, discard)

Replay folds the journal onto the snapshot left to right.  The monotonic
LRU ``seq`` stamp is **derived from replay order** (``base_seq`` + the
record's position), so appends never need to read the current maximum —
that is what makes them O(1) while keeping eviction order immune to
clock skew across processes.

Crash safety (``kill -9`` at any write point):

* a torn tail (partial last line, bit-flipped record) fails its checksum
  or JSON parse; recovery **truncates the journal at the first bad line**
  (under the lock) and keeps everything before it;
* a crash between the entry-file write and the journal append leaves an
  orphan entry: invisible to the index until its first ``get`` (touch
  self-heal) or the next listing reconcile/rebuild;
* a crash inside compaction (snapshot written, journal not yet reset)
  leaves a *stale* journal whose epoch trails the snapshot's.  Its
  records are already folded into the snapshot; replaying them again is
  idempotent for rows (hit counts can inflate by one — advisory
  bookkeeping, never correctness), and the loader reports the state as
  ``dirty`` so the store re-compacts immediately;
* an unparseable snapshot is quarantined and the caller falls back to the
  ``entries/`` rebuild — which also transparently migrates any
  legacy whole-file ``store-index@1`` to this layout.

Durability note: appends rely on the atomicity of a single ``write()`` to
an ``O_APPEND`` file plus the torn-tail recovery above; they do not
``fsync`` (a killed *process* loses nothing that reached ``write()``, and
the store's contract has always been process-crash safety, not
power-loss safety).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler import faultinject
from repro_torch.compiler.fsio import (
    atomic_write_bytes,
    atomic_write_json,
    quarantine,
    sha256_of_json,
)

SNAPSHOT_SCHEMA = "repro.compiler/store-index@2"
JOURNAL_SCHEMA = "repro.compiler/store-journal@1"
#: journal size that triggers compaction on the next locked append/load
COMPACT_BYTES = 256 * 1024
#: checksum length: 12 hex chars of SHA-256 — torn/bit-rotted lines are
#: what it must catch, not adversaries (the entries carry full digests)
_CRC_LEN = 12

_OPS = ("put", "touch", "verify", "del")


def _crc(rec: Dict[str, object]) -> str:
    return sha256_of_json({k: v for k, v in rec.items() if k != "c"})[:_CRC_LEN]


def _seal(rec: Dict[str, object]) -> Dict[str, object]:
    rec["c"] = _crc(rec)
    return rec


def put_record(digest: str, row: Dict[str, object]) -> Dict[str, object]:
    row = {k: v for k, v in row.items() if k != "seq"}
    return _seal({"op": "put", "d": digest, "row": row})


def touch_record(digest: str, t: float, verified: bool,
                 fallback_row: Optional[Dict[str, object]]) -> Dict[str, object]:
    rec: Dict[str, object] = {"op": "touch", "d": digest, "t": t}
    if verified:
        rec["v"] = True
    if fallback_row is not None:
        rec["row"] = {k: v for k, v in fallback_row.items() if k != "seq"}
    return _seal(rec)


def verify_record(digest: str) -> Dict[str, object]:
    return _seal({"op": "verify", "d": digest})


def del_record(digest: str) -> Dict[str, object]:
    return _seal({"op": "del", "d": digest})


@dataclass
class LoadedState:
    """Replayed index state.  ``dirty`` asks the store to compact now
    (stale journal after a crashed compaction, or a healed torn tail)."""

    entries: Dict[str, Dict] = field(default_factory=dict)
    next_seq: int = 0
    epoch: int = 0
    dirty: bool = False


class StoreJournal:
    """Snapshot + journal persistence for one store's index.

    Every method assumes the caller holds the store's index lock
    (``fsio.locked(snapshot_path)``); nothing here locks on its own.
    """

    def __init__(self, snapshot_path: str, journal_path: str,
                 compact_bytes: int = COMPACT_BYTES):
        self.snapshot_path = snapshot_path
        self.journal_path = journal_path
        self.compact_bytes = compact_bytes

    # -- snapshot ----------------------------------------------------------
    def _read_snapshot(self) -> Tuple[Optional[Dict], bool]:
        """``(snapshot dict | None, usable)``: ``(None, True)`` = missing,
        ``(None, False)`` = corrupt/legacy (caller must rebuild)."""
        try:
            with open(self.snapshot_path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return None, True
        except ValueError:
            # parse failure = corruption (transient I/O errors propagate)
            quarantine(self.snapshot_path)
            return None, False
        if (not isinstance(data, dict)
                or data.get("schema") != SNAPSHOT_SCHEMA
                or not isinstance(data.get("entries"), dict)):
            # a legacy store-index@1 (or garbage) — rebuild migrates it
            return None, False
        return data, True

    # -- journal parsing ---------------------------------------------------
    def _parse_journal(self) -> Tuple[Optional[int], List[Dict], bool]:
        """``(header epoch | None, records, truncated_tail)``.  A bad line
        (failed parse or checksum) truncates the journal from that byte on
        — the torn-tail recovery; everything before it is kept."""
        try:
            with open(self.journal_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None, [], False
        epoch: Optional[int] = None
        records: List[Dict] = []
        offset = 0
        bad_at: Optional[int] = None
        while offset < len(raw):
            nl = raw.find(b"\n", offset)
            if nl < 0:
                bad_at = offset  # torn final line (no terminator)
                break
            line = raw[offset:nl]
            rec = self._check_line(line, first=offset == 0)
            if rec is None:
                bad_at = offset
                break
            if offset == 0:
                epoch = int(rec["epoch"])
            else:
                records.append(rec)
            offset = nl + 1
        if bad_at is not None:
            with open(self.journal_path, "r+b") as f:
                f.truncate(bad_at)
            print(f"warning: {self.journal_path}: torn/corrupt record at "
                  f"byte {bad_at}; truncated tail "
                  f"({len(raw) - bad_at} byte(s) dropped)", flush=True)
            if bad_at == 0:
                return None, [], True
        return epoch, records, bad_at is not None

    @staticmethod
    def _check_line(line: bytes, first: bool) -> Optional[Dict]:
        try:
            rec = json.loads(line)
        except ValueError:
            return None
        if not isinstance(rec, dict):
            return None
        if first:
            if (rec.get("journal") != JOURNAL_SCHEMA
                    or not isinstance(rec.get("epoch"), int)):
                return None
            return rec
        if rec.get("c") != _crc(rec):
            return None
        if rec.get("op") not in _OPS or not isinstance(rec.get("d"), str):
            return None
        return rec

    # -- replay ------------------------------------------------------------
    @staticmethod
    def _apply(state: LoadedState, rec: Dict) -> None:
        op, digest = rec["op"], rec["d"]
        entries = state.entries
        if op == "put":
            row = dict(rec.get("row") or {})
            prev = entries.get(digest)
            if prev:
                # bookkeeping carries across a same-key re-put; a verified
                # verdict belongs to one exact payload, so it survives only
                # while the content digest is unchanged
                row["hits"] = int(prev.get("hits", row.get("hits", 0)))
                row["created"] = prev.get("created", row.get("created"))
                if (not row.get("verified") and prev.get("verified")
                        and prev.get("digest") == row.get("digest")):
                    row["verified"] = True
            state.next_seq += 1
            row["seq"] = state.next_seq
            entries[digest] = row
        elif op == "touch":
            row = entries.get(digest)
            if row is None and isinstance(rec.get("row"), dict):
                # orphan self-heal: the entry file exists (a get just read
                # it) but its put record was lost to a crash
                row = dict(rec["row"])
                row["hits"] = 0
                entries[digest] = row
            if row is not None:
                state.next_seq += 1
                row["seq"] = state.next_seq
                row["hits"] = int(row.get("hits", 0)) + 1
                row["last_used"] = rec.get("t", row.get("last_used"))
                if rec.get("v"):
                    row["verified"] = True
        elif op == "verify":
            row = entries.get(digest)
            if row is not None:
                row["verified"] = True
        elif op == "del":
            entries.pop(digest, None)

    def load(self) -> Optional[LoadedState]:
        """Replay snapshot + journal into a :class:`LoadedState`, healing
        a torn journal tail on the way.  ``None`` means the persisted
        state is unusable (corrupt/legacy/missing snapshot with survivors
        on disk) and the caller must rebuild from ``entries/``."""
        snap, usable = self._read_snapshot()
        if not usable:
            return None
        epoch, records, truncated = self._parse_journal()
        if snap is None:
            if epoch is None and not records:
                # genuinely fresh store (no snapshot, no journal)
                return LoadedState(dirty=truncated)
            # journal without its snapshot (hand-deleted / partial copy):
            # the journal alone cannot reconstruct pre-compaction rows
            return None
        state = LoadedState(
            entries={d: dict(r) for d, r in snap["entries"].items()},
            next_seq=int(snap.get("base_seq", 0)),
            epoch=int(snap.get("epoch", 0)),
            dirty=truncated,
        )
        if epoch is not None and epoch != state.epoch:
            # stale journal: a compaction crashed between its snapshot
            # write and the journal reset.  These records are already
            # folded into the snapshot; replaying them is idempotent for
            # rows (hit counts may inflate — advisory only).  Mark dirty
            # so the store re-compacts and restores the invariant.
            state.dirty = True
        for rec in records:
            self._apply(state, rec)
        return state

    # -- writes ------------------------------------------------------------
    def append(self, records: List[Dict[str, object]], label: str = "") -> None:
        """Append sealed records as one ``write()`` — the O(1) hot path.
        Creates the journal (header line) on first use."""
        if not records:
            return
        faultinject.check("store.journal", label)
        lines = b""
        try:
            size = os.path.getsize(self.journal_path)
        except OSError:
            size = 0
        if size == 0:
            snap, usable = self._read_snapshot()
            epoch = int(snap.get("epoch", 0)) if (usable and snap) else 0
            if snap is None and usable:
                # first append ever: commit an empty snapshot alongside the
                # header, so "snapshot missing but journal present" is
                # unambiguously a hand-deleted/partial-copy store (rebuild
                # from entries/), never a normal young one
                atomic_write_json(self.snapshot_path, {
                    "schema": SNAPSHOT_SCHEMA, "epoch": epoch,
                    "base_seq": 0, "entries": {},
                })
            header = {"journal": JOURNAL_SCHEMA, "epoch": epoch}
            lines += json.dumps(header, sort_keys=True).encode() + b"\n"
        for rec in records:
            lines += json.dumps(rec, sort_keys=True).encode() + b"\n"
        d = os.path.dirname(self.journal_path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(self.journal_path,
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
        try:
            os.write(fd, lines)
        finally:
            os.close(fd)
        # chaos hook: tear the just-appended record on disk; the per-line
        # checksum must catch it and recovery must truncate the tail
        faultinject.maybe_corrupt(self.journal_path, "store.journal", label)

    def replace(self, entries: Dict[str, Dict], next_seq: Optional[int] = None,
                label: str = "") -> None:
        """Write a fresh snapshot holding ``entries`` and reset the journal
        to an empty epoch-stamped header — compaction, rebuild, and gc all
        land here.  Crash-ordering: the snapshot (epoch E+1) commits
        atomically first; dying before the journal reset leaves a stale
        epoch-E journal that :meth:`load` detects and re-compacts."""
        if next_seq is None:
            next_seq = max((int(r.get("seq", 0)) for r in entries.values()),
                           default=0)
        snap, usable = self._read_snapshot()
        epoch = (int(snap.get("epoch", 0)) if (usable and snap) else 0) + 1
        atomic_write_json(self.snapshot_path, {
            "schema": SNAPSHOT_SCHEMA,
            "epoch": epoch,
            "base_seq": int(next_seq),
            "entries": entries,
        })
        faultinject.check("store.compact", label)
        header = {"journal": JOURNAL_SCHEMA, "epoch": epoch}
        atomic_write_bytes(self.journal_path,
                           json.dumps(header, sort_keys=True).encode() + b"\n")

    def journal_bytes(self) -> int:
        try:
            return os.path.getsize(self.journal_path)
        except OSError:
            return 0

    def wants_compaction(self) -> bool:
        return self.journal_bytes() >= self.compact_bytes

    # -- best-effort bookkeeping recovery ----------------------------------
    def best_effort_rows(self) -> Dict[str, Dict]:
        """Rows recoverable from the snapshot + journal with every
        structural check relaxed — carries hits / verified / LRU
        bookkeeping into an ``entries/`` rebuild.  Also reads legacy
        ``store-index@1`` files (their ``entries`` map has the same row
        shape), which is what migrates a legacy store in place."""
        rows: Dict[str, Dict] = {}
        try:
            with open(self.snapshot_path) as f:
                data = json.load(f)
            if isinstance(data, dict) and isinstance(data.get("entries"),
                                                     dict):
                for d, r in data["entries"].items():
                    if isinstance(r, dict):
                        rows[d] = dict(r)
        except (OSError, ValueError):
            pass
        try:
            state = LoadedState(entries=rows, next_seq=max(
                (int(r.get("seq", 0)) for r in rows.values()), default=0))
            _, records, _ = self._parse_journal()
            for rec in records:
                self._apply(state, rec)
        except (OSError, ValueError, TypeError, KeyError):
            pass
        return rows
