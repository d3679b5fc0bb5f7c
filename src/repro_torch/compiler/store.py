"""Content-addressed, on-disk store of compile artifacts — the serving tier
(port of ``repro/compiler/store.py``).

The unit of caching is a :class:`~repro_torch.compiler.artifact.CompileResult`
keyed by :class:`CompileKey` — the canonical (workload, arch, mapper, seed,
budget) tuple that fully determines a deterministic compile.  A warm store
hands out verified mappings **without re-running place & route**.  The
layout, digests, index rows, journal records and quarantine names are the
JAX package's, so a store written by either package is read by the other.
A verifying ``get`` proves the stored mapping on the store's ``device``
(``cuda`` unless the caller asks for the CPU): one ``sim_loop`` launch per
get on a card, and never the scalar oracle for a lowerable mapping.

Layout::

    <root>/
      index.json            # SNAPSHOT: {"schema": ...store-index@2,
                            #  "epoch", "base_seq", "entries": {digest: row}}
      journal.jsonl         # append-only mutation log extending the
                            #  snapshot; per-record checksums; first line
                            #  is an epoch-stamped header
      index.json.lock       # flock sidecar serializing appends/compaction
      entries/<keydigest>.json
        {"schema": "repro.compiler/store-entry@1",
         "key":     CompileKey.to_json(),
         "digest":  sha256(canonical artifact JSON),   # integrity digest
         "artifact": CompileResult.to_json()}

Index mutations (put / serve-touch / verify / discard) are **O(1) locked
appends** to ``journal.jsonl`` — no read-modify-write of an O(entries)
JSON file on the hot path (rewriting ``index.json`` whole on every serve
is fine at 70 entries, hopeless at 100k).  Reads replay
snapshot + journal; an oversized or stale journal is folded back into the
snapshot (compaction) under the same lock.  See
:mod:`repro_torch.compiler.journal` for the record format and the crash-safety
argument (torn-tail truncation, orphan self-heal, idempotent stale-epoch
replay).

Durability / correctness properties:

* **Content addressing** — the entry filename is the SHA-256 of the
  canonical key JSON; two processes compiling the same cell converge on
  the same path and the atomic replace makes the race benign (the
  artifacts are bit-identical by the determinism contract).
* **Integrity** — every entry carries a SHA-256 digest of its artifact
  payload, recomputed and checked on load.  A tampered or bit-rotted
  entry raises :class:`StoreIntegrityError` internally; ``get`` treats it
  as a miss and quarantines the file (``*.corrupt``).
* **Re-verification policy** — ``verify="never"|"first"|"always"``:
  ``first`` validates and replays the stored mapping on the cycle-accurate
  simulator the first time an entry is served (then remembers it in the
  index); ``always`` re-verifies every hit.  A mapping that fails
  verification is quarantined, never served.  A fault of the device path
  (an injected ``sim.batch`` ``OSError``, a CUDA error, a kernel wrapper
  refusing its inputs: :class:`~repro_torch.compiler.errors.
  SimulationFault`) or a device that is absent is not a failed
  verification: it propagates out of ``get`` and leaves the entry and the
  index as they were.
* **Self-healing index** — the snapshot + journal are a cache of the
  entry files, not the source of truth.  A torn journal tail is truncated
  on load; rows that disagree with the directory listing are reconciled
  (ghost rows dropped, orphan entries adopted after an integrity check);
  an unparseable snapshot is quarantined and the index rebuilt by
  scanning the entries — which also migrates legacy whole-file
  ``store-index@1`` files in place.
* **LRU eviction** — with ``max_bytes`` set, least-recently-served
  entries are evicted on ``put``/``gc`` until the payload fits.  Recency
  is a **monotonic sequence counter** persisted in the index (``seq``,
  advanced under the index lock on every serve/insert), not a wall-clock
  stamp: NFS or clock-skewed writers cannot reorder eviction.  The
  wall-clock ``last_used`` field is retained for display only.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.compiler import faultinject
from repro_torch.compiler.artifact import REPRO_VERSION, CompileResult
from repro_torch.compiler.errors import (VERIFY_FAILURES, ArtifactError,
                                         StoreIOError)
from repro_torch.compiler.fsio import (
    atomic_write_json,
    locked,
    quarantine,
    sha256_of_json,
)
from repro_torch.compiler.journal import (
    SNAPSHOT_SCHEMA,
    LoadedState,
    StoreJournal,
    del_record,
    put_record,
    touch_record,
    verify_record,
)

ENTRY_SCHEMA = "repro.compiler/store-entry@1"
#: current index schema — the snapshot half of the snapshot+journal pair
INDEX_SCHEMA = SNAPSHOT_SCHEMA
VERIFY_POLICIES = ("never", "first", "always")


class StoreIntegrityError(ArtifactError):
    """A store entry failed its digest or verification check.  Part of the
    error taxonomy via :class:`~repro_torch.compiler.errors.ArtifactError`
    (itself a ``ValueError``, preserving every pre-taxonomy handler)."""


@dataclass(frozen=True)
class CompileKey:
    """Canonical identity of one deterministic compile.

    ``workload`` is the artifact's workload-info dict (``{"name",
    "unroll", "iterations", "domain"}`` for TABLE2 workloads; raw DFG
    inputs carry ``{"dfg_name", "iterations", "dfg_sha256"}`` so two
    different graphs under one name cannot collide).  ``arch`` and
    ``mapper`` are the **registered canonical** names — aliases resolve
    to the same key.

    Two extra components keep a *persistent* store honest:

    * ``toolchain`` — :data:`~repro_torch.compiler.artifact.REPRO_VERSION`;
      bumping it (the discipline for any mapper-behavior change) silently
      namespaces all future keys, so a long-lived store never serves a
      mapping produced by an older algorithm as if it were current.
    * ``quick`` — whether ``REPRO_QUICK`` budget clamping was active at
      compile time; a quick-budget mapping must never be served to a
      full-budget consumer (its II can be worse than golden).
    """

    workload: tuple  # sorted (k, v) pairs; hashable
    arch: str
    mapper: str
    seed: int
    budget: Optional[int] = None
    toolchain: str = REPRO_VERSION
    quick: bool = False

    @classmethod
    def make(cls, workload: Dict[str, object], arch: str, mapper: str,
             seed: int, budget: Optional[int] = None,
             toolchain: Optional[str] = None,
             quick: Optional[bool] = None) -> "CompileKey":
        if quick is None:
            quick = bool(os.environ.get("REPRO_QUICK"))
        return cls(
            workload=tuple(sorted(workload.items())),
            arch=arch, mapper=mapper, seed=int(seed),
            budget=None if budget is None else int(budget),
            toolchain=REPRO_VERSION if toolchain is None else toolchain,
            quick=bool(quick),
        )

    def to_json(self) -> Dict[str, object]:
        return {
            "workload": dict(self.workload),
            "arch": self.arch,
            "mapper": self.mapper,
            "seed": self.seed,
            "budget": self.budget,
            "toolchain": self.toolchain,
            "quick": self.quick,
        }

    @classmethod
    def from_json(cls, data: Dict[str, object]) -> "CompileKey":
        return cls.make(data["workload"], data["arch"], data["mapper"],
                        data["seed"], data.get("budget"),
                        toolchain=data.get("toolchain", REPRO_VERSION),
                        quick=data.get("quick", False))

    @property
    def digest(self) -> str:
        """Content address: SHA-256 of the canonical key JSON."""
        return sha256_of_json(self.to_json())

    def describe(self) -> str:
        w = dict(self.workload)
        wname = (f"{w['name']}_u{w['unroll']}" if "name" in w
                 else str(w.get("dfg_name", "dfg")))
        tag = f"{wname} {self.mapper}@{self.arch} seed={self.seed}"
        if self.budget is not None:
            tag += f" budget={self.budget}"
        if self.quick:
            tag += " [quick]"
        return tag


def key_for(result: CompileResult) -> CompileKey:
    """Derive the store key of an existing artifact (``store put`` path).

    Everything comes from the artifact itself, never the current process:
    workload info (raw-DFG artifacts record a ``dfg_sha256`` of the
    *input* graph at compile time), and the staleness guards from
    provenance — ``repro_version`` as the toolchain namespace and the
    recorded ``quick`` regime.  Putting an old or quick-clamped artifact
    from a new/full-budget shell therefore cannot file it under a
    namespace its mapping does not belong to.  Artifacts predating these
    fields degrade to name-only workloads / full-budget keys.
    """
    prov = result.provenance or {}
    return CompileKey.make(dict(result.workload), result.arch,
                           result.mapper, result.seed, result.budget,
                           toolchain=prov.get("repro_version",
                                              REPRO_VERSION),
                           quick=bool(prov.get("quick", False)))


@dataclass
class StoreCounters:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    rejected: int = 0          # digest mismatch / mangled entry
    verify_runs: int = 0
    verify_failures: int = 0

    def to_json(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class ArtifactStore:
    """See module docstring.  ``root`` is created lazily on first write;
    ``device`` is where a verifying ``get`` runs the cycle loop (default
    ``cuda``, :func:`~repro_torch.device.resolve_device`)."""

    root: str
    verify: str = "never"
    max_bytes: Optional[int] = None
    counters: StoreCounters = field(default_factory=StoreCounters)
    device: object = None

    def __post_init__(self):
        if self.verify not in VERIFY_POLICIES:
            raise ValueError(
                f"verify policy {self.verify!r} not in {VERIFY_POLICIES}")
        self._journal = StoreJournal(self.index_path, self.journal_path)

    # -- paths -------------------------------------------------------------
    @property
    def entries_dir(self) -> str:
        return os.path.join(self.root, "entries")

    @property
    def index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    @property
    def journal_path(self) -> str:
        return os.path.join(self.root, "journal.jsonl")

    def entry_path(self, digest: str) -> str:
        return os.path.join(self.entries_dir, digest + ".json")

    # -- index -------------------------------------------------------------
    def _listed_digests(self) -> List[str]:
        try:
            names = os.listdir(self.entries_dir)
        except FileNotFoundError:
            return []
        # skip hidden names: in-flight ".tmp-*" atomic-write files must not
        # be scanned (or quarantined!) as entries
        return sorted(n[:-5] for n in names
                      if n.endswith(".json") and not n.startswith("."))

    def _read_index(self) -> Optional[Dict[str, Dict]]:
        """Replayed index rows (snapshot + journal), or ``None`` when the
        persisted state is unusable or trails the entry listing — the
        callers rebuild/reconcile.  A torn journal tail is healed
        (truncated) as a side effect, under the index lock."""
        with locked(self.index_path):
            state = self._journal.load()
        if state is None:
            return None
        if sorted(state.entries) != self._listed_digests():
            return None  # stale: writer died between entry and journal append
        if self._stale_rows(state.entries):
            return None  # an entry file changed under its row
        return state.entries

    def _stale_rows(self, entries: Dict[str, Dict]) -> List[str]:
        """Digests whose entry file's size/mtime disagree with the replayed
        row — an in-place same-key replacement that never reached the
        journal.  The row (and in particular its ``verified`` verdict,
        which belongs to one exact payload) must be rebuilt from the
        file."""
        out = []
        for digest, row in entries.items():
            try:
                st = os.stat(self.entry_path(digest))
            except FileNotFoundError:
                out.append(digest)  # ghost row; reconcile drops it
                continue
            if (row.get("size") != st.st_size
                    or row.get("mtime") != st.st_mtime):
                out.append(digest)
        return out

    def index(self) -> Dict[str, Dict]:
        """Current index rows, self-healing: replays snapshot + journal,
        reconciles drift against the entry listing (ghost rows dropped,
        orphan files adopted), rebuilds from ``entries/`` when the
        persisted state is unusable, and compacts an oversized or
        stale-epoch journal."""
        with locked(self.index_path):
            return self._load_or_heal_locked().entries

    def _load_or_heal_locked(self) -> LoadedState:
        """Load + self-heal the index; the caller holds the index lock.
        Always returns a state consistent with the entry listing."""
        state = self._journal.load()
        if state is None:
            entries = self._scan_entries()
            self._journal.replace(entries)
            return LoadedState(
                entries=entries,
                next_seq=max((int(r.get("seq", 0)) for r in entries.values()),
                             default=0))
        listed = self._listed_digests()
        if sorted(state.entries) != listed:
            self._reconcile_state(state, listed)
            state.dirty = True
        for digest in self._stale_rows(state.entries):
            # re-read a changed-in-place entry; _index_row resets the
            # `verified` verdict when the content digest moved
            path = self.entry_path(digest)
            old = state.entries.pop(digest)
            state.dirty = True
            try:
                entry = self._load_entry_file(path, digest)
            except FileNotFoundError:
                continue
            except StoreIntegrityError:
                self.counters.rejected += 1
                quarantine(path)
                continue
            row = self._index_row(entry, path, prev=old)
            state.entries[digest] = row
        if state.dirty or self._journal.wants_compaction():
            self._journal.replace(state.entries, state.next_seq)
        return state

    def _reconcile_state(self, state: LoadedState,
                         listed: List[str]) -> None:
        """Make replayed rows agree with the ``entries/`` listing: drop
        ghost rows whose file vanished; adopt orphan files (a put whose
        journal record was lost to a crash) after a full integrity
        check."""
        listed_set = set(listed)
        for digest in [d for d in state.entries if d not in listed_set]:
            del state.entries[digest]
        for digest in listed:
            if digest in state.entries:
                continue
            path = self.entry_path(digest)
            try:
                entry = self._load_entry_file(path, digest)
            except FileNotFoundError:
                continue  # raced away between listdir and open
            except StoreIntegrityError:
                self.counters.rejected += 1
                quarantine(path)
                continue
            row = self._index_row(entry, path)
            state.next_seq += 1
            row["seq"] = state.next_seq
            state.entries[digest] = row

    def _scan_entries(self) -> Dict[str, Dict]:
        """Build index rows by scanning + integrity-checking every entry
        file (quarantining unreadable/tampered ones).  Caller holds the
        index lock.  Hits / verified / LRU bookkeeping survives via
        whatever snapshot+journal rows are still readable — including
        legacy whole-file ``store-index@1`` rows, which is how a legacy
        store migrates in place."""
        prev_rows = self._journal.best_effort_rows()
        entries: Dict[str, Dict] = {}
        for digest in self._listed_digests():
            path = self.entry_path(digest)
            try:
                entry = self._load_entry_file(path, digest)
            except StoreIntegrityError:
                self.counters.rejected += 1
                quarantine(path)
                continue
            entries[digest] = self._index_row(entry, path,
                                              prev=prev_rows.get(digest))
        return entries

    def rebuild_index(self) -> Dict[str, Dict]:
        """Re-scan ``entries/`` and rewrite the snapshot from scratch
        (resetting the journal).  Unreadable entry files are quarantined,
        not trusted; LRU/verified bookkeeping survives via whatever old
        rows still match."""
        with locked(self.index_path):
            entries = self._scan_entries()
            self._journal.replace(entries)
        return entries

    def compact(self) -> None:
        """Fold the journal into the snapshot now.  Happens automatically
        once the journal outgrows its threshold; a graceful shutdown may
        call it so a restart replays nothing."""
        with locked(self.index_path):
            self._compact_locked()

    def _compact_locked(self, label: str = "") -> None:
        state = self._journal.load()
        if state is not None:
            self._journal.replace(state.entries, state.next_seq, label=label)

    def _index_row(self, entry: Dict, path: str,
                   prev: Optional[Dict] = None) -> Dict:
        art = entry["artifact"]
        # a verified verdict belongs to one exact payload: inherit it only
        # while the content digest is unchanged
        same_content = bool(prev and prev.get("digest") == entry["digest"])
        st = os.stat(path)
        row = {
            "key": entry["key"],
            "digest": entry["digest"],
            "size": st.st_size,
            "mtime": st.st_mtime,
            "ii": art.get("ii"),
            "cycles": art.get("cycles"),
            "verified": bool(same_content and prev.get("verified")),
            "hits": int(prev.get("hits", 0)) if prev else 0,
            "created": (prev or {}).get("created", time.time()),
            "last_used": (prev or {}).get("last_used", time.time()),
            # monotonic access stamp (LRU order); 0 = never stamped — rows
            # rebuilt from pre-seq indexes fall back to last_used ordering
            "seq": int((prev or {}).get("seq", 0)),
        }
        return row

    def _journal_del(self, digest: str, label: str = "") -> None:
        """Locked O(1) append of a deletion record (quarantine/discard)."""
        with locked(self.index_path):
            self._journal.append([del_record(digest)], label=label)

    # -- entries -----------------------------------------------------------
    def _load_entry_file(self, path: str, digest: str) -> Dict:
        """Parse + integrity-check one entry file; raises
        :class:`StoreIntegrityError` on any mismatch."""
        try:
            with open(path) as f:
                entry = json.load(f)
        except ValueError as e:
            # only a parse failure is evidence of corruption; OSErrors
            # other than FileNotFoundError (EACCES, EIO) propagate so a
            # transient blip cannot get a valid entry quarantined
            raise StoreIntegrityError(f"{path}: unreadable entry ({e})")
        if not isinstance(entry, dict) or entry.get("schema") != ENTRY_SCHEMA:
            raise StoreIntegrityError(
                f"{path}: not a {ENTRY_SCHEMA} store entry")
        for fld in ("key", "digest", "artifact"):
            if fld not in entry:
                raise StoreIntegrityError(f"{path}: missing {fld!r}")
        want = entry["digest"]
        got = sha256_of_json(entry["artifact"])
        if got != want:
            raise StoreIntegrityError(
                f"{path}: artifact digest mismatch "
                f"(stored {want[:12]}…, computed {got[:12]}…)")
        key_digest = CompileKey.from_json(entry["key"]).digest
        if key_digest != digest:
            raise StoreIntegrityError(
                f"{path}: entry misfiled (key digest {key_digest[:12]}… "
                f"!= filename {digest[:12]}…)")
        return entry

    # -- public API --------------------------------------------------------
    def put(self, result: CompileResult,
            key: Optional[CompileKey] = None) -> str:
        """Insert an artifact; returns its key digest.  Atomic entry
        write, then an O(1) locked journal append; LRU eviction follows if
        the store exceeds ``max_bytes`` (the just-inserted entry is never
        evicted)."""
        key = key or key_for(result)
        digest = key.digest
        # digest the payload AS IT READS BACK from disk (JSON stringifies
        # int dict keys), otherwise every stored digest would mismatch on
        # the first load
        art_json = json.loads(json.dumps(result.to_json()))
        entry = {
            "schema": ENTRY_SCHEMA,
            "key": key.to_json(),
            "digest": sha256_of_json(art_json),
            "artifact": art_json,
        }
        path = self.entry_path(digest)
        try:
            faultinject.check("store.put", key.describe())
            atomic_write_json(path, entry)
        except OSError as e:
            # I/O-level write failure (disk full, EIO, permissions) — typed
            # so callers can distinguish it from content-level corruption
            raise StoreIOError(
                f"store write failed for {key.describe()}: {e}") from e
        # chaos hook: a "corrupt" fault tears the just-committed entry on
        # disk; the integrity digest must catch it on the next get()
        faultinject.maybe_corrupt(path, "store.put", key.describe())

        try:
            row = self._index_row(entry, path)
        except FileNotFoundError:
            # the just-committed file vanished before its journal record
            # was appended: a concurrent reconcile/rebuild quarantined a
            # torn write, or a gc raced us.  Don't journal a ghost row —
            # the put degrades to a no-op and the next get() is a miss.
            row = None
        if row is not None:
            if result.verified is True:
                # the producer already proved this mapping against the
                # oracle; 'first' consumers need not re-run the simulator
                row["verified"] = True
            # hits/created/verified bookkeeping of a same-key re-put merges
            # at replay time (journal._apply), so the append never needs to
            # read the current index — that is what keeps it O(1)
            with locked(self.index_path):
                self._journal.append([put_record(digest, row)],
                                     label=key.describe())
                if self.max_bytes is not None:
                    state = self._load_or_heal_locked()
                    before = set(state.entries)
                    self._evict_over_cap(state.entries, protect=digest)
                    victims = sorted(before - set(state.entries))
                    if victims:
                        self._journal.append(
                            [del_record(d) for d in victims],
                            label=key.describe())
                elif self._journal.wants_compaction():
                    self._compact_locked(label=key.describe())
        self.counters.puts += 1
        return digest

    def get(self, key: CompileKey) -> Optional[CompileResult]:
        """Cache lookup.  Returns the stored artifact (integrity-checked,
        re-verified per policy on ``device``) or ``None``; corrupt /
        unverifiable entries are quarantined and reported as misses.  A
        device fault during verification propagates (see module
        docstring)."""
        digest = key.digest
        path = self.entry_path(digest)
        try:
            faultinject.check("store.get", key.describe())
            entry = self._load_entry_file(path, digest)
        except FileNotFoundError:
            self.counters.misses += 1
            return None
        except StoreIntegrityError:
            self.counters.rejected += 1
            self.counters.misses += 1
            quarantine(path)
            self._journal_del(digest, key.describe())
            return None
        except OSError as e:
            # transient I/O failure (EIO, EACCES): typed, never quarantines
            # — the entry may be perfectly intact
            raise StoreIOError(
                f"store read failed for {key.describe()}: {e}") from e

        result = CompileResult.from_json(entry["artifact"])
        verified_now = False
        if result.mappings and self.verify != "never" and (
            self.verify == "always" or not self.is_verified(key)
        ):
            from repro_torch.sim.batch import select_backend

            # a device that is absent or misnamed is the caller's error,
            # never a verdict on the entry: resolved outside the catch
            backend = select_backend(None, self.device)
            self.counters.verify_runs += 1
            try:
                result.simulate(iterations=3, device=self.device,
                                backend=backend)
                verified_now = True
            except VERIFY_FAILURES:
                self.counters.verify_failures += 1
                self.counters.misses += 1
                quarantine(path, reason="unverified")
                self._journal_del(digest, key.describe())
                return None

        # the touch record carries a fallback row so an *orphan* entry
        # (its put record lost to a crash between the entry write and the
        # journal append) self-heals into the index on its first hit
        try:
            fallback = self._index_row(entry, path)
        except FileNotFoundError:
            fallback = None
        with locked(self.index_path):
            self._journal.append(
                [touch_record(digest, time.time(), verified_now, fallback)],
                label=key.describe())
            if self._journal.wants_compaction():
                self._compact_locked(label=key.describe())
        self.counters.hits += 1
        return result

    def is_verified(self, key: CompileKey) -> bool:
        """Whether the index records a positive verification verdict for
        this entry (set by verify policies, ``mark_verified``, or a
        ``put`` of an already-verified artifact)."""
        return bool(self.index().get(key.digest, {}).get("verified"))

    def mark_verified(self, key: CompileKey) -> None:
        """Persist an externally-obtained verification verdict so
        ``verify="first"`` consumers skip the simulator for this entry."""
        with locked(self.index_path):
            self._journal.append([verify_record(key.digest)],
                                 label=key.describe())

    def discard(self, key: CompileKey, reason: str = "unverified") -> None:
        """Quarantine an entry and drop it from the index — used when a
        consumer proves a served mapping wrong; the next lookup misses."""
        digest = key.digest
        quarantine(self.entry_path(digest), reason=reason)
        self._journal_del(digest, key.describe())

    def iter_artifacts(self):
        """Yield ``(CompileKey, CompileResult)`` for every intact entry,
        in deterministic (digest-sorted) order — a *read-only* scan for
        batch re-verification (``python -m repro_torch verify --dir``):
        hit counters and LRU order are untouched.
        Corrupt entries are counted in ``counters.rejected`` and skipped,
        not quarantined (that stays a ``get``/``gc`` decision)."""
        for digest in self._listed_digests():
            path = self.entry_path(digest)
            try:
                entry = self._load_entry_file(path, digest)
            except FileNotFoundError:
                continue  # raced a gc/quarantine
            except StoreIntegrityError:
                self.counters.rejected += 1
                continue
            yield (CompileKey.from_json(entry["key"]),
                   CompileResult.from_json(entry["artifact"]))

    def ls(self) -> List[Dict]:
        """Index rows sorted most-recently-used first (by the monotonic
        ``seq`` stamp; pre-seq rows order by wall-clock ``last_used``)."""
        rows = []
        for digest, row in self.index().items():
            rows.append(dict(row, key_digest=digest))
        rows.sort(key=lambda r: (-int(r.get("seq", 0)),
                                 -r.get("last_used", 0.0)))
        return rows

    def total_bytes(self) -> int:
        return sum(int(r.get("size", 0)) for r in self.index().values())

    def _evict_over_cap(self, entries: Dict[str, Dict],
                        protect: Optional[str] = None,
                        max_bytes: Optional[int] = None):
        cap = self.max_bytes if max_bytes is None else max_bytes
        if cap is None:
            return
        total = sum(int(r.get("size", 0)) for r in entries.values())
        # least-recently-used first by the monotonic seq stamp; rows that
        # predate seq (0) evict before any stamped row, oldest wall-clock
        # first among themselves
        victims = sorted(
            (d for d in entries if d != protect),
            key=lambda d: (int(entries[d].get("seq", 0)),
                           entries[d].get("last_used", 0.0)),
        )
        for digest in victims:
            if total <= cap:
                break
            total -= int(entries[digest].get("size", 0))
            del entries[digest]
            try:
                os.unlink(self.entry_path(digest))
            except FileNotFoundError:
                pass
            self.counters.evictions += 1

    def gc(self, max_bytes: Optional[int] = None) -> int:
        """Evict LRU entries until the store fits ``max_bytes`` (argument
        overrides the store's configured cap), after an unconditional
        integrity rescan of every entry file — in-place-tampered entries
        (whose filenames still match the index, so no staleness rebuild
        would trigger) are quarantined here rather than lingering until
        their next ``get``.  Returns the number of entries evicted."""
        self.rebuild_index()  # full digest scan; quarantines corrupt entries
        before = self.counters.evictions
        with locked(self.index_path):
            state = self._load_or_heal_locked()
            self._evict_over_cap(state.entries, max_bytes=max_bytes)
            self._journal.replace(state.entries, state.next_seq)
        return self.counters.evictions - before


def open_store(store, verify: Optional[str] = None,
               max_bytes: Optional[int] = None,
               device=None) -> "ArtifactStore":
    """Coerce a path or an :class:`ArtifactStore` into a store instance."""
    if isinstance(store, ArtifactStore):
        return store
    return ArtifactStore(str(store), verify=verify or "never",
                         max_bytes=max_bytes, device=device)
