"""Shared fast routing engine for all Track-A mappers.

Port of ``repro/core/routing.py``, line for line,
over the port's own modules.

The per-edge router in :mod:`repro_torch.mapping.passes.route` performs an elapsed-time
DP/Dijkstra over the time-extended MRRG.  Profiling shows the mappers spend
essentially all of their time in that inner loop, and that the overwhelming
majority of explored states can never reach the destination in the cycles
remaining.  This module precomputes, once per :class:`~repro_torch.core.arch.Arch`,
the static structures that let the router prune those states up front:

* ``succ``       — successor lists over routing resources, with the holdable
  self-loop appended **last** so the pruned DP relaxes states in exactly the
  same order as the original full-layer DP (bit-identical results);
* ``dist``       — all-pairs minimum hop distance between routing resources
  (numpy ``int32``; ``UNREACH`` for disconnected pairs).  ``dist[u, v]`` is an
  admissible lower bound on the elapsed cycles needed to move a value from
  ``u`` to ``v``, so any state whose remaining-cycle budget is smaller can be
  discarded without changing the optimum (A*-style unreachable pruning);
* per-FU caches — ``starts(fu)`` (the resources a value lands on one cycle
  after production, see :func:`repro_torch.mapping.mrrg.start_resources`) and
  ``h_to_reads(fu)`` (minimum hops from every resource to any resource the
  FU's operand mux can read: the A* heuristic / pruning table);
* FU×FU span matrices — ``min_span_mat`` (the cheap Manhattan heuristic) and
  ``route_span_mat`` (the exact minimum route latency from the distance
  tables), used by the mappers' vectorized candidate filters;
* :class:`RouteCache` — cross-move route memoization for the per-edge router,
  keyed on the MRRG's occupancy state (see the class docstring).

Engines are cached on the architecture object itself (``engine_for``), so the
distance tables are computed once per process per fabric and shared by every
MRRG / mapper instance, including the spatial mapper's II=1 runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

UNREACH = 1 << 20  # larger than any feasible span; small enough to add safely

_M64 = (1 << 64) - 1


def mix64(k: int, net: int, t: int) -> int:
    """Deterministic 64-bit mixer for the MRRG occupancy hash.

    Maps one (slot, net, abs-cycle) reservation to a pseudo-random 64-bit
    word; the MRRG folds these into ``state_hash`` with XOR, so reserving and
    then releasing the same value restores the hash exactly (the property the
    exact tier of :class:`RouteCache` relies on).  Constants are the
    splitmix64 increments; the function is pure and process-independent.
    """
    h = (k * 0x9E3779B97F4A7C15) ^ (net * 0xC2B2AE3D27D4EB4F) \
        ^ (t * 0x165667B19E3779F9)
    h &= _M64
    h ^= h >> 29
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    h ^= h >> 32
    return h


#: sentinel distinguishing "no cached entry" from a cached ``None`` (the
#: router legitimately returns None for unroutable queries, and caching those
#: failures is as valuable as caching successes)
ROUTE_MISS = object()


class RouteCache:
    """Cross-move route memoization for :func:`repro_torch.mapping.passes.route.route_edge`.

    Two tiers, both deterministic:

    * **exact** — entries are keyed on the full query ``(ii, net, src_fu,
      dst_fu, t_src, t_dst, allow_overuse)`` *plus* the MRRG's global
      occupancy hash (``state_hash``, an XOR-fold of every live reservation)
      and history version.  A hit is only possible when the whole MRRG is in
      a previously-seen state, so the cached result is what the search would
      have returned — results are bit-identical to an uncached run.  This is
      the tier that pays off: candidate-evaluation loops place, route and
      roll back, returning the MRRG to earlier states over and over (the
      chosen candidate is always re-routed at least once), and multi-start
      restarts replay long identical prefixes from the empty fabric.
    * **scoped** (opt-in) — entries keyed on the query alone, validated by
      per-slot epochs: a reserve/release (or history bump) touching any slot
      of the cached path invalidates it.  A scoped hit returns a path whose
      slots are untouched — still feasible, identical cost — but possibly no
      longer globally optimal, so it can steer the search differently.  Only
      mappers with their own golden records enable it
      (``negotiation="selective"``).

    Cached failures (``None``) live in the exact tier only: a failure proves
    nothing about path slots.
    """

    def __init__(self, scoped: bool = False, max_entries: int = 1 << 18):
        self.scoped = scoped
        self.max_entries = max_entries
        self._exact: Dict[tuple, object] = {}
        self._scoped: Dict[tuple, tuple] = {}
        self.hits_exact = 0
        self.hits_scoped = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, mrrg, key):
        """Cached route result for ``key``, or :data:`ROUTE_MISS`."""
        r = self._exact.get((key, mrrg.state_hash, mrrg.hist_ver), ROUTE_MISS)
        if r is not ROUTE_MISS:
            self.hits_exact += 1
            return r
        if self.scoped:
            ent = self._scoped.get(key)
            if ent is not None:
                path, cost, slots, stamp, gen = ent
                if gen != mrrg.gen:
                    # entry from an earlier MRRG (restart/new II): its epoch
                    # stamp is meaningless against this MRRG's counters
                    del self._scoped[key]
                else:
                    ep = mrrg.slot_epoch
                    for k in slots:
                        if ep[k] > stamp:
                            del self._scoped[key]  # a slot changed: stale
                            break
                    else:
                        self.hits_scoped += 1
                        return path, cost
        self.misses += 1
        return ROUTE_MISS

    def store(self, mrrg, key, result):
        if len(self._exact) >= self.max_entries:
            self._exact.clear()
            self.evictions += 1
        self._exact[(key, mrrg.state_hash, mrrg.hist_ver)] = result
        if self.scoped and result is not None:
            if len(self._scoped) >= self.max_entries:
                self._scoped.clear()
                self.evictions += 1
            path, cost = result
            ii = mrrg.ii
            slots = [rid * ii + t % ii for rid, t in path]
            self._scoped[key] = (path, cost, slots, mrrg.epoch, mrrg.gen)

    # -- reporting ---------------------------------------------------------
    @property
    def hits(self) -> int:
        return self.hits_exact + self.hits_scoped

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def counters(self) -> Dict[str, object]:
        lk = self.lookups
        return {
            "hits_exact": self.hits_exact,
            "hits_scoped": self.hits_scoped,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / lk, 4) if lk else 0.0,
        }


class RoutingEngine:
    """Precomputed per-``Arch`` routing structures (see module docstring)."""

    def __init__(self, arch):
        self.arch = arch
        n = len(arch.rnodes)
        self.n = n
        # Successor lists in the exact order the legacy router relaxed them:
        # architecture edges first, then the holdable self-loop.
        self.succ: List[Tuple[int, ...]] = [
            tuple(arch.redges[r.id]) + ((r.id,) if r.holdable else ())
            for r in arch.rnodes
        ]
        self.cap: List[int] = [r.cap for r in arch.rnodes]
        self.holdable: List[bool] = [r.holdable for r in arch.rnodes]
        self.cap_arr = np.asarray(self.cap, dtype=np.int32)
        # CSR forms of the routing graph for the vectorized array-DP core
        # (passes.route.FanoutSession).  succ_indptr/succ_indices is the
        # forward adjacency; pred_indptr/pred_indices is its transpose, the
        # form the per-layer gather -> reduce relaxation consumes.  Each
        # predecessor segment is ascending (built by scanning sources in
        # ascending order), so an argmin's first occurrence over a segment
        # reproduces the legacy relaxation's smallest-rid tie-break.
        counts = np.asarray([len(s) for s in self.succ], dtype=np.int64)
        self.succ_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=self.succ_indptr[1:])
        self.succ_indices = np.asarray(
            [v for s in self.succ for v in s], dtype=np.int64
        )
        preds: List[List[int]] = [[] for _ in range(n)]
        for u in range(n):
            for v in self.succ[u]:
                preds[v].append(u)
        pcounts = np.asarray([len(p) for p in preds], dtype=np.int64)
        self.pred_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(pcounts, out=self.pred_indptr[1:])
        self.pred_indices = np.asarray(
            [u for p in preds for u in p], dtype=np.int64
        )
        # gather index padded with sentinel row ``n`` (held at +inf by the
        # search) so ``minimum.reduceat`` stays in bounds when the trailing
        # segments are empty; empty segments are masked via ``pred_empty``
        self.pred_gather = np.concatenate(
            [self.pred_indices, np.asarray([n], dtype=np.int64)]
        )
        self.pred_empty = pcounts == 0
        self.dist = self._all_pairs_hops()
        self._starts: Dict[int, List[int]] = {}
        self._h: Dict[int, List[int]] = {}
        self._starts_arr: Dict[int, np.ndarray] = {}
        self._h_arr: Dict[int, np.ndarray] = {}
        self._reads: Dict[int, List[int]] = {}
        self._reads_arr: Dict[int, np.ndarray] = {}
        self._min_fu_span: Dict[Tuple[int, int], int] = {}
        self._min_span_mat: Optional[np.ndarray] = None
        self._route_span_mat: Optional[np.ndarray] = None
        self._fu_aux: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = None

    # -- static tables -------------------------------------------------------
    def _all_pairs_hops(self) -> np.ndarray:
        n = self.n
        dist = np.full((n, n), UNREACH, dtype=np.int32)
        for s in range(n):
            row = dist[s]
            row[s] = 0
            frontier = [s]
            d = 0
            while frontier:
                d += 1
                nxt = []
                for u in frontier:
                    for v in self.succ[u]:
                        if row[v] > d:
                            row[v] = d
                            nxt.append(v)
                frontier = nxt
        return dist

    def starts(self, fu) -> List[int]:
        """Cached :func:`repro_torch.mapping.mrrg.start_resources` for ``fu``."""
        out = self._starts.get(fu.id)
        if out is None:
            from repro_torch.mapping.mrrg import start_resources

            out = start_resources(self.arch, fu)
            self._starts[fu.id] = out
        return out

    def h_to_reads(self, fu) -> List[int]:
        """Minimum hops from every resource to any operand-mux input of
        ``fu`` — the admissible A* heuristic for routes ending at ``fu``."""
        h = self._h.get(fu.id)
        if h is None:
            if fu.reads:
                h = np.min(self.dist[:, list(fu.reads)], axis=1).tolist()
            else:
                h = [UNREACH] * self.n
            self._h[fu.id] = h
        return h

    def starts_arr(self, fu) -> np.ndarray:
        """:meth:`starts` as a cached int64 index array (array-DP core)."""
        out = self._starts_arr.get(fu.id)
        if out is None:
            out = np.asarray(self.starts(fu), dtype=np.int64)
            self._starts_arr[fu.id] = out
        return out

    def h_arr(self, fu) -> np.ndarray:
        """:meth:`h_to_reads` as a cached int64 vector (array-DP core)."""
        out = self._h_arr.get(fu.id)
        if out is None:
            out = np.asarray(self.h_to_reads(fu), dtype=np.int64)
            self._h_arr[fu.id] = out
        return out

    def reads(self, fu) -> List[int]:
        """Cached ``list(set(fu.reads))`` — the exact container the router's
        arrival scan historically iterated per call.  The set's iteration
        order is deterministic for a given content (CPython), and it is the
        arrival tie-break, so the cache must preserve it (NOT sort it)."""
        out = self._reads.get(fu.id)
        if out is None:
            out = list(set(fu.reads))
            self._reads[fu.id] = out
        return out

    def reads_arr(self, fu) -> np.ndarray:
        """:meth:`reads` as a cached int64 index array, same order."""
        out = self._reads_arr.get(fu.id)
        if out is None:
            out = np.asarray(self.reads(fu), dtype=np.int64)
            self._reads_arr[fu.id] = out
        return out

    def min_route_span(self, src_fu, dst_fu) -> int:
        """Exact minimum elapsed cycles for a value from ``src_fu`` to reach
        an operand input of ``dst_fu`` (1 cycle to the start resource plus
        the shortest hop path).  Used for unreachable pruning."""
        key = (src_fu.id, dst_fu.id)
        span = self._min_fu_span.get(key)
        if span is None:
            h = self.h_to_reads(dst_fu)
            best = min((h[r] for r in self.starts(src_fu)), default=UNREACH)
            span = 1 + best if best < UNREACH else UNREACH
            self._min_fu_span[key] = span
        return span

    # -- vectorized-filter tables (lazy; FU×FU, so tiny) ---------------------
    def min_span_mat(self) -> np.ndarray:
        """``min_span(arch, fus[i], fus[j])`` as an int32 matrix — the cheap
        Manhattan heuristic the mappers' ``_span_ok`` filter uses, exposed
        for numpy fancy-indexing over flat candidate arrays."""
        if self._min_span_mat is None:
            from repro_torch.mapping.mrrg import min_span

            fus = self.arch.fus
            n = len(fus)
            m = np.empty((n, n), dtype=np.int32)
            for i in range(n):
                for j in range(n):
                    m[i, j] = min_span(self.arch, fus[i], fus[j])
            self._min_span_mat = m
        return self._min_span_mat

    def route_span_mat(self) -> np.ndarray:
        """:meth:`min_route_span` as an int32 matrix (``UNREACH`` where no
        route exists) for the vectorized exact-reachability filter."""
        if self._route_span_mat is None:
            fus = self.arch.fus
            n = len(fus)
            m = np.empty((n, n), dtype=np.int32)
            for i in range(n):
                for j in range(n):
                    m[i, j] = self.min_route_span(fus[i], fus[j])
            self._route_span_mat = m
        return self._route_span_mat

    def fu_aux(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Per-FU tile coordinate / tile-index arrays ``(fx, fy, tile_idx,
        n_tiles)`` backing the vectorized busy/locality candidate scoring."""
        if self._fu_aux is None:
            fus = self.arch.fus
            fx = np.asarray([fu.tile[0] for fu in fus], dtype=np.int64)
            fy = np.asarray([fu.tile[1] for fu in fus], dtype=np.int64)
            tiles = sorted({fu.tile for fu in fus})
            t_idx = {t: i for i, t in enumerate(tiles)}
            tile_idx = np.asarray([t_idx[fu.tile] for fu in fus], dtype=np.int64)
            self._tile_index = t_idx
            self._fu_aux = (fx, fy, tile_idx, len(tiles))
        return self._fu_aux

    def tile_index(self) -> Dict[Tuple[int, int], int]:
        self.fu_aux()
        return self._tile_index


def engine_for(arch) -> RoutingEngine:
    """Return the (cached) routing engine for ``arch``.

    The engine is attached to the architecture object so every mapper /
    MRRG built on the same fabric shares one set of distance tables.
    """
    eng = getattr(arch, "_routing_engine", None)
    if eng is None:
        eng = RoutingEngine(arch)
        arch._routing_engine = eng
    return eng
