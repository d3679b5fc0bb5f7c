"""Routing pass layer: the vectorized per-edge router + incremental
reroute primitives.

Port of ``repro/mapping/passes/route.py``, line for line,
over the port's own modules.

Two search cores produce **bit-identical** paths, costs and tie-breaks:

* the **array-DP core** (:class:`FanoutSession`) — the default.  Each
  elapsed-time layer is one numpy relaxation over the routing graph's CSR
  predecessor arrays: gather the previous layer's costs per predecessor,
  ``minimum.reduceat`` per segment (the scatter-min), add the layer's
  entry-cost vector, mask A*-unreachable / avoided slots.  Entry-cost
  vectors are computed straight from the MRRG's flat occupancy /
  base-cost arrays plus the ``net_slots`` same-net reuse index, and are
  cached per absolute cycle on the session, shared across the consumers
  of one producer (fan-out) and across modulo-conflict retries.  No back
  pointers are stored: the winning predecessor of a layer state is
  recomputed at reconstruction time as the argmin over its (ascending)
  predecessor segment — entry costs are predecessor-independent, so the
  min-cost / smallest-rid argmin is exactly the predecessor the legacy
  relaxation order retained.
* the **legacy scalar DP** (:func:`_route_edge_once`) — retained verbatim
  as the equivalence oracle (``route_engine="legacy"``) and used by the
  default ``"auto"`` engine for short spans where numpy overhead loses
  (the dispatch is a pure perf choice: both cores return the same bits).

:func:`route_edge` routes one value; :func:`route_fanout` routes all
consumers of one producer through a shared session.  :class:`Router`
binds the primitives to a pass context and batches
``route_edge_list``/``route_node_edges`` into fan-out sessions
automatically (consecutive same-producer runs; rip/route/reserve
interleaving is exactly the sequential order, so trajectories are
unchanged).  The opt-in ``route_window=K`` knob prunes every layer to its
K cheapest slots (deterministic beam; trajectory-CHANGING, so it is
golden-gated separately and off by default).

All latencies are 1 cycle; a value produced at t is readable at t+1 from
the producer's output register / local router (Plaid collects ALU outputs
into the collective router directly) / own output ports (ST writes
straight to port registers) — see :func:`repro_torch.mapping.mrrg.start_resources`.
"""
from __future__ import annotations

from collections import Counter
from time import perf_counter
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.arch import FU
from repro_torch.core.dfg import DFG
from repro_torch.core.routing import ROUTE_MISS, UNREACH, RouteCache
from repro_torch.mapping.mapping import Mapping
from repro_torch.mapping.mrrg import MRRG

_INF = float("inf")

#: ``"auto"`` engine dispatch: the array core runs when the search is big
#: enough to amortize numpy's fixed per-layer overhead — span at least
#: ``_VEC_MIN_SPAN`` on a fabric of at least ``_VEC_MIN_NODES`` routing
#: resources (measured crossover: ~7 layers on the 96/99-node fabrics,
#: where long searches win 2-3.6x; on the 44-node plaid2x2 the scalar
#: DP's sparse frontier wins at every observed span).  Both cores are
#: bit-identical, so this is a pure wall-time knob.
_VEC_MIN_SPAN = 7
_VEC_MIN_NODES = 64


class FanoutSession:
    """Shared search context for every route leaving one producer: the
    ``(net, src_fu, t_src, allow_overuse, engine, window)`` tuple is fixed
    and the per-absolute-cycle entry-cost vectors are cached across the
    producer's consumers and across modulo-conflict retries.

    An entry-cost vector holds, per resource, the cost of standing on it
    at cycle ``t`` for this net — ``0.05`` same-net reuse, ``inf``
    blocked, ``base (+ 8.0 * overuse)`` otherwise — i.e. the legacy DP's
    per-layer ``cmemo`` minus the per-target A*/avoid masks (those are
    applied at relaxation time, keeping the vectors target-independent).
    Callers that mutate the MRRG mid-batch announce the touched path via
    :meth:`note_change` (cached entries are surgically recomputed from
    MRRG state, so rips of *other* nets are handled exactly); any
    unannounced mutation is caught by the ``epoch`` safety net, which
    drops the cache wholesale rather than serve stale costs.
    """

    __slots__ = ("mrrg", "eng", "net", "src_fu", "t_src", "allow",
                 "engine", "window", "ii", "n", "layers", "_epoch")

    def __init__(self, mrrg: MRRG, net: int, src_fu: FU, t_src: int, *,
                 allow_overuse: bool = False, engine: str = "auto",
                 window: Optional[int] = None):
        self.mrrg = mrrg
        self.eng = mrrg.engine
        self.net = net
        self.src_fu = src_fu
        self.t_src = t_src
        self.allow = allow_overuse
        self.engine = engine
        self.window = window
        self.ii = mrrg.ii
        self.n = mrrg.engine.n
        self.layers: Dict[int, np.ndarray] = {}  # abs t -> entry-cost vec
        self._epoch = mrrg.epoch

    # -- entry-cost layers ---------------------------------------------------
    def _entry_cost(self, rid: int, t: int) -> float:
        """Scalar recompute of one cached entry from live MRRG state (the
        surgical refresh path; must stay bit-equal to :meth:`entry_layer`
        and to the legacy DP's inlined slot-cost branches)."""
        mrrg = self.mrrg
        k = rid * self.ii + t % self.ii
        vals = mrrg.slot_vals[k]
        if vals is not None and (self.net, t) in vals:
            return 0.05
        over = (len(vals) if vals is not None else 0) + 1 - self.eng.cap[rid]
        if over > 0:
            return mrrg._base[k] + 8.0 * over if self.allow else _INF
        return mrrg._base[k]

    def entry_layer(self, t: int) -> np.ndarray:
        """Entry-cost vector for absolute cycle ``t`` (cached)."""
        mrrg = self.mrrg
        if self._epoch != mrrg.epoch:
            # unannounced MRRG mutation: drop every cached layer
            self.layers.clear()
            self._epoch = mrrg.epoch
        vec = self.layers.get(t)
        if vec is not None:
            mrrg.stats.layers_reused += 1
            return vec
        ii = self.ii
        cyc = t % ii
        base = mrrg.base_arr[cyc::ii]
        over = mrrg.occ_arr[cyc::ii] + 1 - self.eng.cap_arr
        if self.allow:
            vec = np.where(over > 0, base + 8.0 * over, base)
        else:
            vec = np.where(over > 0, _INF, base)
        reuse = mrrg.net_slots.get((self.net, t))
        if reuse:
            vec[list(reuse)] = 0.05
        self.layers[t] = vec
        mrrg.stats.layers_built += 1
        return vec

    def note_change(self, path) -> None:
        """Refresh cached entries after one reserve/release of ``path``
        (any net).  More than one unannounced mutation — or a history
        bump — invalidates everything via the epoch check."""
        mrrg = self.mrrg
        if mrrg.epoch == self._epoch:
            return
        if not self.layers:
            self._epoch = mrrg.epoch
            return
        if mrrg.epoch != self._epoch + 1:
            self.layers.clear()
            self._epoch = mrrg.epoch
            return
        ii = self.ii
        by_cyc: Dict[int, Set[int]] = {}
        for rid, t in path:
            by_cyc.setdefault(t % ii, set()).add(rid)
        for t2, vec in self.layers.items():
            rids = by_cyc.get(t2 % ii)
            if rids:
                for rid in rids:
                    vec[rid] = self._entry_cost(rid, t2)
        self._epoch = mrrg.epoch

    # -- search --------------------------------------------------------------
    def search(
        self, dst_fu: FU, t_dst: int
    ) -> Optional[Tuple[List[Tuple[int, int]], float]]:
        """Route to one consumer, with the modulo-conflict repair loop:
        when the min-cost path would occupy one (resource, cycle-mod-II)
        slot twice (value lifetime > II through a single register), the
        conflicting slots are masked and the search retried — modulo
        variable expansion across register chains."""
        span = t_dst - self.t_src
        if span < 1:
            return None
        if self.eng.min_route_span(self.src_fu, dst_fu) > span:
            return None  # unreachable at this span, regardless of occupancy
        use_vec = self.engine != "legacy" and (
            self.window is not None or self.engine == "vector"
            or (span >= _VEC_MIN_SPAN and self.n >= _VEC_MIN_NODES)
        )
        avoid: Set[Tuple[int, int]] = set()
        for _ in range(4):
            if use_vec:
                r = self._search_vec(dst_fu, t_dst, avoid)
            else:
                r = _route_edge_once(
                    self.mrrg, self.net, self.src_fu, dst_fu,
                    self.t_src, t_dst,
                    allow_overuse=self.allow, avoid=avoid,
                )
            if r is None:
                return None
            path, cost, conflicts = r
            if not conflicts:
                return path, cost
            avoid |= conflicts
        return None

    def _search_vec(self, dst_fu: FU, t_dst: int, avoid: Set[Tuple[int, int]]):
        """One array-DP search (see module docstring for the layout and
        the bit-identity argument)."""
        eng = self.eng
        n = self.n
        ii = self.ii
        t_src = self.t_src
        span = t_dst - t_src
        h = eng.h_arr(dst_fu)
        window = self.window
        # cost[k][rid] = min cost standing on rid at t_src + k; column n is
        # the +inf sentinel the padded predecessor gather reads for rids
        # with empty predecessor segments
        cost = np.empty((span + 1, n + 1))
        cost[:, n] = _INF
        ents: List[Optional[np.ndarray]] = [None] * (span + 1)
        t1 = t_src + 1
        ent = ents[1] = self.entry_layer(t1)
        row = np.full(n, _INF)
        starts = eng.starts_arr(self.src_fu)
        row[starts] = ent[starts]
        rem = span - 1
        row[h > rem] = _INF
        if avoid:
            cyc = t1 % ii
            for (r, cy) in avoid:
                if cy == cyc:
                    row[r] = _INF
        if window is not None:
            _clip_window(row, window)
        if not (row < _INF).any():
            return None
        cost[1, :n] = row
        gp = eng.pred_indptr
        gather = eng.pred_gather
        empty = eng.pred_empty
        for step in range(2, span + 1):
            t = t_src + step
            rem = span - step
            prev = cost[step - 1]
            best = np.minimum.reduceat(prev[gather], gp[:-1])
            best[empty] = _INF
            ent = ents[step] = self.entry_layer(t)
            best += ent
            best[h > rem] = _INF
            if avoid:
                cyc = t % ii
                for (r, cy) in avoid:
                    if cy == cyc:
                        best[r] = _INF
            if window is not None:
                _clip_window(best, window)
            if not (best < _INF).any():
                return None
            cost[step, :n] = best
        # arrival: must sit in a readable resource at t_dst; the cached
        # read list preserves the legacy scan's iteration order, and
        # argmin's first occurrence preserves its strict-< tie-break
        reads = eng.reads_arr(dst_fu)
        final = cost[span, reads]
        j = int(np.argmin(final))
        best_cost = float(final[j])
        if best_cost == _INF:
            return None
        # reconstruct; the predecessor of a layer state is the first
        # ascending-CSR pred whose ROUNDED sum ``cost[k-1][u] + entry``
        # attains the layer minimum — the exact IEEE values the relaxation
        # compared (argmin over bare predecessor costs would be wrong:
        # float addition is not strictly monotone, so two different
        # predecessor costs can round to one sum, and the legacy
        # strict-improvement loop keeps the earlier rid of such a tie)
        gi = eng.pred_indices
        rid = int(reads[j])
        path = []
        for k in range(span, 1, -1):
            path.append((rid, t_src + k))
            preds = gi[gp[rid]:gp[rid + 1]]
            ent_k = ents[k][rid]
            rid = int(preds[np.argmin(cost[k - 1, preds] + ent_k)])
        path.append((rid, t_src + 1))
        path.reverse()
        # self-conflict: same net must not need one (rid, mod) slot twice;
        # path cycles are consecutive, so a repeat needs two slots a full
        # II apart — paths no longer than the II cannot conflict
        if span > ii:
            counts = Counter((r, t % ii) for r, t in path)
            conflicts = {m for m, c in counts.items() if c > 1}
        else:
            conflicts = ()
        return path, best_cost, conflicts


def _clip_window(row: np.ndarray, k: int) -> None:
    """Deterministic top-K beam: keep the K cheapest slots of one layer
    (ties broken toward the smallest rid via the stable sort), mask the
    rest to +inf, in place."""
    if int((row < _INF).sum()) <= k:
        return
    order = np.argsort(row, kind="stable")
    row[order[k:]] = _INF


def _route_session(
    sess: FanoutSession, dst_fu: FU, t_dst: int, cache: Optional[RouteCache]
) -> Optional[Tuple[List[Tuple[int, int]], float]]:
    """One cached query through a session: the route-cache lookup/store and
    stats accounting shared by :func:`route_edge` and the batched paths."""
    mrrg = sess.mrrg
    stats = mrrg.stats
    t0 = perf_counter()
    stats.calls += 1
    key = None
    if cache is not None:
        key = (mrrg.ii, sess.net, sess.src_fu.id, dst_fu.id, sess.t_src,
               t_dst, sess.allow, sess.window)
        out = cache.lookup(mrrg, key)
        if out is not ROUTE_MISS:
            stats.route_s += perf_counter() - t0
            return out
    out = sess.search(dst_fu, t_dst)
    if cache is not None:
        cache.store(mrrg, key, out)
    stats.route_s += perf_counter() - t0
    return out


def route_edge(
    mrrg: MRRG,
    net: int,
    src_fu: FU,
    dst_fu: FU,
    t_src: int,
    t_dst: int,
    *,
    allow_overuse: bool = False,
    cache: Optional[RouteCache] = None,
    engine: str = "auto",
    window: Optional[int] = None,
) -> Optional[Tuple[List[Tuple[int, int]], float]]:
    """Route one value (see :meth:`FanoutSession.search` for the conflict
    repair loop).  ``engine`` selects the search core — ``"auto"``
    (span-dispatched array/scalar hybrid), ``"vector"`` (always the array
    core), ``"legacy"`` (the scalar oracle) — all bit-identical.
    ``window`` opts into the top-K candidate beam (trajectory-changing).

    With a :class:`RouteCache`, the query is served from memoized results
    when the MRRG occupancy state (or, scoped tier, the cached path's
    slots) is unchanged — see the cache docstring for the exactness
    guarantees.
    """
    sess = FanoutSession(
        mrrg, net, src_fu, t_src,
        allow_overuse=allow_overuse, engine=engine, window=window,
    )
    return _route_session(sess, dst_fu, t_dst, cache)


def route_fanout(
    mrrg: MRRG,
    net: int,
    src_fu: FU,
    t_src: int,
    targets,
    *,
    allow_overuse: bool = False,
    cache: Optional[RouteCache] = None,
    engine: str = "auto",
    window: Optional[int] = None,
) -> List[Optional[Tuple[List[Tuple[int, int]], float]]]:
    """Route all consumers of one producer through a shared
    :class:`FanoutSession` — ``targets`` is a sequence of ``(dst_fu,
    t_dst)`` and the result is one ``(path, cost) | None`` per target.

    Each successful path is **reserved before the next consumer is
    routed** — exactly the sequential route-then-reserve semantics, so
    later consumers see earlier paths at the 0.05 same-net reuse discount
    (the fan-out sharing of the paper's collective routing) and results
    are bit-identical to a sequence of :func:`route_edge` calls.  Callers
    that only want costs must release the returned paths themselves.
    """
    sess = FanoutSession(
        mrrg, net, src_fu, t_src,
        allow_overuse=allow_overuse, engine=engine, window=window,
    )
    stats = mrrg.stats
    stats.fanout_batches += 1
    out: List[Optional[Tuple[List[Tuple[int, int]], float]]] = []
    for dst_fu, t_dst in targets:
        stats.fanout_edges += 1
        r = _route_session(sess, dst_fu, t_dst, cache)
        if r is not None:
            mrrg.reserve(net, r[0])
            sess.note_change(r[0])
        out.append(r)
    return out


def _route_edge_once(
    mrrg: MRRG,
    net: int,
    src_fu: FU,
    dst_fu: FU,
    t_src: int,
    t_dst: int,
    *,
    allow_overuse: bool = False,
    avoid: Optional[Set[Tuple[int, int]]] = None,
):
    """The legacy scalar DP, retained as the equivalence oracle for the
    array core (and as the short-span engine of the ``"auto"`` dispatch).

    Elapsed-time DP with A*-style pruning from the precomputed all-pairs
    hop-distance table: a state (rid, step k) is expanded only if the
    destination's operand inputs are still reachable in the remaining
    ``span - k`` cycles (``h[rid] <= span - k``).  The pruned state set is
    closed under the legacy full-layer DP's relaxations that matter — any
    pruned state provably cannot reach the goal — and viable states are
    relaxed in the same ascending-rid / architecture-edge order, so paths,
    costs and tie-breaks are bit-identical to the original blind Dijkstra/DP.
    """
    eng = mrrg.engine
    span = t_dst - t_src
    if span < 1:
        return None
    h = eng.h_to_reads(dst_fu)
    starts = eng.starts(src_fu)
    rem = span - 1
    if min((h[r] for r in starts), default=UNREACH) > rem:
        return None  # unreachable at this span, regardless of occupancy
    ii = mrrg.ii
    n = eng.n
    succ = eng.succ
    cap = eng.cap
    sv = mrrg.slot_vals
    base = mrrg._base
    INF = float("inf")
    cost = [INF] * n
    # back[k][rid] = predecessor rid at step k (None = start/unreached; the
    # two coincide only at k == 1, which reconstruction handles)
    back: List[Optional[List[Optional[int]]]] = [None] * (span + 1)
    back[1] = [None] * n
    t1 = t_src + 1
    cyc1 = t1 % ii
    active: List[int] = []  # rids with finite cost, ascending (legacy order)
    for rid in starts:
        if h[rid] > rem:
            continue
        if avoid and (rid, cyc1) in avoid:
            continue
        k = rid * ii + cyc1
        vals = sv[k]
        if vals is not None and (net, t1) in vals:
            c = 0.05  # same value reuse (fan-out) is nearly free
        else:
            over = (len(vals) if vals is not None else 0) + 1 - cap[rid]
            if over > 0:
                if not allow_overuse:
                    continue
                c = base[k] + 8.0 * over
            else:
                c = base[k]
        if c < cost[rid]:
            if cost[rid] == INF:
                active.append(rid)
            cost[rid] = c
    active.sort()
    for step in range(2, span + 1):
        t = t_src + step
        cyc = t % ii
        rem = span - step
        ncost = [INF] * n
        backk = back[step] = [None] * n
        nactive: List[int] = []
        # per-layer slot cost memo: the cost of entering (nxt, cyc) is the
        # same whichever predecessor relaxes it, so compute it once per
        # layer (INF = pruned/blocked at this layer); relaxation order and
        # tie-breaks are unchanged
        cmemo = [-1.0] * n
        for rid in active:
            cprev = cost[rid]
            for nxt in succ[rid]:
                nc = ncost[nxt]
                if cprev + 0.05 >= nc:
                    continue  # cannot strictly improve even at min step cost
                c = cmemo[nxt]
                if c < 0.0:
                    if h[nxt] > rem or (avoid and (nxt, cyc) in avoid):
                        c = INF
                    else:
                        k = nxt * ii + cyc
                        vals = sv[k]
                        if vals is not None and (net, t) in vals:
                            c = 0.05
                        else:
                            over = (
                                (len(vals) if vals is not None else 0)
                                + 1 - cap[nxt]
                            )
                            if over > 0:
                                c = base[k] + 8.0 * over if allow_overuse else INF
                            else:
                                c = base[k]
                    cmemo[nxt] = c
                tot = cprev + c
                if tot < nc:
                    if nc == INF:
                        nactive.append(nxt)
                    ncost[nxt] = tot
                    backk[nxt] = rid
        if not nactive:
            return None
        nactive.sort()
        active = nactive
        cost = ncost
    # arrival: must sit in a readable resource at t_dst (the engine caches
    # the read list once per FU; its set-iteration order is the tie-break)
    best_rid, best_cost = None, INF
    for rid in eng.reads(dst_fu):
        if cost[rid] < best_cost:
            best_cost = cost[rid]
            best_rid = rid
    if best_rid is None:
        return None
    # reconstruct
    path = []
    rid = best_rid
    for k in range(span, 0, -1):
        path.append((rid, t_src + k))
        rid = back[k][rid]
        if rid is None and k > 1:
            return None
    path.reverse()
    # self-conflict: same net must not need one (rid, mod) slot twice;
    # path cycles are consecutive, so a repeat needs two slots a full
    # II apart — paths no longer than the II cannot conflict
    if span > ii:
        counts = Counter((r, t % ii) for r, t in path)
        conflicts = {m for m, c in counts.items() if c > 1}
    else:
        conflicts = ()
    return path, best_cost, conflicts


class Router:
    """Context-bound incremental (re)route primitives shared by every
    placement and negotiation pass.  Reads the ``route_engine`` /
    ``route_window`` knobs through the context's config (the owning
    mapper) at use time."""

    def __init__(self, ctx):
        self.ctx = ctx

    def route_node_edges(
        self, mrrg: MRRG, dfg: DFG, mapping: Mapping, nodes: Set[int],
        allow_overuse=False, stop_on_fail=False,
    ) -> Tuple[bool, float]:
        """(Re)route only the edges touching ``nodes`` whose endpoints are
        placed — the incremental rip-up/reroute primitive behind every SA
        move.  Edge order matches the legacy full-scan (ascending index)."""
        tab = self.ctx.tables(dfg)
        by_node = tab.edges_by_node
        if len(nodes) == 1:
            (n0,) = nodes
            idxs = by_node.get(n0, ())
        else:
            s: Set[int] = set()
            for n0 in nodes:
                s.update(by_node.get(n0, ()))
            idxs = sorted(s)
        return self.route_edge_list(
            mrrg, dfg, mapping, idxs, allow_overuse, stop_on_fail
        )

    def route_edge_list(
        self, mrrg: MRRG, dfg: DFG, mapping: Mapping, idxs, allow_overuse=False,
        stop_on_fail=False,
    ) -> Tuple[bool, float]:
        """Route the given edge indices (ascending) between placed endpoints;
        existing routes are ripped first.  The routing primitive shared by
        the per-node incremental path and selective negotiation.

        Consecutive edges leaving the same producer share one
        :class:`FanoutSession` (entry-cost layers and the same-net reuse
        discount come structurally instead of by rediscovery); the
        rip/route/reserve interleaving is exactly the sequential order, so
        results are bit-identical to per-edge :func:`route_edge` calls.

        ``stop_on_fail`` aborts at the first unroutable edge — only for
        callers that discard the candidate on any failure (the strict
        placement scan): the remaining searches cannot change the rejection,
        and the rollback releases whatever was reserved either way.
        """
        cfg = self.ctx.config
        engine = getattr(cfg, "route_engine", "auto")
        window = getattr(cfg, "route_window", None)
        total = 0.0
        ok = True
        edges = dfg.edges
        fus = self.ctx.arch.fus
        place, tm = mapping.place, mapping.time
        cache = self.ctx.route_cache
        stats = mrrg.stats
        sess: Optional[FanoutSession] = None
        for idx in idxs:
            e = edges[idx]
            if e.src not in place or e.dst not in place:
                continue
            if idx in mapping.routes:
                old = mapping.pop_route(idx)
                mrrg.release(e.src, old)
                if sess is not None:
                    sess.note_change(old)
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            net, t_src = e.src, tm[e.src]
            t_dst = tm[e.dst] + e.distance * mapping.ii
            if sess is None or sess.net != net or sess.t_src != t_src:
                sess = FanoutSession(
                    mrrg, net, fus[place[e.src]], t_src,
                    allow_overuse=allow_overuse, engine=engine, window=window,
                )
                stats.fanout_batches += 1
            stats.fanout_edges += 1
            r = _route_session(sess, fus[place[e.dst]], t_dst, cache)
            if r is None:
                ok = False
                total += 50.0
                if stop_on_fail:
                    break
                continue
            path, c = r
            mrrg.reserve(e.src, path)
            sess.note_change(path)
            mapping.set_route(idx, path)
            total += c
        return ok, total

    def unroute_node(self, mrrg: MRRG, dfg: DFG, mapping: Mapping, n: int):
        edges = dfg.edges
        for idx in self.ctx.tables(dfg).edges_by_node.get(n, ()):
            if idx in mapping.routes:
                mrrg.release(edges[idx].src, mapping.pop_route(idx))
