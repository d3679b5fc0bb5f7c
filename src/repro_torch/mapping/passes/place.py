"""Placement passes: node-level greedy/SA move engines and the motif-level
hierarchical scan (Algorithm 2), including the placement acceleration
engine (distance-guided vectorized candidate ordering + whole-scan
memoization).  Port of ``repro/mapping/passes/place.py``, move for move.

Two engines, both bound to a :class:`~repro_torch.mapping.passes.base.PassContext`:

* :class:`NodePlacer` — single-node greedy placement, the SA move/cost
  machinery, and the overuse-tolerant greedy used by the negotiated mappers;
* :class:`UnitPlacer` — whole-unit (motif) placement with the paper's
  flexible schedule templates, candidate enumeration/filtering/scoring as
  numpy operations over flat candidate arrays, and the exact
  reachability/span filters from the routing engine's distance tables.

The pass classes at the bottom wrap these engines into pipeline stages:
greedy construction, SA improvement, multi-start unit placement, and the
overuse-tolerant node construction of the legacy PathFinder baseline.
Everything here is move-for-move identical to the JAX package's engines,
which its equivalence suites hold to the pre-split monolith's
trajectories; ``tests/test_torch_mapper.py`` holds the two packages'
mappings equal.
"""
from __future__ import annotations

import math
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.routing import engine_for
from repro_torch.mapping.mapping import Mapping
from repro_torch.mapping.mrrg import min_span
from repro_torch.mapping.passes.base import (
    CONTINUE,
    FAIL,
    MapperPass,
    MapState,
    PassContext,
)
from repro_torch.mapping.passes.extract import Unit, motif_templates
from repro_torch.mapping.passes.route import Router


# ---------------------------------------------------------------------------
# Node-level engine (greedy + SA moves)
# ---------------------------------------------------------------------------


class NodePlacer:
    """Single-node placement machinery shared by the SA and negotiated
    mappers: exact per-FU time windows from the distance tables, provable
    cost-floor early termination, incremental displace/restore."""

    def __init__(self, ctx: PassContext):
        self.ctx = ctx
        self.arch = ctx.arch
        self.router = Router(ctx)

    # -- scheduling helpers --------------------------------------------------
    def ready_time(self, dfg, mapping: Mapping, n: int, ii: int) -> int:
        tab = self.ctx.tables(dfg)
        t = tab.asap[n]
        tm = mapping.time
        for src in tab.intra_preds.get(n, ()):
            ts = tm.get(src)
            if ts is not None and ts + 1 > t:
                t = ts + 1
        return t

    def node_route_constraints(self, mrrg, dfg, mapping, n):
        """Distance-table constraints on placing ``n``: a list of
        ``(kind, other_fu, base_t)`` for its placed routable edges (kind
        ``in``/``out``/``self``) plus the provable routing-cost floor
        ``0.05 * sum(min achievable span)``.  A candidate ``(fu, t)``
        violating any exact minimum route span is *guaranteed* to fail
        routing, so skipping it cannot change which candidate wins."""
        tab = self.ctx.tables(dfg)
        rsm = mrrg.engine.route_span_mat()
        ii = mapping.ii
        place, tm = mapping.place, mapping.time
        edges = dfg.edges
        cons = []
        floor = 0.0
        nf = len(self.arch.fus)
        for idx in tab.edges_by_node.get(n, ()):
            e = edges[idx]
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            if e.src == n and e.dst == n:
                cons.append(("self", None, e.distance * ii))
                floor += 0.05 * (e.distance * ii)
            elif e.src == n and e.dst in place:
                fo = place[e.dst]
                cons.append(("out", fo, tm[e.dst] + e.distance * ii))
                floor += 0.05 * float(min(rsm[f, fo] for f in range(nf)))
            elif e.dst == n and e.src in place:
                fo = place[e.src]
                cons.append(("in", fo, tm[e.src] - e.distance * ii))
                floor += 0.05 * float(min(rsm[fo, f] for f in range(nf)))
        return cons, floor

    # -- greedy placement ----------------------------------------------------
    def greedy_place(self, mrrg, dfg, mapping, n, rng, randomize=False) -> bool:
        cands = self.ctx.fu_candidates(dfg, n)
        if randomize:
            rng.shuffle(cands)
        ready = self.ready_time(dfg, mapping, n, mapping.ii)
        cons, c_floor = self.node_route_constraints(mrrg, dfg, mapping, n)
        rsm = mrrg.engine.route_span_mat()
        best = None
        for fu in cands:
            # feasible time window for this FU from the exact span minima
            t_lo, t_hi = ready, ready + mapping.ii + 3
            ok_fu = True
            for kind, fo, base in cons:
                if kind == "self":
                    if rsm[fu, fu] > base:
                        ok_fu = False
                        break
                elif kind == "out":  # t + span(fu -> fo) <= t_dst
                    t_hi = min(t_hi, base - int(rsm[fu, fo]))
                else:  # "in": t_src + span(fo -> fu) <= t + dist*ii
                    t_lo = max(t_lo, base + int(rsm[fo, fu]))
            if not ok_fu or t_lo > t_hi:
                continue
            for t in range(t_lo, t_hi + 1):
                if not mrrg.fu_free(fu, t):
                    continue
                self.place_at(mrrg, dfg, mapping, n, fu, t)
                ok, c = self.router.route_node_edges(mrrg, dfg, mapping, {n})
                if ok and (best is None or c < best[2]):
                    best = (fu, t, c)
                self.displace(mrrg, dfg, mapping, n)
                if best is not None and randomize:
                    break
            if best is not None and randomize:
                break
            if best is not None and best[2] <= c_floor:
                break  # provably minimal: no candidate can cost less
        if best is None:
            return False
        self.place_at(mrrg, dfg, mapping, n, best[0], best[1])
        self.router.route_node_edges(mrrg, dfg, mapping, {n})
        return True

    def greedy_place_overuse(self, mrrg, dfg, mapping, n, rng) -> bool:
        """Overuse-tolerant greedy (the legacy PathFinder construction):
        first free FU slot in a shuffled candidate order, edges routed with
        congestion allowed — negotiation repairs the overuse later."""
        cands = self.ctx.fu_candidates(dfg, n)
        rng.shuffle(cands)
        ready = self.ready_time(dfg, mapping, n, mapping.ii)
        for fu in cands:
            for dt in range(mapping.ii):
                t = ready + dt
                if mrrg.fu_free(fu, t):
                    mapping.place[n] = fu
                    mapping.time[n] = t
                    mrrg.take_fu(fu, t, n)
                    self.router.route_node_edges(
                        mrrg, dfg, mapping, {n}, allow_overuse=True
                    )
                    return True
        return False

    # -- incremental move primitives ----------------------------------------
    def place_at(self, mrrg, dfg, mapping, n, fu, t):
        mapping.place[n] = fu
        mapping.time[n] = t
        mrrg.take_fu(fu, t, n)
        self.router.route_node_edges(mrrg, dfg, mapping, {n})

    def displace(self, mrrg, dfg, mapping, n):
        if n in mapping.place:
            self.router.unroute_node(mrrg, dfg, mapping, n)
            mrrg.free_fu(mapping.place[n], mapping.time[n])
            del mapping.place[n]
            del mapping.time[n]

    # -- acceptance cost -----------------------------------------------------
    def all_routed(self, dfg, mapping) -> bool:
        # routes only ever holds routable edges, so a count compare suffices
        return len(mapping.routes) == self.ctx.tables(dfg).n_routable

    def cost(self, dfg, mapping, mrrg) -> float:
        """Move-acceptance cost, evaluated from incrementally-maintained
        counters (overuse, route length) — O(edges) worst case instead of a
        full MRRG scan.  Produces the exact value of the legacy formula."""
        tab = self.ctx.tables(dfg)
        unplaced = len(dfg.nodes) - len(mapping.place)
        unrouted = 0
        place, routes = mapping.place, mapping.routes
        for idx, src, dst in tab.routable:
            if src in place and dst in place and idx not in routes:
                unrouted += 1
        return (
            100.0 * unplaced + 40.0 * unrouted
            + 25.0 * mrrg.overuse_count() + 0.1 * mapping.route_len
        )


# ---------------------------------------------------------------------------
# Unit-level engine (Algorithm 2 + the placement acceleration engine)
# ---------------------------------------------------------------------------


class UnitPlacer(NodePlacer):
    """Whole-unit placement: motif schedule templates over PCUs, with the
    vectorized distance-guided candidate scan (bit-identical to the scalar
    reference scan — enforced by tests/test_placement_engine.py)."""

    def pcus(self) -> List[List[int]]:
        """FU ids per PCU: [alu0, alu1, alu2, alsu]."""
        tiles = {}
        for fu in self.arch.fus:
            tiles.setdefault(fu.tile, []).append(fu.id)
        return [sorted(v) for _, v in sorted(tiles.items())]

    def pcu_of(self, fu_id: int) -> Optional[int]:
        if self.arch.kind != "plaid":
            return None
        tile = self.arch.fus[fu_id].tile
        return tile[0] * self.arch.cols + tile[1]

    # -- neighbourhood scoring ----------------------------------------------
    def neighbour_tiles(self, dfg, mapping, u) -> List[Tuple[int, int]]:
        """Tiles of already-placed neighbours of the unit (one entry per
        incident intra edge, as the legacy per-edge scan counted them)."""
        tab = self.ctx.tables(dfg)
        members = set(u.nodes)
        idxs: Set[int] = set()
        for n in u.nodes:
            idxs.update(tab.intra_by_node.get(n, ()))
        tiles = []
        edges = dfg.edges
        for idx in idxs:
            e = edges[idx]
            other = None
            if e.dst in members and e.src not in members:
                other = e.src
            elif e.src in members and e.dst not in members:
                other = e.dst
            if other is not None and other in mapping.place:
                tiles.append(self.arch.fus[mapping.place[other]].tile)
        return tiles

    def locality_key(self, dfg, mapping, u, fu_id, tiles=None):
        """Prefer tiles close to already-placed neighbours of the unit."""
        if tiles is None:
            tiles = self.neighbour_tiles(dfg, mapping, u)
        if not tiles:
            return 0
        t = self.arch.fus[fu_id].tile
        return sum(abs(t[0] - a) + abs(t[1] - b) for a, b in tiles)

    # -- feasible scan entry point -------------------------------------------
    def place_unit_feasible(self, mrrg, dfg, mapping, u: Unit, rng,
                            max_feasible: int = 14) -> bool:
        if self.ctx.config.candidate_ordering:
            return self.place_unit_feasible_fast(
                mrrg, dfg, mapping, u, rng, max_feasible
            )
        return self.place_unit_feasible_scalar(
            mrrg, dfg, mapping, u, rng, max_feasible
        )

    def place_unit_feasible_scalar(self, mrrg, dfg, mapping, u: Unit, rng,
                                   max_feasible: int = 14) -> bool:
        """Reference implementation of the candidate scan; the vectorized
        fast path is bit-identical to this (same candidate chosen, same
        trajectory) — enforced by tests/test_placement_engine.py."""
        plcs = self.candidate_placements(dfg, mapping, u, rng)
        plcs = [p_ for p_ in plcs if self.span_ok(dfg, mapping, p_)]
        # earliest feasible time first (list-scheduling); then spread load
        # across tiles (router bandwidth!), then locality
        fus = self.arch.fus
        fu_load, tile_load = mrrg.fu_load, mrrg.tile_load

        def busy(plc):
            fu = plc[0][1]
            return (
                2.0 * fu_load.get(fu, 0)
                + 1.0 * tile_load.get(fus[fu].tile, 0)
            )
        if not plcs:
            return False
        nbr_tiles = self.neighbour_tiles(dfg, mapping, u)
        t0 = min(max(t for _, _, t in plc) for plc in plcs)
        # exploration order: time-bucketed with balance tie-break
        plcs.sort(key=lambda plc: (
            max(t for _, _, t in plc),
            busy(plc) + self.locality_key(dfg, mapping, u, plc[0][1], nbr_tiles),
        ))
        best, best_s = None, None
        n_feasible = 0
        for plc in plcs[:150]:
            c = self.try_placement_strict(mrrg, dfg, mapping, plc)
            if c is None:
                continue
            n_feasible += 1
            # combined score: locality dominates (short spans keep the
            # collective router uncongested), then routing cost, lateness,
            # and tile pressure
            score = (
                0.5 * (max(t for _, _, t in plc) - t0)
                + 1.0 * busy(plc)
                + 1.0 * c
                + 2.0 * self.locality_key(dfg, mapping, u, plc[0][1], nbr_tiles)
            )
            if best_s is None or score < best_s:
                best, best_s = plc, score
            self.remove_placement(mrrg, dfg, mapping, plc)
            if n_feasible >= max_feasible:
                break
        if best is None:
            return False
        c = self.try_placement_strict(mrrg, dfg, mapping, best)
        return c is not None

    # -- vectorized candidate scan (the placement acceleration engine) ------

    def candidate_arrays(self, dfg, u: Unit, ii: int):
        """Flat candidate arrays ``(cols, F, T0)`` mirroring the exact
        enumeration order of :meth:`candidate_placements`: row *i* is
        candidate *i*, column *j* is unit node ``cols[j]``; times are
        relative to ``unit_ready == 0`` (add the ready time at use).  Cached
        per ``(unit, ii)`` — the enumeration is placement-independent, so
        restarts and repeated scans reuse it."""
        key = (u.nodes, u.kind, ii)
        ent = self.ctx.cand_arrays_cache.get(key)
        if ent is not None:
            return ent
        F_rows: List[Tuple[int, ...]] = []
        T_rows: List[Tuple[int, ...]] = []
        if u.kind == "single":
            n = u.nodes[0]
            cols = (n,)
            for fu in self.ctx.fu_candidates(dfg, n):
                # hardwired PCUs refuse standalone nodes on their ALUs (§4.4)
                pcu_idx = self.pcu_of(fu)
                if pcu_idx is not None and pcu_idx in self.arch.hardwired \
                        and self.arch.fus[fu].kind == "alu":
                    continue
                for dt in range(ii + 4):
                    F_rows.append((fu,))
                    T_rows.append((dt,))
        else:
            cols = u.nodes
            tmpls = motif_templates(u.kind)
            nroles = len(cols)
            for p_idx, pcu in enumerate(self.pcus()):
                alus = pcu[:3]
                hard = self.arch.hardwired.get(p_idx)
                if hard is not None and hard != u.kind:
                    continue
                use = tmpls if hard is None else tmpls[:1]  # fixed wiring
                for tm in use:
                    frow = tuple(alus[tm[r][0]] for r in range(nroles))
                    offs = tuple(tm[r][1] for r in range(nroles))
                    for dt in range(ii + 4):
                        F_rows.append(frow)
                        T_rows.append(tuple(dt + o for o in offs))
        ncols = len(cols)
        F = np.asarray(F_rows, dtype=np.int64).reshape(len(F_rows), ncols)
        T0 = np.asarray(T_rows, dtype=np.int64).reshape(len(T_rows), ncols)
        ent = (cols, F, T0)
        self.ctx.cand_arrays_cache[key] = ent
        return ent

    def span_mask(self, dfg, mapping, cols, F, T) -> np.ndarray:
        """Vectorized :meth:`span_ok` over candidate arrays (identical
        predicate: Manhattan ``min_span`` on intra edges)."""
        tab = self.ctx.tables(dfg)
        msp = engine_for(self.arch).min_span_mat()
        col_of = {n: j for j, n in enumerate(cols)}
        idxs: Set[int] = set()
        for n in cols:
            idxs.update(tab.intra_by_node.get(n, ()))
        mask = np.ones(F.shape[0], dtype=bool)
        edges = dfg.edges
        nodes = dfg.nodes
        tm, place = mapping.time, mapping.place
        for idx in idxs:
            e = edges[idx]
            js, jd = col_of.get(e.src), col_of.get(e.dst)
            ts = T[:, js] if js is not None else tm.get(e.src)
            td = T[:, jd] if jd is not None else tm.get(e.dst)
            if ts is None or td is None:
                continue
            if nodes[e.src].op in ("const", "input"):
                continue
            fs = F[:, js] if js is not None else place[e.src]
            fd = F[:, jd] if jd is not None else place[e.dst]
            mask &= (td - ts) >= msp[fs, fd]
        return mask

    def reachable_mask(self, dfg, mapping, cols, F, T, ii, eng) -> np.ndarray:
        """Vectorized :meth:`reachable_ok` (exact min-route-span from the
        distance tables, over ALL incident edges incl. inter-iteration)."""
        tab = self.ctx.tables(dfg)
        rsm = eng.route_span_mat()
        col_of = {n: j for j, n in enumerate(cols)}
        idxs: Set[int] = set()
        for n in cols:
            idxs.update(tab.edges_by_node.get(n, ()))
        mask = np.ones(F.shape[0], dtype=bool)
        edges = dfg.edges
        nodes = dfg.nodes
        tm, place = mapping.time, mapping.place
        for idx in idxs:
            e = edges[idx]
            if nodes[e.src].op in ("const", "input"):
                continue
            js, jd = col_of.get(e.src), col_of.get(e.dst)
            ts = T[:, js] if js is not None else tm.get(e.src)
            td = T[:, jd] if jd is not None else tm.get(e.dst)
            if ts is None or td is None:
                continue
            fs = F[:, js] if js is not None else place[e.src]
            fd = F[:, jd] if jd is not None else place[e.dst]
            span = td + e.distance * ii - ts
            mask &= (span >= 1) & (rsm[fs, fd] <= span)
        return mask

    def busy_arr(self, mrrg, fu0: np.ndarray) -> np.ndarray:
        """Vectorized ``busy``: ``2*fu_load + tile_load`` per candidate."""
        eng = mrrg.engine
        _, _, tile_idx, n_tiles = eng.fu_aux()
        fl = np.zeros(len(self.arch.fus), dtype=np.float64)
        for f, v in mrrg.fu_load.items():
            fl[f] = v
        tl = np.zeros(n_tiles, dtype=np.float64)
        tidx = eng.tile_index()
        for tile, v in mrrg.tile_load.items():
            tl[tidx[tile]] = v
        return 2.0 * fl[fu0] + 1.0 * tl[tile_idx[fu0]]

    def locality_arr(self, mrrg, nbr_tiles, fu0: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`locality_key` (Manhattan sum to neighbour
        tiles, duplicates kept — one entry per incident edge)."""
        if not nbr_tiles:
            return np.zeros(fu0.shape[0], dtype=np.float64)
        fx, fy, _, _ = mrrg.engine.fu_aux()
        ax = np.asarray([a for a, _ in nbr_tiles], dtype=np.int64)
        ay = np.asarray([b for _, b in nbr_tiles], dtype=np.int64)
        loc = (np.abs(fx[:, None] - ax[None, :]).sum(axis=1)
               + np.abs(fy[:, None] - ay[None, :]).sum(axis=1))
        return loc[fu0].astype(np.float64)

    def place_unit_feasible_fast(self, mrrg, dfg, mapping, u: Unit, rng,
                                 max_feasible: int = 14) -> bool:
        """Distance-guided vectorized candidate scan — chooses the same
        placement as :meth:`place_unit_feasible_scalar` (bit-identical
        trajectory) but gets there faster:

        * candidate enumeration, span filtering, busy/locality scoring and
          exploration ordering run as numpy operations over flat candidate
          arrays (cached per unit/II) instead of per-candidate Python;
        * the exact reachability filter (``reachable_ok``) runs vectorized
          over the whole exploration window up front;
        * the scan stops early once no remaining candidate's provable
          score lower bound (routing cost ≥ 0) can beat the incumbent —
          candidates it skips provably would not have been selected.
        """
        ii = mapping.ii
        # whole-scan memoization: the scan is a pure function of the unit
        # and the full mapper state — occupancy (state_hash), history
        # (hist_ver) and placement (place_hash).  Multi-start restarts replay
        # long identical prefixes, so repeated scans (25-35% in practice)
        # collapse to re-applying the recorded outcome, which reproduces the
        # exact mutations the full scan would have made.
        memo_key = (u.nodes, u.kind, ii, mrrg.state_hash, mrrg.place_hash,
                    mrrg.hist_ver, max_feasible)
        memo = self.ctx.scan_memo
        hit = memo.get(memo_key)
        if hit is not None:
            if hit is False:
                return False
            return self.try_placement_routed(
                mrrg, dfg, mapping, list(hit)
            ) is not None
        cols, F_all, T0 = self.candidate_arrays(dfg, u, ii)
        if F_all.shape[0] == 0:
            memo[memo_key] = False
            return False
        ready = self.unit_ready(dfg, mapping, u)
        T_all = T0 + ready
        mask = self.span_mask(dfg, mapping, cols, F_all, T_all)
        if not mask.any():
            memo[memo_key] = False
            return False
        F = F_all[mask]
        T = T_all[mask]
        maxt = T.max(axis=1)
        t0 = int(maxt.min())
        nbr_tiles = self.neighbour_tiles(dfg, mapping, u)
        fu0 = F[:, 0]
        busy = self.busy_arr(mrrg, fu0)
        loc = self.locality_arr(mrrg, nbr_tiles, fu0)
        # exploration order: time-bucketed with balance tie-break (stable,
        # so ties resolve to enumeration order exactly like list.sort)
        order = np.lexsort((busy + loc, maxt))
        if order.shape[0] > 150:
            order = order[:150]
        keep = self.reachable_mask(
            dfg, mapping, cols, F[order], T[order], ii, mrrg.engine
        )
        order = order[keep]
        if order.shape[0] == 0:
            memo[memo_key] = False
            return False
        # provable per-candidate score lower bound (routing cost >= 0);
        # IEEE addition is monotone in non-negative terms, so lb <= score
        lb = 0.5 * (maxt[order] - t0) + busy[order] + 2.0 * loc[order]
        sufmin = np.minimum.accumulate(lb[::-1])[::-1]
        ncols = len(cols)
        best, best_s = None, None
        n_feasible = 0
        for i in range(order.shape[0]):
            if best_s is not None and sufmin[i] >= best_s:
                break  # no remaining candidate can beat the incumbent
            ci = order[i]
            plc = [(cols[j], int(F[ci, j]), int(T[ci, j]))
                   for j in range(ncols)]
            c = self.try_placement_routed(mrrg, dfg, mapping, plc)
            if c is None:
                continue
            n_feasible += 1
            score = (
                0.5 * (int(maxt[ci]) - t0)
                + 1.0 * float(busy[ci])
                + 1.0 * c
                + 2.0 * float(loc[ci])
            )
            if best_s is None or score < best_s:
                best, best_s = plc, score
            self.remove_placement(mrrg, dfg, mapping, plc)
            if n_feasible >= max_feasible:
                break
        if best is None:
            memo[memo_key] = False
            return False
        memo[memo_key] = tuple(best)
        return self.try_placement_routed(mrrg, dfg, mapping, best) is not None

    # -- candidate feasibility filters ---------------------------------------
    def reachable_ok(self, mrrg, dfg, mapping, plc) -> bool:
        """Exact unreachable-pruning from the distance tables: a candidate
        with an incident edge whose span is below the fabric's minimum
        route latency is guaranteed to fail routing — skip it before paying
        for placement + route attempts.  One-sided: never skips a candidate
        the router could accept."""
        times = {n: t for n, _, t in plc}
        fus_of = {n: fu for n, fu, _ in plc}
        tab = self.ctx.tables(dfg)
        eng = mrrg.engine
        idxs: Set[int] = set()
        for n in times:
            idxs.update(tab.edges_by_node.get(n, ()))
        edges = dfg.edges
        arch_fus = self.arch.fus
        tm, place = mapping.time, mapping.place
        for idx in idxs:
            e = edges[idx]
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            ts = times.get(e.src, tm.get(e.src))
            td = times.get(e.dst, tm.get(e.dst))
            if ts is None or td is None:
                continue
            span = td + e.distance * mapping.ii - ts
            if span < 1:
                return False
            f_s = fus_of.get(e.src, place.get(e.src))
            f_d = fus_of.get(e.dst, place.get(e.dst))
            if eng.min_route_span(arch_fus[f_s], arch_fus[f_d]) > span:
                return False
        return True

    def span_ok(self, dfg, mapping, plc) -> bool:
        times = {n: t for n, _, t in plc}
        fus = {n: fu for n, fu, _ in plc}
        tab = self.ctx.tables(dfg)
        idxs: Set[int] = set()
        for n in times:
            idxs.update(tab.intra_by_node.get(n, ()))
        edges = dfg.edges
        arch_fus = self.arch.fus
        for idx in idxs:
            e = edges[idx]
            ts = times.get(e.src, mapping.time.get(e.src))
            td = times.get(e.dst, mapping.time.get(e.dst))
            if ts is None or td is None:
                continue
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            f_s = fus.get(e.src, mapping.place.get(e.src))
            f_d = fus.get(e.dst, mapping.place.get(e.dst))
            if td - ts < min_span(self.arch, arch_fus[f_s], arch_fus[f_d]):
                return False
        return True

    # -- placement attempt primitives ----------------------------------------
    def try_placement_strict(self, mrrg, dfg, mapping, plc):
        """Like :meth:`try_placement` but rejects unless every incident
        placed edge routes."""
        if not self.reachable_ok(mrrg, dfg, mapping, plc):
            return None
        return self.try_placement_routed(mrrg, dfg, mapping, plc)

    def try_placement_routed(self, mrrg, dfg, mapping, plc):
        """The place-and-route half of :meth:`try_placement_strict`; the
        vectorized scan runs the reachability filter over whole candidate
        arrays up front, so it enters here directly."""
        for n, fu, t in plc:
            if not mrrg.fu_free(fu, t):
                return None
        nodes = set()
        for n, fu, t in plc:
            mapping.place[n] = fu
            mapping.time[n] = t
            mrrg.take_fu(fu, t, n)
            nodes.add(n)
        # any failed edge rejects the candidate outright, so the router may
        # abort at the first failure (the rollback below restores the MRRG
        # identically; cost is unused on rejection)
        ok, c = self.router.route_node_edges(
            mrrg, dfg, mapping, nodes, stop_on_fail=True
        )
        if not ok:
            self.remove_placement(mrrg, dfg, mapping, plc)
            return None
        return c

    def unit_ready(self, dfg, mapping: Mapping, u: Unit) -> int:
        tab = self.ctx.tables(dfg)
        members = set(u.nodes)
        t = min(tab.asap[n] for n in members)
        tm = mapping.time
        for n in u.nodes:
            for src in tab.intra_preds.get(n, ()):
                if src not in members:
                    ts = tm.get(src)
                    if ts is not None and ts + 1 > t:
                        t = ts + 1
        return t

    def candidate_placements(self, dfg, mapping, u: Unit, rng, limit=None):
        """Yield concrete placements: list of (node, fu, t)."""
        out = []
        if u.kind == "single":
            n = u.nodes[0]
            ready = self.unit_ready(dfg, mapping, u)
            for fu in self.ctx.fu_candidates(dfg, n):
                # hardwired PCUs refuse standalone nodes on their ALUs (§4.4)
                pcu_idx = self.pcu_of(fu)
                if pcu_idx is not None and pcu_idx in self.arch.hardwired \
                        and self.arch.fus[fu].kind == "alu":
                    continue
                for dt in range(mapping.ii + 4):
                    out.append([(n, fu, ready + dt)])
        else:
            ready = self.unit_ready(dfg, mapping, u)
            tmpls = motif_templates(u.kind)
            for p_idx, pcu in enumerate(self.pcus()):
                alus = pcu[:3]
                hard = self.arch.hardwired.get(p_idx)
                if hard is not None and hard != u.kind:
                    continue
                use = tmpls if hard is None else tmpls[:1]  # fixed wiring
                for tm in use:
                    for dt in range(mapping.ii + 4):
                        base = ready + dt
                        out.append([
                            (u.nodes[role], alus[slot], base + off)
                            for role, (slot, off) in sorted(tm.items())
                        ])
        if limit is not None and len(out) > limit:
            rng.shuffle(out)
            out = out[:limit]
        return out

    def try_placement(self, mrrg, dfg, mapping, plc) -> Optional[float]:
        for n, fu, t in plc:
            if not mrrg.fu_free(fu, t):
                return None
        nodes = set()
        for n, fu, t in plc:
            mapping.place[n] = fu
            mapping.time[n] = t
            mrrg.take_fu(fu, t, n)
            nodes.add(n)
        ok, c = self.router.route_node_edges(mrrg, dfg, mapping, nodes)
        if not ok:
            c += 200.0
        return c

    def remove_placement(self, mrrg, dfg, mapping, plc):
        for n, fu, t in plc:
            if n in mapping.place:
                self.router.unroute_node(mrrg, dfg, mapping, n)
                mrrg.free_fu(mapping.place[n], mapping.time[n])
                del mapping.place[n]
                del mapping.time[n]

    # -- optional whole-unit move helpers (kept for mapper composition) ------
    def place_unit_best(self, mrrg, dfg, mapping, u: Unit, rng, limit=64) -> bool:
        best, best_c = None, None
        for plc in self.candidate_placements(dfg, mapping, u, rng, limit=limit):
            c = self.try_placement(mrrg, dfg, mapping, plc)
            if c is not None:
                if best_c is None or c < best_c:
                    best, best_c = plc, c
                self.remove_placement(mrrg, dfg, mapping, plc)
                if best_c is not None and best_c < 1.0:
                    break
        if best is None:
            return False
        self.try_placement(mrrg, dfg, mapping, best)
        return True

    def place_unit_random(self, mrrg, dfg, mapping, u: Unit, rng) -> bool:
        plcs = self.candidate_placements(dfg, mapping, u, rng)
        rng.shuffle(plcs)
        # "generate different motif schedules ... select the combination
        # yielding the highest objective" — evaluate a handful
        best, best_c = None, None
        for plc in plcs[:24]:
            c = self.try_placement(mrrg, dfg, mapping, plc)
            if c is not None:
                if best_c is None or c < best_c:
                    best, best_c = plc, c
                self.remove_placement(mrrg, dfg, mapping, plc)
        if best is None:
            return False
        self.try_placement(mrrg, dfg, mapping, best)
        return True

    def displace_unit(self, mrrg, dfg, mapping, u: Unit):
        for n in u.nodes:
            if n in mapping.place:
                self.router.unroute_node(mrrg, dfg, mapping, n)
                mrrg.free_fu(mapping.place[n], mapping.time[n])
                del mapping.place[n]
                del mapping.time[n]

    def snapshot_unit(self, mapping, u: Unit):
        return [
            (n, mapping.place.get(n), mapping.time.get(n)) for n in u.nodes
        ]

    def restore_unit(self, mrrg, dfg, mapping, u: Unit, snap):
        plc = [(n, fu, t) for n, fu, t in snap if fu is not None]
        self.try_placement(mrrg, dfg, mapping, plc)

    # -- validity ------------------------------------------------------------
    def valid(self, dfg, mapping, mrrg) -> bool:
        need = sum(
            1 for n in dfg.nodes.values() if n.op not in ("const", "input")
        )
        return (
            len(mapping.place) == need
            and not mrrg.has_overuse()
            and self.all_routed(dfg, mapping)
        )

    def offending_units(self, dfg, mapping, units) -> List[Unit]:
        bad_nodes: Set[int] = set()
        for idx, e in enumerate(dfg.edges):
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            if idx not in mapping.routes:
                bad_nodes.add(e.src)
                bad_nodes.add(e.dst)
        for n in dfg.nodes:
            if n not in mapping.place:
                bad_nodes.add(n)
        return [u for u in units if any(n in bad_nodes for n in u.nodes)]

    def place_unit_seeded(self, mrrg, dfg, mapping, u, seed,
                          *, allow_overuse: bool = False) -> bool:
        """Warm-start protocol (global-then-detailed): place the unit
        exactly where the global seed put it, provided every member has a
        seed slot, the slots are still free, and the placement passes the
        exact span filter against the current partial mapping.  Returns
        ``False`` with all state untouched when the seed is stale — the
        caller falls back to its from-scratch scan for this unit."""
        plc = []
        for n in u.nodes:
            s = seed.get(n)
            if s is None:
                return False
            plc.append((n, s[0], s[1]))
        if any(not mrrg.fu_free(fu, t) for _, fu, t in plc):
            return False
        if not self.span_ok(dfg, mapping, plc):
            return False
        if allow_overuse:
            nodes = set()
            for n, fu, t in plc:
                mapping.place[n] = fu
                mapping.time[n] = t
                mrrg.take_fu(fu, t, n)
                nodes.add(n)
            self.router.route_node_edges(
                mrrg, dfg, mapping, nodes, allow_overuse=True
            )
            return True
        return self.try_placement_strict(mrrg, dfg, mapping, plc) is not None

    def place_unit_overuse(self, mrrg, dfg, mapping, u, rng) -> bool:
        """Overuse-tolerant unit placement (the negotiated mappers'
        construction): earliest-slot candidates, congestion allowed."""
        if self.ctx.config.candidate_ordering:
            cols, F_all, T0 = self.candidate_arrays(dfg, u, mapping.ii)
            if F_all.shape[0] == 0:
                return False
            T_all = T0 + self.unit_ready(dfg, mapping, u)
            m = self.span_mask(dfg, mapping, cols, F_all, T_all)
            ncols = len(cols)
            plcs = [
                [(cols[j], int(F_all[i, j]), int(T_all[i, j]))
                 for j in range(ncols)]
                for i in np.flatnonzero(m)
            ]
        else:
            plcs = self.candidate_placements(dfg, mapping, u, rng)
            plcs = [p_ for p_ in plcs if self.span_ok(dfg, mapping, p_)]
        rng.shuffle(plcs)
        plcs.sort(key=lambda plc: max(t for _, _, t in plc))
        for plc in plcs[:60]:
            if any(not mrrg.fu_free(fu, t) for _, fu, t in plc):
                continue
            for n, fu, t in plc:
                mapping.place[n] = fu
                mapping.time[n] = t
                mrrg.take_fu(fu, t, n)
            self.router.route_node_edges(
                mrrg, dfg, mapping, set(u.nodes), allow_overuse=True
            )
            return True
        return False


# ---------------------------------------------------------------------------
# Placement passes
# ---------------------------------------------------------------------------


class GreedyConstructionPass(MapperPass):
    """Initial greedy placement in topo order (the SA baseline's
    constructor).  Nodes that fail to place are left for annealing."""

    name = "place"

    def run(self, ctx: PassContext, state: MapState) -> str:
        placer = ctx.placer
        dfg = state.dfg
        state.mrrg = mrrg = ctx.new_mrrg(state.ii)
        state.mapping = mapping = Mapping(dfg, state.ii, arch=ctx.arch)
        order = dfg.topo_order()
        # greedy initial placement
        for n in order:
            if not placer.greedy_place(mrrg, dfg, mapping, n, state.rng):
                pass  # leave unplaced; SA will try
        state.scratch["order"] = order
        return CONTINUE


class SAImprovementPass(MapperPass):
    """Simulated annealing over single-node moves [3, 68, 73] — the SA
    baseline's improvement loop (budgeted, plateau-bounded)."""

    name = "anneal"

    def run(self, ctx: PassContext, state: MapState) -> str:
        placer = ctx.placer
        dfg, mrrg, mapping, rng = state.dfg, state.mrrg, state.mapping, state.rng
        order = state.scratch["order"]
        unplaced = [n for n in order if n not in mapping.place]
        cost = placer.cost(dfg, mapping, mrrg)
        temp = 2.0
        last_gain = 0
        for step in range(ctx.config.time_budget):
            if step % 128 == 0:  # cooperative deadline check (pure read)
                ctx.check_deadline(f"anneal step {step}")
            if not unplaced and not mrrg.has_overuse() \
                    and placer.all_routed(dfg, mapping):
                break
            if step - last_gain > 400:
                break  # plateau: give up at this II
            n = (rng.choice(unplaced)
                 if unplaced and rng.random() < 0.7 else rng.choice(order))
            old = (mapping.place.get(n), mapping.time.get(n))
            placer.displace(mrrg, dfg, mapping, n)
            placer.greedy_place(mrrg, dfg, mapping, n, rng, randomize=True)
            newcost = placer.cost(dfg, mapping, mrrg)
            if newcost < cost:
                last_gain = step
            if newcost <= cost or rng.random() < math.exp(
                    (cost - newcost) / max(temp, 1e-3)):
                cost = newcost
            else:  # revert
                placer.displace(mrrg, dfg, mapping, n)
                if old[0] is not None:
                    placer.place_at(mrrg, dfg, mapping, n, old[0], old[1])
            unplaced = [x for x in order if x not in mapping.place]
            temp *= 0.999
        return CONTINUE


class MultiStartUnitPlacementPass(MapperPass):
    """Algorithm 2's multi-start greedy construction: units in dependency
    order, each placed on the candidate with the least routing cost among
    those whose incident edges ALL route (the 'least routing resource'
    rule); random restarts perturb order and candidate sampling."""

    name = "place"

    def run(self, ctx: PassContext, state: MapState) -> str:
        cfg = ctx.config
        placer = ctx.placer
        dfg, ii = state.dfg, state.ii
        base_units = state.units
        seed = state.scratch.get("global_seed")
        if seed:
            # seeded warm start: one extra attempt in front of the
            # unchanged restart loop (restart stream -1), taking each
            # unit's seed slot when it is still exactly feasible and
            # falling back to a first-feasible scan otherwise —
            # structurally no worse than the unseeded composition.  When
            # more than a quarter of the units go stale the seed is not
            # holding, so the attempt aborts instead of paying full scans
            # for a placement that has already diverged from the seed.
            ctx.check_deadline("seeded placement")
            rng = cfg.restart_rng(ii, -1)
            mrrg = ctx.new_mrrg(ii)
            mapping = Mapping(dfg, ii, arch=ctx.arch)
            stale_budget = max(2, len(base_units) // 4)
            ok = True
            for u in base_units:
                ctx.check_deadline("seeded unit placement")
                if placer.place_unit_seeded(mrrg, dfg, mapping, u, seed):
                    continue
                stale_budget -= 1
                if stale_budget < 0 or not placer.place_unit_feasible(
                        mrrg, dfg, mapping, u, rng, max_feasible=1):
                    ok = False
                    break
            if ok and placer.valid(dfg, mapping, mrrg):
                state.mrrg = mrrg
                state.mapping = mapping
                return CONTINUE
        for restart in range(cfg.restarts):
            ctx.check_deadline(f"placement restart {restart}")
            rng = cfg.restart_rng(ii, restart)
            units = list(base_units)
            if restart:
                # jitter: swap a few adjacent units (keeps topo-ish order)
                for _ in range(min(4, len(units) - 1)):
                    i = rng.randrange(len(units) - 1)
                    units[i], units[i + 1] = units[i + 1], units[i]
            mrrg = ctx.new_mrrg(ii)
            mapping = Mapping(dfg, ii, arch=ctx.arch)
            failed = None
            for u in units:
                ctx.check_deadline(f"unit placement (restart {restart})")
                if not placer.place_unit_feasible(mrrg, dfg, mapping, u, rng):
                    failed = u
                    break
            if failed is None and placer.valid(dfg, mapping, mrrg):
                state.mrrg = mrrg
                state.mapping = mapping
                return CONTINUE
        return FAIL


class OveruseNodeConstructionPass(MapperPass):
    """Overuse-tolerant greedy construction in topo order (the legacy
    PathFinder baseline's placement stage); any unplaceable node fails
    this II."""

    name = "place"

    def run(self, ctx: PassContext, state: MapState) -> str:
        placer = ctx.placer
        dfg = state.dfg
        state.mrrg = mrrg = ctx.new_mrrg(state.ii)
        state.mapping = mapping = Mapping(dfg, state.ii, arch=ctx.arch)
        for n in dfg.topo_order():
            if not placer.greedy_place_overuse(mrrg, dfg, mapping, n,
                                               state.rng):
                return FAIL
        return CONTINUE
