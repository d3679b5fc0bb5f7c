"""Time-extended modulo routing resource graph (layer 0 of `repro_torch.mapping`).

Port of ``repro/mapping/mrrg.py``, line for line,
over the port's own modules.

The MRRG is the shared mutable substrate every pass operates on: flat
per-slot occupancy/history arrays (``rid * ii + cyc``) with incrementally
maintained overuse counters, net-aware sharing semantics (same value =
same net at the same absolute cycle), and the zobrist state hashes the
route cache and the placement scan memo key on.

This module sits at the bottom of the package: it depends only on
:mod:`repro_torch.core.arch` and :mod:`repro_torch.core.routing`, never on passes or
mappers.
"""
from __future__ import annotations

import itertools as _itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import Arch, FU
from repro_torch.core.routing import engine_for, mix64

BIG = 1e9


@dataclass
class RouteStats:
    """Per-mapper router accounting (accumulated across every MRRG the
    mapper builds: all II attempts and restarts of one ``map()`` call)."""

    route_s: float = 0.0  # wall time inside route_edge (search + cache)
    calls: int = 0  # route_edge invocations
    # fan-out batching (passes.route.FanoutSession): queries grouped under a
    # shared producer context, and entry-cost layer vectors built vs served
    # from the session cache (reused across consumers and conflict retries)
    fanout_batches: int = 0
    fanout_edges: int = 0
    layers_built: int = 0
    layers_reused: int = 0


_MRRG_GEN = _itertools.count(1)


class MRRG:
    """Time-extended modulo routing resource graph.

    Occupancy and PathFinder history are flat arrays indexed
    ``rid * ii + (t % ii)``; the net-aware sharing semantics are unchanged:
    a modulo slot may be shared only by the SAME VALUE — the same net at the
    same absolute cycle.  The same net at a different absolute cycle on the
    same modulo slot is a different iteration's value: a collision, not a
    share.  Overuse is tracked incrementally (``_n_over``) so mappers can
    evaluate move acceptance via delta cost instead of re-scanning.

    Route-cache support: ``state_hash`` is an XOR-fold (:func:`mix64`) of
    every live (slot, net, abs-cycle) reservation, so reserve-then-release
    restores it exactly; ``slot_epoch``/``epoch`` record the last
    modification per slot for the scoped cache tier; ``hist_ver`` versions
    the PathFinder history array.
    """

    def __init__(self, arch: Arch, ii: int, stats: Optional[RouteStats] = None):
        self.arch = arch
        self.ii = ii
        self.engine = engine_for(arch)
        n = len(arch.rnodes)
        self.nslots = n * ii
        # per-slot distinct-value table {(net, abs_t): refcount}; None = free
        self.slot_vals: List[Optional[Dict[Tuple[int, int], int]]] = (
            [None] * self.nslots
        )
        self.occ_arr = np.zeros(self.nslots, dtype=np.int32)
        self.hist_arr = np.zeros(self.nslots, dtype=np.float64)
        self.cap_arr = np.repeat(
            np.asarray(self.engine.cap, dtype=np.int32), ii
        )
        # base routing cost per slot (1 + history), as a plain list for fast
        # scalar access in the router's inner loop plus a numpy mirror for
        # the array-DP core's per-layer cost vectors (kept bit-equal)
        self._base: List[float] = [1.0] * self.nslots
        self.base_arr = np.ones(self.nslots, dtype=np.float64)
        # live same-net reuse index: (net, abs_t) -> rids whose slot holds
        # that exact value, i.e. the slots a same-net search enters at the
        # 0.05 fan-out discount; maintained at the same 0->1 / 1->0
        # refcount transitions as ``state_hash``
        self.net_slots: Dict[Tuple[int, int], set] = {}
        self._n_over = 0  # slots currently over capacity
        self.fu_busy: Dict[Tuple[int, int], int] = {}  # (fu, cyc) -> node
        self.fu_load: Dict[int, int] = {}  # fu id -> scheduled ops
        self.tile_load: Dict[Tuple[int, int], int] = {}  # tile -> scheduled ops
        self.stats = stats if stats is not None else RouteStats()
        self.gen = next(_MRRG_GEN)  # scoped route-cache entries are per-MRRG
        self.state_hash = 0  # zobrist fold of live reservations
        self.place_hash = 0  # zobrist fold of (fu, abs cycle, node) claims
        self.hist_ver = 0  # bumped by bump_history
        self.epoch = 0  # monotone modification counter
        self.slot_epoch: List[int] = [0] * self.nslots  # last epoch per slot

    def cyc(self, t: int) -> int:
        return t % self.ii

    # -- FU slots ----------------------------------------------------------
    def fu_free(self, fu: int, t: int) -> bool:
        return (fu, t % self.ii) not in self.fu_busy

    def take_fu(self, fu: int, t: int, node: int):
        key = (fu, t % self.ii)
        assert key not in self.fu_busy, (key, node)
        self.fu_busy[key] = node
        self.fu_load[fu] = self.fu_load.get(fu, 0) + 1
        tile = self.arch.fus[fu].tile
        self.tile_load[tile] = self.tile_load.get(tile, 0) + 1
        # absolute t (not the modulo cycle): placement scans key on it
        self.place_hash ^= mix64(fu, t, node)

    def free_fu(self, fu: int, t: int):
        node = self.fu_busy.pop((fu, t % self.ii), None)
        if node is not None:
            self.fu_load[fu] -= 1
            self.tile_load[self.arch.fus[fu].tile] -= 1
            self.place_hash ^= mix64(fu, t, node)

    # -- routing resources ---------------------------------------------------
    # The per-(slot, net) congestion cost — 0.05 for same-value reuse,
    # 1 + history, +8.0 per unit of overuse when allowed — lives inlined in
    # passes.route._route_edge_once (start layer and relaxation layer) and,
    # vectorized, in passes.route.FanoutSession (entry_layer/_entry_cost);
    # keep every copy in sync when changing the formula.

    def reserve(self, net: int, path: Sequence[Tuple[int, int]]):
        ii = self.ii
        sv = self.slot_vals
        cap = self.engine.cap
        ep = self.slot_epoch
        ns = self.net_slots
        self.epoch = e = self.epoch + 1
        h = self.state_hash
        for rid, t in path:
            k = rid * ii + t % ii
            ep[k] = e
            d = sv[k]
            if d is None:
                d = sv[k] = {}
            key = (net, t)
            if key in d:
                d[key] += 1
            else:
                d[key] = 1
                h ^= mix64(k, net, t)
                s = ns.get(key)
                if s is None:
                    ns[key] = {rid}
                else:
                    s.add(rid)
                l = len(d)
                self.occ_arr[k] = l
                if l == cap[rid] + 1:
                    self._n_over += 1
        self.state_hash = h

    def release(self, net: int, path: Sequence[Tuple[int, int]]):
        ii = self.ii
        sv = self.slot_vals
        cap = self.engine.cap
        ep = self.slot_epoch
        ns = self.net_slots
        self.epoch = e = self.epoch + 1
        h = self.state_hash
        for rid, t in path:
            k = rid * ii + t % ii
            d = sv[k]
            key = (net, t)
            if d is not None and key in d:
                ep[k] = e
                d[key] -= 1
                if d[key] <= 0:
                    del d[key]
                    h ^= mix64(k, net, t)
                    s = ns.get(key)
                    if s is not None:
                        s.discard(rid)
                        if not s:
                            del ns[key]
                    l = len(d)
                    self.occ_arr[k] = l
                    if l == cap[rid]:
                        self._n_over -= 1
                    if not d:
                        sv[k] = None
        self.state_hash = h

    def has_overuse(self) -> bool:
        return self._n_over > 0

    def overuse_count(self) -> int:
        return self._n_over

    def overused(self) -> List[Tuple[int, int]]:
        if not self._n_over:
            return []
        ii = self.ii
        ks = np.flatnonzero(self.occ_arr > self.cap_arr)
        return [(int(k) // ii, int(k) % ii) for k in ks]

    def bump_history(self, amount: float = 1.0):
        self.hist_ver += 1
        ks = np.flatnonzero(self.occ_arr > self.cap_arr)
        if len(ks):
            self.hist_arr[ks] += amount
            hist = self.hist_arr
            self.base_arr[ks] = 1.0 + hist[ks]
            base = self._base
            ep = self.slot_epoch
            self.epoch = e = self.epoch + 1
            for k in ks:
                base[k] = 1.0 + float(hist[k])
                ep[k] = e  # scoped cache: cost of paths through k changed


def start_resources(arch: Arch, fu: FU) -> List[int]:
    """Resources a value produced on ``fu`` reaches one cycle later."""
    out = [arch.fu_out[fu.id]]
    for r in arch.rnodes:
        if r.tile != fu.tile:
            continue
        if arch.kind == "plaid":
            if fu.kind == "alu" and r.kind == "lrouter":
                out.append(r.id)  # collective router collects ALU outputs
            if fu.kind == "alsu" and r.kind == "glink":
                out.append(r.id)
        else:
            if r.kind == "port":
                out.append(r.id)  # ST writes straight to port registers
    return out


def min_span(arch: Arch, src_fu: FU, dst_fu: FU) -> int:
    """Cheap lower bound on routing latency between two FUs (cycles)."""
    (x1, y1), (x2, y2) = src_fu.tile, dst_fu.tile
    d = abs(x1 - x2) + abs(y1 - y2)
    if arch.kind != "plaid":
        return max(d, 1)
    if d == 0:
        if src_fu.kind == "alsu" and dst_fu.kind == "alsu":
            return 1
        if src_fu.kind == "alu" and dst_fu.kind == "alu":
            return 1
        return 2
    # cross-PCU: out-reg (1) + d mesh hops + drop into lrouter/glink (1)
    return d + 2
