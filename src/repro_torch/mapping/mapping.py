"""Mapping state shared by all passes (layer 1 of :mod:`repro_torch.mapping`;
port of ``repro/mapping/mapping.py`` and the record side of
``repro/compiler/artifact.py``).

:class:`Mapping` carries placement, schedule and routes over one DFG at
one II on one fabric — the artifact a pass pipeline produces and
everything the simulators read — and the structural validator
:meth:`Mapping.validate`, line for line the JAX package's, which every
mapper runs before handing a mapping out.  :func:`mapping_from_record`
rebuilds a record against its architecture and validates it before
anything simulates: placement legality, FU conflicts, route timing, read
ports and routing-node capacity are invisible to a simulation.
:class:`DfgTables` are the per-DFG adjacency tables the routing and
placement passes share, and :class:`MapperStats` is the accounting object
a pipeline exposes to :mod:`repro_torch.compiler` (router wall time,
route-cache counters, and the uniform per-pass timing/counter schema).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.arch import Arch, make_arch
from repro_torch.core.dfg import DFG
from repro_torch.core.routing import RouteCache
from repro_torch.mapping.mrrg import RouteStats


def normalize_record(rec: Dict[str, object]) -> Dict[str, object]:
    """Coerce a JSON-decoded mapping record back to canonical in-memory
    form (string keys -> ints, route steps as 2-lists), so that a
    load -> dump round-trip is value-identical to :func:`mapping_to_record`
    output and ``mappings_sha256`` digests bind.

    ``ii``/``makespan`` may be ``null`` (the mapper found no mapping or an
    analytic spatial segment): the record still loads — only
    :meth:`Mapping.from_record` refuses it."""
    ii = rec.get("ii")
    makespan = rec.get("makespan")
    return {
        "dfg": rec["dfg"],
        "ii": None if ii is None else int(ii),
        "makespan": None if makespan is None else int(makespan),
        "place": {int(n): int(fu) for n, fu in rec["place"].items()},
        "time": {int(n): int(t) for n, t in rec["time"].items()},
        "routes": {
            int(idx): [[int(rid), int(t)] for rid, t in path]
            for idx, path in rec["routes"].items()
        },
    }


@dataclass
class Mapping:
    dfg: DFG
    ii: int
    place: Dict[int, int] = field(default_factory=dict)  # node -> fu
    time: Dict[int, int] = field(default_factory=dict)  # node -> abs cycle
    routes: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)  # edge idx
    #: the fabric the mapping is placed on; ``validate`` needs it, the
    #: simulators do not
    arch: Optional[Arch] = None
    #: sum(len(p) for p in routes.values()), kept incrementally by the
    #: mappers through set_route / pop_route
    route_len: int = 0

    def set_route(self, idx: int, path: List[Tuple[int, int]]) -> None:
        old = self.routes.get(idx)
        if old is not None:
            self.route_len -= len(old)
        self.routes[idx] = path
        self.route_len += len(path)

    def pop_route(self, idx: int) -> List[Tuple[int, int]]:
        path = self.routes.pop(idx)
        self.route_len -= len(path)
        return path

    @property
    def makespan(self) -> int:
        return (max(self.time.values()) + 1) if self.time else 0

    def cycles(self, iterations: int) -> int:
        return self.ii * (iterations - 1) + self.makespan

    @classmethod
    def from_record(cls, rec: Dict[str, object],
                    arch_name: Optional[str] = None) -> "Mapping":
        """Rebuild from an artifact's mapping record on the fabric
        ``arch_name`` (none when omitted), without place & route and
        without validation (:func:`mapping_from_record` validates)."""
        rec = normalize_record(rec)
        if rec["ii"] is None:
            raise ValueError(
                "mapping record has ii=null (no mapping found); nothing to "
                "rebuild"
            )
        dfg = DFG.from_json(rec["dfg"])
        m = cls(
            dfg=dfg,
            ii=rec["ii"],
            arch=None if arch_name is None else make_arch(arch_name),
            place=dict(rec["place"]),
            time=dict(rec["time"]),
        )
        for idx, path in rec["routes"].items():
            m.set_route(idx, [(rid, t) for rid, t in path])
        return m

    def validate(self) -> None:
        dfg, arch = self.dfg, self.arch
        need = {
            n for n, node in dfg.nodes.items() if node.op not in ("const", "input")
        }
        assert need <= set(self.place), "not all executable nodes placed"
        busy: Dict[Tuple[int, int], int] = {}
        for n, fu in self.place.items():
            t = self.time[n]
            op = dfg.nodes[n].op
            fu_obj = arch.fus[fu]
            exe_ops = fu_obj.ops
            if op not in ("const", "input", "output"):
                assert op in exe_ops, (n, op, fu_obj.kind)
            key = (fu, t % self.ii)
            assert key not in busy, f"FU conflict {key}: {busy[key]} vs {n}"
            busy[key] = n
        # route presence + timing for all intra edges between executable nodes
        res_occ: Dict[Tuple[int, int], Set[Tuple[int, int]]] = {}
        for idx, e in enumerate(dfg.edges):
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            t_dst = self.time[e.dst] + e.distance * self.ii
            t_src = self.time[e.src]
            assert t_dst > t_src, f"edge {e} not causal"
            path = self.routes.get(idx)
            assert path is not None, f"edge {idx} unrouted"
            assert path[-1][1] == t_dst, (idx, path[-1], t_dst)
            assert path[-1][0] in self.arch.fus[self.place[e.dst]].reads
            for rid, t in path:
                # distinct VALUES (net, abs cycle) per modulo slot
                res_occ.setdefault((rid, t % self.ii), set()).add((e.src, t))
        for (rid, c), nets in res_occ.items():
            assert len(nets) <= self.arch.rnodes[rid].cap, (
                f"overuse at {(rid, c)}: {nets}"
            )


class DfgTables:
    """Per-DFG adjacency tables shared by all mapper passes (computed once,
    reused by every incremental rip-up/reroute and delta-cost evaluation)."""

    def __init__(self, dfg: DFG):
        self.asap = dfg.asap()
        self.edges_by_node: Dict[int, List[int]] = {}
        self.intra_by_node: Dict[int, List[int]] = {}
        self.intra_preds: Dict[int, List[int]] = {}
        self.routable: List[Tuple[int, int, int]] = []  # (idx, src, dst)
        for idx, e in enumerate(dfg.edges):
            self.edges_by_node.setdefault(e.src, []).append(idx)
            if e.dst != e.src:
                self.edges_by_node.setdefault(e.dst, []).append(idx)
            if dfg.nodes[e.src].op not in ("const", "input"):
                self.routable.append((idx, e.src, e.dst))
            if e.distance == 0:
                self.intra_by_node.setdefault(e.src, []).append(idx)
                if e.dst != e.src:
                    self.intra_by_node.setdefault(e.dst, []).append(idx)
                self.intra_preds.setdefault(e.dst, []).append(e.src)
        self.n_routable = len(self.routable)


class MapperStats:
    """Place/route/negotiate + per-pass accounting a mapper exposes to the
    pipeline.

    ``route`` is shared with every MRRG the mapper creates; cache counters
    are absorbed from retired :class:`~repro_torch.core.routing.RouteCache`
    instances (one per DFG) plus the live one at snapshot time.  ``passes``
    is the uniform per-pass schema: every pass of the pipeline ticks its
    wall time and invocation count here (accumulated across II attempts and
    restarts), and :meth:`snapshot` reports them in first-ticked order so
    the artifact records the pipeline's actual stage sequence.
    """

    def __init__(self):
        self.route = RouteStats()
        self.negotiate_s = 0.0
        self.passes: Dict[str, Dict[str, float]] = {}  # insertion-ordered
        self._cache_base: Dict[str, int] = {
            "hits_exact": 0, "hits_scoped": 0, "misses": 0, "evictions": 0,
        }

    def tick_pass(self, name: str, wall_s: float, **counters: int):
        """Accumulate one pass invocation (wall seconds + counters)."""
        row = self.passes.get(name)
        if row is None:
            row = self.passes[name] = {"wall_s": 0.0, "calls": 0}
        row["wall_s"] += wall_s
        row["calls"] += 1
        for k, v in counters.items():
            row[k] = row.get(k, 0) + v

    def absorb_cache(self, cache: Optional[RouteCache]):
        if cache is None:
            return
        b = self._cache_base
        b["hits_exact"] += cache.hits_exact
        b["hits_scoped"] += cache.hits_scoped
        b["misses"] += cache.misses
        b["evictions"] += cache.evictions

    def snapshot(self, live_cache: Optional[RouteCache]) -> Dict[str, object]:
        c = dict(self._cache_base)
        if live_cache is not None:
            for k in c:
                c[k] += getattr(live_cache, k)
        lookups = c["hits_exact"] + c["hits_scoped"] + c["misses"]
        r = self.route
        cache = {
            **c,
            "hit_rate": (
                round((c["hits_exact"] + c["hits_scoped"]) / lookups, 4)
                if lookups else 0.0
            ),
            # fan-out batching counters (passes.route.FanoutSession): they
            # ride in the route_cache dict so they reach CompileResult /
            # `plaid-compile inspect` through the existing artifact field
            "fanout": {
                "batches": r.fanout_batches,
                "edges": r.fanout_edges,
                "layers_built": r.layers_built,
                "layers_reused": r.layers_reused,
            },
        }
        return {
            "route_s": self.route.route_s,
            "negotiate_s": self.negotiate_s,
            "route_calls": self.route.calls,
            "route_cache": cache,
            "passes": [
                {"name": name, **{k: (round(v, 6) if k == "wall_s" else v)
                                  for k, v in row.items()}}
                for name, row in self.passes.items()
            ],
        }


def mapping_from_record(rec: Dict[str, object], arch_name: str) -> Mapping:
    """Rebuild a validated :class:`Mapping` from a record — no place &
    route runs; :meth:`Mapping.validate` re-checks every structural
    invariant (placement legality, route presence/timing, modulo-slot
    capacity) before the mapping is handed out."""
    m = Mapping.from_record(rec, arch_name)
    m.validate()
    return m


def mapping_to_record(mapping: Mapping) -> Dict[str, object]:
    """Serialize a :class:`Mapping` (with its DFG)."""
    return {
        "dfg": mapping.dfg.to_json(),
        "ii": mapping.ii,
        "makespan": mapping.makespan,
        "place": {int(n): int(fu) for n, fu in mapping.place.items()},
        "time": {int(n): int(t) for n, t in mapping.time.items()},
        "routes": {
            int(idx): [[int(rid), int(t)] for rid, t in path]
            for idx, path in mapping.routes.items()
        },
    }
