"""A stored mapping rebuilt for verification (port of the record side of
``repro/mapping/mapping.py`` and ``repro/compiler/artifact.py``).

:class:`Mapping` carries placement, schedule and routes over one DFG at
one II on one fabric — everything the simulators read — and the
structural validator :meth:`Mapping.validate`, line for line the JAX
package's.  :func:`mapping_from_record` rebuilds a record against its
architecture and validates it before anything simulates: placement
legality, FU conflicts, route timing, read ports and routing-node
capacity are invisible to a simulation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.arch import Arch, make_arch
from repro_torch.core.dfg import DFG


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
        return cls(
            dfg=dfg,
            ii=rec["ii"],
            arch=None if arch_name is None else make_arch(arch_name),
            place=dict(rec["place"]),
            time=dict(rec["time"]),
            routes={idx: [(rid, t) for rid, t in path]
                    for idx, path in rec["routes"].items()},
        )

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
