"""Motif/unit extraction passes (the paper's Algorithm 1 consumers).

Port of ``repro/mapping/passes/extract.py``, line for line,
over the port's own modules.

Turns a DFG into the schedulable :class:`Unit` list a placement pass works
over: motif-level units with the paper's flexible schedule templates (§5.2,
Fig. 11) for the hierarchical mapper, or one unit per executable node for
the node-level mappers (the Fig. 18 'generic mapper' delta).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from repro_torch.core.dfg import DFG
from repro_torch.mapping.passes.base import CONTINUE, MapperPass, MapState, PassContext


def motif_templates(kind: str) -> List[Dict[int, Tuple[int, int]]]:
    """Flexible schedule templates (§5.2): role -> (alu_slot, cycle_offset).

    Roles follow the Motif.nodes order. All 6 slot permutations are
    generated with minimal dependency-consistent offsets, plus a one-cycle
    stagger variant on a dependent node (the paper's explicit fan-out set
    contains exactly these shapes).
    """
    import itertools

    if kind == "fanout":  # n0 -> n1, n0 -> n2
        deps = {1: [0], 2: [0]}
    elif kind == "fanin":  # n0 -> n1 <- n2
        deps = {1: [0, 2]}
    elif kind == "unicast":  # n0 -> n1 -> n2
        deps = {1: [0], 2: [1]}
    else:
        return [{0: (0, 0)}]
    out = []
    seen = set()
    def depth(role):
        ds = deps.get(role, [])
        return 0 if not ds else 1 + max(depth(d) for d in ds)

    role_order = sorted(range(3), key=depth)
    for perm in itertools.permutations(range(3)):  # role i -> slot perm[i]
        base = {}
        for role in role_order:
            off = 0
            for d in deps.get(role, []):
                off = max(off, base[d][1] + 1)
            base[role] = (perm[role], off)
        variants = [base]
        # stagger: push one dependent role a cycle later
        for role in deps:
            v = dict(base)
            slot, off = v[role]
            v[role] = (slot, off + 1)
            # re-propagate to roles depending on `role`
            for r2, ds in deps.items():
                if role in ds:
                    s2, o2 = v[r2]
                    v[r2] = (s2, max(o2, v[role][1] + 1))
            variants.append(v)
        for v in variants:
            key = tuple(sorted(v.items()))
            if key not in seen:
                seen.add(key)
                out.append(v)
    return out


@dataclass
class Unit:
    """One schedulable unit of the hierarchical DFG: a motif or a single."""
    kind: str  # motif kind or 'single'
    nodes: Tuple[int, ...]


def hierarchical_units(ctx: PassContext, dfg: DFG, motif_seed: int) -> List[Unit]:
    """Motif-level unit decomposition in data-dependency order (the unit
    list Algorithm 2 walks): strict-feasibility motifs + standalone compute
    + non-compute executable nodes, topologically sorted over the unit
    graph (Kahn with min-ASAP tie-break; cycles broken by ASAP)."""
    from repro_torch.core.motifs import generate_motifs

    motifs, standalone = generate_motifs(
        dfg, seed=motif_seed, feasibility="strict"
    )
    units = [Unit(m.kind, m.nodes) for m in motifs]
    units += [Unit("single", (n,)) for n in standalone]
    units += [
        Unit("single", (n.id,))
        for n in dfg.nodes.values()
        if not n.is_compute and n.op not in ("const", "input")
    ]
    # consts/inputs are immediate fields in the consumer's instruction
    # (8-bit constant fields, §4.3) — they occupy no FU and no route
    # sort by data dependency: topological over the unit graph where
    # possible (Kahn with min-ASAP tie-break; cycles broken by ASAP)
    asap = ctx.tables(dfg).asap
    owner = {n: i for i, u in enumerate(units) for n in u.nodes}
    deps: Dict[int, Set[int]] = {i: set() for i in range(len(units))}
    for e in dfg.intra_edges():
        if e.src not in owner or e.dst not in owner:
            continue  # const/input edges: immediates, no scheduling dep
        a, b = owner[e.src], owner[e.dst]
        if a != b:
            deps[b].add(a)
    done: Set[int] = set()
    order: List[int] = []
    key = lambda i: (min(asap[n] for n in units[i].nodes), units[i].nodes)
    while len(order) < len(units):
        ready = [i for i in range(len(units)) if i not in done and deps[i] <= done]
        if not ready:  # cycle among units: pick the lowest-ASAP one
            ready = [min((i for i in range(len(units)) if i not in done), key=key)]
        ready.sort(key=key)
        order.append(ready[0])
        done.add(ready[0])
    return [units[i] for i in order]


def node_units(dfg: DFG) -> List[Unit]:
    """Node-level decomposition: every unit is a single executable node (no
    motif knowledge) in (ASAP, id) order — the Fig. 18 generic mapper."""
    asap = dfg.asap()
    units = [
        Unit("single", (n,)) for n, node in dfg.nodes.items()
        if node.op not in ("const", "input")
    ]
    units.sort(key=lambda u: (asap[u.nodes[0]], u.nodes))
    return units


class UnitExtractionPass(MapperPass):
    """Populate ``state.units`` from the mapper's (cached) unit
    decomposition.  The decomposition is deterministic per (mapper, DFG),
    so the context caches it across II attempts and restarts."""

    name = "extract"

    def run(self, ctx: PassContext, state: MapState) -> str:
        state.units = ctx.units_for(state.dfg)
        return CONTINUE
