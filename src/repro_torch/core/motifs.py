"""Motif identification — Algorithm 1 of the paper (port of
``repro/core/motifs.py``, line for line: the same seeds give the same
motifs and standalone lists in both packages).

The three base 3-node motifs (§3.2, Fig. 7) over *compute* nodes:

  fan-out : E = {(n1,n2),(n1,n3)}
  fan-in  : E = {(n1,n2),(n3,n2)}
  unicast : E = {(n1,n2),(n2,n3)}   (sequential chain)

Algorithm 1: greedy initial cover, then iterate {randomly break one motif,
randomly sort standalone nodes, re-grow motifs from standalone nodes} while
the motif count increases, also stopping if motifs would outnumber the
standalone capacity (PCU utilization guard).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.dfg import DFG

MOTIF_KINDS = ("fanout", "fanin", "unicast")


@dataclass(frozen=True)
class Motif:
    kind: str  # fanout | fanin | unicast | single
    nodes: Tuple[int, ...]  # role order: see module docstring

    @property
    def internal_edges(self) -> Tuple[Tuple[int, int], ...]:
        n = self.nodes
        if self.kind == "fanout":
            return ((n[0], n[1]), (n[0], n[2]))
        if self.kind == "fanin":
            return ((n[0], n[1]), (n[2], n[1]))
        if self.kind == "unicast":
            return ((n[0], n[1]), (n[1], n[2]))
        return ()


def _adj(dfg: DFG, eligible: Set[int]):
    succ: Dict[int, Set[int]] = {n: set() for n in eligible}
    pred: Dict[int, Set[int]] = {n: set() for n in eligible}
    for e in dfg.intra_edges():
        if e.src in eligible and e.dst in eligible:
            succ[e.src].add(e.dst)
            pred[e.dst].add(e.src)
    return succ, pred


def _find_motif_with(
    n: int, succ, pred, free: Set[int], rng: random.Random,
    asap: Optional[Dict[int, int]] = None, max_span: int = 2, extra=None
) -> Optional[Motif]:
    """Find any base-motif pattern containing node ``n`` among free nodes.

    ``asap``/``max_span``: hardware-feasibility filter — a motif executes
    within a few cycles on one PCU (template offsets ≤ 3), so internal
    edges must be local in dependency depth. Deep-spanning patterns are
    structurally motifs but not collectively executable.
    """
    cands: List[Motif] = []
    fs = [s for s in succ[n] if s in free]
    fp = [p for p in pred[n] if p in free]
    # unicast with n as head: n -> a -> b
    for a in fs:
        for b in succ[a]:
            if b in free and b != n:
                cands.append(Motif("unicast", (n, a, b)))
    # unicast with n in middle: p -> n -> a
    for p in fp:
        for a in fs:
            if p != a:
                cands.append(Motif("unicast", (p, n, a)))
    # unicast with n as tail
    for p in fp:
        for pp in pred[p]:
            if pp in free and pp != n:
                cands.append(Motif("unicast", (pp, p, n)))
    # fan-out: n -> a, n -> b
    if len(fs) >= 2:
        for i in range(len(fs)):
            for j in range(i + 1, len(fs)):
                cands.append(Motif("fanout", (n, fs[i], fs[j])))
    # fan-out with n as a leaf: p -> n, p -> b
    for p in fp:
        for b in succ[p]:
            if b in free and b != n:
                cands.append(Motif("fanout", (p, n, b)))
    # fan-in: a -> n <- b
    if len(fp) >= 2:
        for i in range(len(fp)):
            for j in range(i + 1, len(fp)):
                cands.append(Motif("fanin", (fp[i], n, fp[j])))
    # fan-in with n as a source: n -> a <- b
    for a in fs:
        for b in pred[a]:
            if b in free and b != n:
                cands.append(Motif("fanin", (n, a, b)))
    if asap is not None:
        def ok(m: Motif) -> bool:
            for a, b in m.internal_edges:
                if asap[b] - asap[a] > max_span:
                    return False
            return max(asap[x] for x in m.nodes) - min(asap[x] for x in m.nodes) <= max_span + 1
        cands = [m for m in cands if ok(m)]
    if extra is not None:
        cands = [m for m in cands if extra(m)]
    if not cands:
        return None
    return rng.choice(cands)


def greedy_motifs(dfg: DFG, eligible: Set[int], rng: random.Random,
                  asap: Optional[Dict[int, int]] = None, extra=None) -> List[Motif]:
    succ, pred = _adj(dfg, eligible)
    free = set(eligible)
    motifs: List[Motif] = []
    for n in sorted(eligible):
        if n not in free:
            continue
        m = _find_motif_with(n, succ, pred, free, rng, asap, extra=extra)
        if m is not None and all(x in free for x in m.nodes):
            motifs.append(m)
            free -= set(m.nodes)
    return motifs


def _external_path_filter(dfg: DFG):
    """Reject motifs with a dependency path between members that runs
    through an external node: the collective schedule (offsets ≤ 3, one
    PCU) cannot wait for an external round-trip. The acyclic triangle
    (direct third edge inside the motif) remains allowed, as in §3.2."""
    succs: Dict[int, List[int]] = {}
    for e in dfg.intra_edges():
        succs.setdefault(e.src, []).append(e.dst)

    def ok(m: Motif) -> bool:
        members = set(m.nodes)
        for u in members:
            # DFS from u through external nodes only
            stack = [s for s in succs.get(u, []) if s not in members]
            seen = set(stack)
            while stack:
                x = stack.pop()
                for s2 in succs.get(x, []):
                    if s2 in members:
                        return False  # external path u -> ... -> member
                    if s2 not in seen:
                        seen.add(s2)
                        stack.append(s2)
        return True

    return ok


def generate_motifs(
    dfg: DFG, seed: int = 0, max_rounds: int = 60, compute_only: bool = True,
    feasibility: str = "none",
) -> Tuple[List[Motif], List[int]]:
    """Algorithm 1. Returns (motifs, standalone node ids).

    ``feasibility``: 'none' = pure Algorithm 1 (structural, used for the
    Table-2 coverage comparison); 'strict' = additionally enforce the PCU
    schedulability constraints (ASAP span + no external member-to-member
    paths) — what the hierarchical mapper consumes.
    """
    rng = random.Random(seed)
    eligible = set(dfg.compute_nodes if compute_only else dfg.nodes)
    succ, pred = _adj(dfg, eligible)
    asap = dfg.asap() if feasibility != "none" else None
    extra = _external_path_filter(dfg) if feasibility == "strict" else None

    motifs = greedy_motifs(dfg, eligible, rng, asap, extra)
    best = list(motifs)

    def standalone(ms: Sequence[Motif]) -> List[int]:
        used = {n for m in ms for n in m.nodes}
        return [n for n in sorted(eligible) if n not in used]

    rounds_without_gain = 0
    while rounds_without_gain < max_rounds:
        ms = list(best)
        if ms:
            ms.pop(rng.randrange(len(ms)))  # randomly break down one motif
        free_nodes = standalone(ms)
        rng.shuffle(free_nodes)  # randomly sort standalone nodes
        free = set(free_nodes)
        for n in free_nodes:
            if n not in free:
                continue
            m = _find_motif_with(n, succ, pred, free, rng, asap, extra=extra)
            if m is not None and all(x in free for x in m.nodes):
                ms.append(m)
                free -= set(m.nodes)
        if len(ms) > len(best):
            best = ms
            rounds_without_gain = 0
        else:
            rounds_without_gain += 1
        # utilization guard: motifs must not exceed standalone capacity need
        if len(standalone(best)) == 0:
            break
    return best, standalone(best)


def motif_cover_stats(dfg: DFG, motifs: Sequence[Motif]) -> Dict[str, int]:
    covered = {n for m in motifs for n in m.nodes}
    return {
        "n_nodes": dfg.n_nodes,
        "n_compute": len(dfg.compute_nodes),
        "covered": len(covered),
        "n_motifs": len(motifs),
        "fanout": sum(m.kind == "fanout" for m in motifs),
        "fanin": sum(m.kind == "fanin" for m in motifs),
        "unicast": sum(m.kind == "unicast" for m in motifs),
    }


def validate_cover(dfg: DFG, motifs: Sequence[Motif], standalone: Sequence[int]) -> None:
    """Invariants: disjoint, pattern edges exist, all compute nodes covered."""
    seen: Set[int] = set()
    edge_set = {(e.src, e.dst) for e in dfg.intra_edges()}
    for m in motifs:
        assert m.kind in MOTIF_KINDS, m
        assert len(set(m.nodes)) == 3, m
        for n in m.nodes:
            assert n not in seen, f"node {n} in two motifs"
            seen.add(n)
        for (a, b) in m.internal_edges:
            assert (a, b) in edge_set, f"missing edge {(a, b)} for {m}"
    for n in standalone:
        assert n not in seen
        seen.add(n)
    assert seen == set(dfg.compute_nodes), "cover misses compute nodes"
