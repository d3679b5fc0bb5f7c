"""Dataflow-graph IR (port of the parts of ``repro/core/dfg.py`` that
verification, the motif pass and the Track-A tie of the PCU kernel need:
construction, the JSON form, the views the motif extractor reads, ASAP
levels, the topological order and the reference interpreter).

A DFG node is one operation of the loop body (compute, load, store, or
constant); edges are data dependencies.  Recurrence edges carry an
inter-iteration ``distance`` (loop-carried dependency).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

COMPUTE_OPS = {
    "add", "sub", "mul", "shl", "shr", "and", "or", "xor", "not",
    "min", "max", "abs", "cmp", "select", "mac",
}
MEMORY_OPS = {"load", "store"}
MISC_OPS = {"const", "input", "output"}
ALL_OPS = COMPUTE_OPS | MEMORY_OPS | MISC_OPS


@dataclass
class Node:
    id: int
    op: str
    name: str = ""

    @property
    def is_compute(self) -> bool:
        return self.op in COMPUTE_OPS


@dataclass
class Edge:
    src: int
    dst: int
    distance: int = 0  # >0 = loop-carried (recurrence) dependency
    operand: int = 0  # operand slot at the consumer


class DFG:
    def __init__(self, name: str = "dfg"):
        self.name = name
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []
        self._next = 0

    # -- construction -----------------------------------------------------
    def add(self, op: str, name: str = "", inputs: Iterable[int] = ()) -> int:
        """A new node of ``op`` fed by ``inputs`` (operand slots 0, 1, ...
        in order); returns its id.  Ids count up from 0, or from one past
        the largest id of a graph read by :meth:`from_json`."""
        if op not in ALL_OPS:
            raise ValueError(f"unknown DFG op {op!r}")
        nid = self._next
        self._next += 1
        self.nodes[nid] = Node(nid, op, name or f"{op}{nid}")
        for slot, src in enumerate(inputs):
            self.connect(src, nid, operand=slot)
        return nid

    def connect(self, src: int, dst: int, distance: int = 0, operand: int = 0):
        assert src in self.nodes and dst in self.nodes
        self.edges.append(Edge(src, dst, distance, operand))

    # -- serialization -----------------------------------------------------
    def to_json(self) -> Dict[str, object]:
        """JSON-safe structural dump; exact inverse of :meth:`from_json`
        (node ids, edge order, and operand slots are all preserved, so a
        mapping's edge indices stay valid across a round-trip)."""
        return {
            "name": self.name,
            "nodes": [[n.id, n.op, n.name] for n in self.nodes.values()],
            "edges": [[e.src, e.dst, e.distance, e.operand] for e in self.edges],
        }

    @classmethod
    def from_json(cls, data: Dict[str, object]) -> "DFG":
        g = cls(data["name"])
        for nid, op, name in data["nodes"]:
            g.nodes[int(nid)] = Node(int(nid), op, name)
        g._next = 1 + max(g.nodes, default=-1)
        for src, dst, distance, operand in data["edges"]:
            g.connect(int(src), int(dst), int(distance), int(operand))
        return g

    # -- views ------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def compute_nodes(self) -> List[int]:
        return [n.id for n in self.nodes.values() if n.is_compute]

    def preds(self, nid: int, *, intra_only: bool = True) -> List[int]:
        return [e.src for e in self.edges
                if e.dst == nid and (e.distance == 0 or not intra_only)]

    def intra_edges(self) -> List[Edge]:
        return [e for e in self.edges if e.distance == 0]

    # -- analyses ----------------------------------------------------------
    def asap(self) -> Dict[int, int]:
        """ASAP levels over intra-iteration edges (unit latency)."""
        level: Dict[int, int] = {}
        for nid in self.topo_order():
            ps = self.preds(nid)
            level[nid] = 0 if not ps else 1 + max(level[p] for p in ps)
        return level

    def topo_order(self) -> List[int]:
        indeg = {n: 0 for n in self.nodes}
        for e in self.intra_edges():
            indeg[e.dst] += 1
        stack = sorted([n for n, d in indeg.items() if d == 0])
        out = []
        while stack:
            n = stack.pop(0)
            out.append(n)
            for e in self.intra_edges():
                if e.src == n:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        stack.append(e.dst)
        assert len(out) == len(self.nodes), "cycle in intra-iteration DFG"
        return out

    def eval(self, inputs: Dict[int, float], iterations: int = 1) -> Dict[int, List[float]]:
        """Reference interpreter (per-iteration; recurrences via distance).

        Returns per-node value history — the oracle the mapped-configuration
        simulator is checked against.
        """
        hist: Dict[int, List[float]] = {n: [] for n in self.nodes}
        order = self.topo_order()
        for it in range(iterations):
            vals: Dict[int, float] = {}
            for nid in order:
                node = self.nodes[nid]
                ops: List[Tuple[int, float]] = []
                for e in self.edges:
                    if e.dst != nid:
                        continue
                    if e.distance == 0:
                        ops.append((e.operand, vals[e.src]))
                    else:
                        past = it - e.distance
                        v = hist[e.src][past] if past >= 0 else 0.0
                        ops.append((e.operand, v))
                ops.sort()
                a = ops[0][1] if len(ops) > 0 else 0.0
                b = ops[1][1] if len(ops) > 1 else 0.0
                c = ops[2][1] if len(ops) > 2 else 0.0
                vals[nid] = _apply(node.op, a, b, c, inputs.get(nid, float(it + 1 + nid % 5)))
            for nid in order:
                hist[nid].append(vals[nid])
        return hist


def _apply(op: str, a: float, b: float, c: float, leaf: float) -> float:
    if op in ("input", "const", "load"):
        return leaf
    if op == "store" or op == "output":
        return a
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "mac":
        return a * b + c
    if op == "shl":
        return a * 2.0
    if op == "shr":
        return a / 2.0
    if op == "and":
        return float(int(a) & int(b))
    if op == "or":
        return float(int(a) | int(b))
    if op == "xor":
        return float(int(a) ^ int(b))
    if op == "not":
        return float(~int(a) & 0xFFFF)
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "abs":
        return abs(a)
    if op == "cmp":
        return float(a > b)
    if op == "select":
        return b if a != 0.0 else c
    raise ValueError(op)
