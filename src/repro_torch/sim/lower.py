"""Lower a :class:`~repro_torch.mapping.mapping.Mapping` into flat tensor form
(port of ``repro/sim/lower.py``; the ``repro.sim/compiled@1`` JSON schema is
unchanged, so forms stored by either package load in the other).

The scalar simulator (``repro_torch.core.simulate``) walks Python dicts cycle by
cycle.  Everything it consults is static per mapping, so it lowers into a
handful of flat integer/float arrays — a :class:`CompiledSim` — that a
vectorized backend (``repro_torch.sim.step``) can execute for a whole *batch* of
mappings per call:

* ``opcode``/``issue``/``exec_mask`` — one row per DFG node: which op fires
  at which issue cycle (modulo II).
* operand tables ``op_kind``/``op_src``/``op_dist``/``op_feed``/``op_steps``
  — per (node, operand-column) gather descriptors.  A column is *absent*
  (0), a *ref feed* from a const/input producer (1), a *routed read* (2)
  matched against the route-step table, or *broken* (3: an unrouted /
  empty-path edge, which must fail exactly when the scalar oracle's
  ``KeyError`` would fire).
* route-step table ``(step_edge, step_rid, step_src, step_abs)`` — one row
  per reserved routing-resource cycle; iteration ``k``'s value becomes
  readable at absolute cycle ``step_abs + k * ii``.
* ``ref`` — the DFG reference interpreter's value table, the oracle the
  final comparison (and const/input feeds) read from.

Semantics are **derived from, and checked against, the frozen scalar
oracle** — including its failure modes: a mapping the scalar simulator
rejects (missing value, unrouted edge, corrupted placement) must lower
into a form the batched backends reject too (see
``tests/test_torch_sim.py``).

The few mapping shapes whose scalar semantics are value-dependent — two
in-edges sharing one operand slot, where the scalar ``ops.sort()`` order
depends on runtime values — raise :class:`LoweringUnsupported`;
``simulate_batch`` routes those mappings through the scalar oracle itself,
so the parity guarantee is preserved rather than approximated.

``CompiledSim`` round-trips through JSON (:meth:`CompiledSim.to_json` /
:meth:`CompiledSim.from_json`) so lowered forms can ride inside artifacts
or be shipped to a remote verify tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

#: fixed opcode numbering shared by every backend (index into this tuple)
OPS = (
    "const", "input", "load", "store", "output",
    "add", "sub", "mul", "mac", "shl", "shr",
    "and", "or", "xor", "not", "min", "max", "abs", "cmp", "select",
)
OP_INDEX = {op: i for i, op in enumerate(OPS)}

#: operand-column kinds
K_ABSENT = 0   # no edge: operand is 0.0
K_FEED = 1     # const/input producer: value is op_feed + iter (ref oracle)
K_ROUTED = 2   # routed edge: gather from the route-step availability table
K_BROKEN = 3   # unrouted / empty-path edge: fails when exercised


class LoweringUnsupported(ValueError):
    """This mapping's scalar semantics cannot be expressed in the flat
    form (e.g. duplicate operand slots make the scalar operand order
    value-dependent); callers fall back to the scalar oracle."""


@dataclass
class CompiledSim:
    """One mapping in flat tensor form (unpadded; see module docstring)."""

    ii: int
    horizon: int
    iterations: int
    node_ids: List[int]                       # row -> DFG node id
    opcode: np.ndarray                        # (N,) int32, index into OPS
    exec_mask: np.ndarray                     # (N,) bool: has an issue slot
    issue: np.ndarray                         # (N,) int32
    compare: np.ndarray                       # (N,) bool: final ref check
    leaf_base: np.ndarray                     # (N,) f64: leaf op base value
    op_kind: np.ndarray                       # (N,K) int8
    op_src: np.ndarray                        # (N,K) int32 row, -1 = none
    op_dist: np.ndarray                       # (N,K) int32 edge distance
    op_feed: np.ndarray                       # (N,K) f64 feed base (K_FEED)
    op_steps: np.ndarray                      # (N,K,M) int32 step idx, -1 pad
    step_edge: np.ndarray                     # (S,) int32 edge index
    step_rid: np.ndarray                      # (S,) int32 routing resource
    step_src: np.ndarray                      # (S,) int32 producer row
    step_abs: np.ndarray                      # (S,) int32 absolute cycle (k=0)
    ref: np.ndarray                           # (N,I) f64 oracle values
    fail_static: Optional[str] = None         # lowering-detected scalar fail

    # -- shape views -------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def n_steps(self) -> int:
        return int(self.step_src.shape[0])

    @property
    def n_operands(self) -> int:
        return int(self.op_kind.shape[1])

    @property
    def n_matches(self) -> int:
        return int(self.op_steps.shape[2])

    # -- JSON round-trip ---------------------------------------------------
    _INT_FIELDS = ("opcode", "issue", "op_src", "op_dist", "op_steps",
                   "step_edge", "step_rid", "step_src", "step_abs")
    _BOOL_FIELDS = ("exec_mask", "compare")
    _F64_FIELDS = ("leaf_base", "op_feed", "ref")

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "schema": "repro.sim/compiled@1",
            "ii": self.ii,
            "horizon": self.horizon,
            "iterations": self.iterations,
            "node_ids": list(map(int, self.node_ids)),
            "fail_static": self.fail_static,
            "op_kind": self.op_kind.tolist(),
        }
        for f in self._INT_FIELDS + self._BOOL_FIELDS + self._F64_FIELDS:
            out[f] = getattr(self, f).tolist()
        return out

    @classmethod
    def from_json(cls, data: Dict[str, object]) -> "CompiledSim":
        if data.get("schema") != "repro.sim/compiled@1":
            raise ValueError(
                f"not a repro.sim/compiled@1 record: {data.get('schema')!r}")
        kw = {
            "ii": int(data["ii"]),
            "horizon": int(data["horizon"]),
            "iterations": int(data["iterations"]),
            "node_ids": [int(n) for n in data["node_ids"]],
            "fail_static": data.get("fail_static"),
            "op_kind": np.asarray(data["op_kind"], dtype=np.int8),
        }
        n = len(kw["node_ids"])
        k = kw["op_kind"].shape[1] if kw["op_kind"].size else 3
        kw["op_kind"] = kw["op_kind"].reshape(n, k)
        shapes = {
            "opcode": (n,), "issue": (n,), "exec_mask": (n,),
            "compare": (n,), "leaf_base": (n,),
            "op_src": (n, k), "op_dist": (n, k), "op_feed": (n, k),
        }
        for f, dt in ((f, np.int32) for f in cls._INT_FIELDS):
            arr = np.asarray(data[f], dtype=dt)
            kw[f] = arr.reshape(shapes[f]) if f in shapes else arr
        for f in cls._BOOL_FIELDS:
            kw[f] = np.asarray(data[f], dtype=bool).reshape(shapes[f])
        for f in cls._F64_FIELDS:
            arr = np.asarray(data[f], dtype=np.float64)
            kw[f] = arr.reshape(shapes[f]) if f in shapes else arr
        kw["op_steps"] = kw["op_steps"].reshape(n, k, -1) if n else \
            kw["op_steps"].reshape(0, k, 1)
        kw["ref"] = kw["ref"].reshape(n, kw["iterations"])
        return cls(**kw)


def lower_mapping(mapping, iterations: int = 4) -> CompiledSim:
    """Lower one validated mapping (see module docstring).  Raises
    :class:`LoweringUnsupported` for shapes whose scalar semantics are
    value-dependent; any *structural* corruption the scalar oracle would
    reject is instead recorded (``fail_static`` or a K_BROKEN column) so
    the batched verdict fails exactly where the scalar one does."""
    dfg, ii = mapping.dfg, mapping.ii
    node_ids = sorted(dfg.nodes)
    row = {nid: i for i, nid in enumerate(node_ids)}
    n = len(node_ids)
    horizon = mapping.makespan + ii * iterations + 2

    for idx, e in enumerate(dfg.edges):
        if e.distance < 0:
            # the batched forms assume dist >= 0 (want_it <= it <
            # iterations); a DFG never produces this, but a hand-corrupted
            # one could — and dfg.eval below would crash on it, so the
            # check must come first
            raise LoweringUnsupported(
                f"edge {idx}: negative distance {e.distance}")

    fail_static: Optional[str] = None
    for nid in mapping.place:
        if nid not in dfg.nodes:
            fail_static = f"place references unknown node {nid}"
    for nid, t_n in mapping.time.items():
        if nid not in dfg.nodes and t_n < horizon:
            fail_static = f"issue slot for unknown node {nid}"

    opcode = np.zeros(n, dtype=np.int32)
    exec_mask = np.zeros(n, dtype=bool)
    issue = np.zeros(n, dtype=np.int32)
    compare = np.zeros(n, dtype=bool)
    leaf_base = np.zeros(n, dtype=np.float64)
    for nid in node_ids:
        r = row[nid]
        op = dfg.nodes[nid].op
        opcode[r] = OP_INDEX[op]
        if nid in mapping.time:
            exec_mask[r] = True
            issue[r] = mapping.time[nid]
        if nid in mapping.place and op not in ("const", "input"):
            compare[r] = True
        if op in ("const", "input", "load"):
            # dfg.eval leaf default: it + 1 + nid % 5 (verification always
            # runs with empty inputs, so the closed form is exact)
            leaf_base[r] = 1.0 + nid % 5

    ref_hist = dfg.eval({}, iterations)
    ref = np.zeros((n, iterations), dtype=np.float64)
    for nid in node_ids:
        ref[row[nid], :] = ref_hist[nid]

    # -- route-step table --------------------------------------------------
    step_edge: List[int] = []
    step_rid: List[int] = []
    step_src: List[int] = []
    step_abs: List[int] = []
    for idx, e in enumerate(dfg.edges):
        if idx not in mapping.routes:
            continue
        if e.src not in mapping.time:
            # the scalar oracle's route build does mapping.time[e.src]
            # before the first cycle: KeyError, whole-sim fail
            fail_static = (fail_static
                           or f"routed edge {idx} source {e.src} has no "
                              "issue time")
            continue
        for rid, t_route in mapping.routes[idx]:
            step_edge.append(idx)
            step_rid.append(int(rid))
            step_src.append(row[e.src])
            step_abs.append(int(t_route))

    # -- operand tables ----------------------------------------------------
    in_edges: Dict[int, List] = {}
    for idx, e in enumerate(dfg.edges):
        if e.dst in row:
            in_edges.setdefault(e.dst, []).append((e.operand, idx, e))
    k_cols = max([3] + [len(v) for v in in_edges.values()])

    op_kind = np.zeros((n, k_cols), dtype=np.int8)
    op_src = np.full((n, k_cols), -1, dtype=np.int32)
    op_dist = np.zeros((n, k_cols), dtype=np.int32)
    op_feed = np.zeros((n, k_cols), dtype=np.float64)
    matches: Dict[tuple, List[int]] = {}
    for s, (rid, src_r) in enumerate(zip(step_rid, step_src)):
        matches.setdefault((rid, src_r), []).append(s)

    col_steps: Dict[tuple, List[int]] = {}
    for nid, edges in in_edges.items():
        slots = [slot for slot, _, _ in edges]
        if len(set(slots)) != len(slots):
            # scalar ops.sort() on (slot, value) — order depends on runtime
            # values when slots collide; not expressible statically
            raise LoweringUnsupported(
                f"node {nid}: duplicate operand slots {sorted(slots)}")
        edges.sort(key=lambda t: t[0])
        r = row[nid]
        for col, (_slot, idx, e) in enumerate(edges):
            if dfg.nodes[e.src].op in ("const", "input"):
                op_kind[r, col] = K_FEED
                op_feed[r, col] = 1.0 + e.src % 5
                continue
            op_dist[r, col] = e.distance
            path = mapping.routes.get(idx)
            if not path:  # unrouted or empty path: scalar Key/IndexError
                op_kind[r, col] = K_BROKEN
                continue
            op_kind[r, col] = K_ROUTED
            op_src[r, col] = row[e.src]
            # readable steps: every reservation of this net on the same
            # final resource the scalar read consults (rid, net) —
            # including reservations made by sibling fanout edges
            rid_last = int(path[-1][0])
            col_steps[(r, col)] = matches.get((rid_last, row[e.src]), [])

    m_cols = max([1] + [len(v) for v in col_steps.values()])
    op_steps = np.full((n, k_cols, m_cols), -1, dtype=np.int32)
    for (r, col), idxs in col_steps.items():
        op_steps[r, col, :len(idxs)] = idxs

    return CompiledSim(
        ii=int(ii),
        horizon=int(horizon),
        iterations=int(iterations),
        node_ids=node_ids,
        opcode=opcode,
        exec_mask=exec_mask,
        issue=issue,
        compare=compare,
        leaf_base=leaf_base,
        op_kind=op_kind,
        op_src=op_src,
        op_dist=op_dist,
        op_feed=op_feed,
        op_steps=op_steps,
        step_edge=np.asarray(step_edge, dtype=np.int32),
        step_rid=np.asarray(step_rid, dtype=np.int32),
        step_src=np.asarray(step_src, dtype=np.int32),
        step_abs=np.asarray(step_abs, dtype=np.int32),
        ref=ref,
        fail_static=fail_static,
    )
