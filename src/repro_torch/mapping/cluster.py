"""Vectorized DFG clustering core (the global-placement tentpole's base
layer).

Port of ``repro/mapping/cluster.py``, line for line,
over the port's own modules.

Two consumers share this module:

* the global analytic placer
  (:mod:`repro_torch.mapping.passes.global_place`) clusters the DFG at the
  motif-unit level, relaxes a quadratic wirelength objective over the
  tile grid (:func:`relax_positions` on an :func:`affinity_matrix`), and
  legalizes the result onto FU×cycle slots;
* the spatial partitioner (:func:`repro_torch.core.spatial._partition`) packs
  recurrence-closed groups into segments with
  :func:`pack_segments` — decision-for-decision identical to the legacy
  pure-Python greedy (equivalence pinned by
  ``tests/test_spatial_partition.py``), but with the per-group cut/charge
  accounting done as flat numpy reductions instead of nested dict scans.

Everything here is deterministic: no RNG, no dict-order dependence
(iteration orders come from ``DFG.topo_order()`` / edge lists).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dfg import DFG

#: ops that never occupy an FU slot (immediates folded into consumers)
NONEXEC_OPS = ("const", "input")


class ClusterArrays:
    """Flat numpy view of a DFG's executable nodes.

    ``order`` is the executable topo order (consts/inputs dropped);
    every other array is indexed by position in ``order``:

    * ``pred_ptr``/``pred_val`` — CSR of *executable* intra predecessors,
      multiplicity preserved in edge order (one entry per intra edge, the
      way ``dfg.preds()`` counts them);
    * ``is_mem`` — load/store mask;
    * ``group`` — recurrence-closure representative (positions connected
      by a recurrence edge share one group and must stay atomic);
    * ``replicable`` — address-arithmetic chains that segments recompute
      instead of round-tripping through the SPM (exact fixpoint of the
      legacy ``_replicable`` recursion).
    """

    def __init__(self, dfg: DFG):
        self.dfg = dfg
        self.order: List[int] = [
            n for n in dfg.topo_order()
            if dfg.nodes[n].op not in NONEXEC_OPS
        ]
        self.index: Dict[int, int] = {n: i for i, n in enumerate(self.order)}
        n_exec = len(self.order)
        ptr = np.zeros(n_exec + 1, dtype=np.int64)
        val: List[int] = []
        for i, n in enumerate(self.order):
            for p in dfg.preds(n):
                j = self.index.get(p)
                if j is not None:
                    val.append(j)
            ptr[i + 1] = len(val)
        self.pred_ptr = ptr
        self.pred_val = np.asarray(val, dtype=np.int64)
        self.is_mem = np.asarray(
            [dfg.nodes[n].op in ("load", "store") for n in self.order],
            dtype=bool,
        )
        self.group = recurrence_groups(dfg, self.order, self.index)
        self.replicable = replicable_mask(dfg, self.order, self.index,
                                          self.pred_ptr, self.pred_val)


def recurrence_groups(dfg: DFG, order: List[int],
                      index: Dict[int, int]) -> np.ndarray:
    """Union-find over recurrence edges: position -> group representative.

    Produces the same partition as the legacy relabel loop in
    ``spatial._partition`` (representative identity differs, partition
    does not — only membership is ever compared)."""
    parent = np.arange(len(order), dtype=np.int64)

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = int(parent[a])
        return a

    for e in dfg.recurrence_edges():
        i, j = index.get(e.src), index.get(e.dst)
        if i is None or j is None:
            continue
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri
    return np.asarray([find(i) for i in range(len(order))], dtype=np.int64)


def replicable_mask(dfg: DFG, order: List[int], index: Dict[int, int],
                    pred_ptr: np.ndarray,
                    pred_val: np.ndarray) -> np.ndarray:
    """Vectorized fixpoint of the legacy ``_replicable`` recursion.

    A node is replicable iff it is pure compute, touches no recurrence
    edge, and every predecessor is replicable (consts/inputs are).  The
    intra-edge graph is acyclic, so the decreasing fixpoint below lands
    on the unique solution — identical to the memoized recursion."""
    n_exec = len(order)
    rec_nodes = set()
    for e in dfg.recurrence_edges():
        rec_nodes.add(e.src)
        rec_nodes.add(e.dst)
    cand = np.asarray(
        [dfg.nodes[n].is_compute and n not in rec_nodes for n in order],
        dtype=bool,
    )
    repl = cand.copy()
    if pred_val.size == 0:
        return repl
    has_preds = pred_ptr[:-1] < pred_ptr[1:]
    starts = pred_ptr[:-1][has_preds]
    while True:
        preds_ok = np.ones(n_exec, dtype=bool)
        preds_ok[has_preds] = np.minimum.reduceat(
            repl[pred_val].astype(np.int8), starts
        ).astype(bool)
        new = cand & preds_ok
        if np.array_equal(new, repl):
            return repl
        repl = new


def pack_segments(dfg: DFG, max_nodes: int, mem_cap: int = 3,
                  arrays: Optional[ClusterArrays] = None
                  ) -> Optional[List[List[int]]]:
    """Producer-following segment packing on :class:`ClusterArrays`.

    Decision-for-decision identical to the legacy ``spatial._partition``
    greedy: recurrence-closed groups are placed atomically into the
    lowest-indexed segment (at or past their producers' latest segment)
    that respects the node cap, the per-segment memory-op cap including
    the cut loads the move would add, and the hard 4-mem-PE limit on
    every producer segment a new cut store would charge.  Returns the
    non-empty segments (lists of node ids) or ``None`` when some group
    fits nowhere (callers retry with smaller caps)."""
    ca = arrays if arrays is not None else ClusterArrays(dfg)
    order = ca.order
    n_exec = len(order)
    if n_exec == 0:
        return []
    members: Dict[int, List[int]] = {}
    for i in range(n_exec):
        members.setdefault(int(ca.group[i]), []).append(i)
    pp, pv = ca.pred_ptr, ca.pred_val
    repl, is_mem = ca.replicable, ca.is_mem
    seg_of = np.full(n_exec, -1, dtype=np.int64)
    stored = np.zeros(n_exec, dtype=bool)
    done = np.zeros(n_exec, dtype=bool)
    segs: List[List[int]] = []
    seg_len: List[int] = []
    mem_count: List[int] = []
    for i in range(n_exec):
        if done[i]:
            continue
        grp = members[int(ca.group[i])]
        garr = np.asarray(grp, dtype=np.int64)
        grp_mem = int(is_mem[garr].sum())
        # multiset of executable intra preds over the group (one entry per
        # edge — duplicate edges count twice, exactly as the legacy nested
        # loops counted them)
        preds = (np.concatenate([pv[pp[g]:pp[g + 1]] for g in grp])
                 if grp else np.zeros(0, dtype=np.int64))
        placed_preds = preds[seg_of[preds] >= 0]
        min_seg = int(seg_of[placed_preds].max()) if placed_preds.size else 0
        cut_preds = placed_preds[~repl[placed_preds]]
        n_segs = len(segs)
        total_cut = int(cut_preds.size)
        mc = np.asarray(mem_count, dtype=np.int64)
        sl = np.asarray(seg_len, dtype=np.int64)
        if n_segs:
            seg_cp = seg_of[cut_preds]
            cnt_same = np.bincount(seg_cp, minlength=n_segs)
            charges = np.bincount(seg_cp[~stored[cut_preds]],
                                  minlength=n_segs)
        else:
            cnt_same = charges = np.zeros(0, dtype=np.int64)
        # hard limit: a cut store charged to producer segment t must not
        # push t past the 4 mem PEs available at II=1 (only segments a new
        # store actually lands in are checked, as the legacy dict was)
        viol = ((mc + charges) > 4) & (charges > 0)
        n_viol = int(viol.sum())
        ok = (
            (sl + len(grp) <= max_nodes)
            & (mc + grp_mem + (total_cut - cnt_same) <= mem_cap)
            & ((n_viol - viol.astype(np.int64)) == 0)
        )
        if min_seg:
            ok[:min_seg] = False
        cand = np.flatnonzero(ok)
        if cand.size:
            si = int(cand[0])
            cut_loads = total_cut - int(cnt_same[si])
        else:
            # open a new segment (the legacy loop's trailing slot): every
            # non-replicable placed pred becomes a cut load, every unstored
            # one charges its producer segment
            if not (len(grp) <= max_nodes
                    and grp_mem + total_cut <= mem_cap
                    and n_viol == 0):
                return None
            si = n_segs
            segs.append([])
            seg_len.append(0)
            mem_count.append(0)
            cut_loads = total_cut
        segs[si].extend(order[g] for g in grp)
        seg_len[si] += len(grp)
        mem_count[si] += grp_mem + cut_loads
        for t in np.flatnonzero(charges):
            if int(t) != si:
                mem_count[int(t)] += int(charges[t])
        seg_of[garr] = si
        cross = placed_preds[seg_of[placed_preds] != si]
        stored[cross] = True
        done[garr] = True
    return [s for s in segs if s]


# ---------------------------------------------------------------------------
# Quadratic relaxation (the global placer's solver)
# ---------------------------------------------------------------------------


def affinity_matrix(dfg: DFG, owner: Dict[int, int], n: int) -> np.ndarray:
    """Symmetric cluster-affinity weights: ``W[a, b]`` counts the intra
    edges between cluster *a* and cluster *b* (one per edge, direction
    folded).  ``owner`` maps node id -> cluster index; nodes outside the
    map (consts/inputs) contribute nothing."""
    W = np.zeros((n, n), dtype=np.float64)
    rows: List[int] = []
    cols: List[int] = []
    for e in dfg.intra_edges():
        a, b = owner.get(e.src), owner.get(e.dst)
        if a is None or b is None or a == b:
            continue
        rows.append(a)
        cols.append(b)
    if rows:
        r = np.asarray(rows)
        c = np.asarray(cols)
        np.add.at(W, (r, c), 1.0)
        np.add.at(W, (c, r), 1.0)
    return W


def relax_positions(W: np.ndarray, pos0: np.ndarray,
                    extent: Tuple[float, float], anchor_w: float = 0.25,
                    iters: int = 32) -> np.ndarray:
    """Jacobi relaxation of the quadratic wirelength objective
    ``sum_ab W[a,b] * |P_a - P_b|^2  +  anchor_w * |P - pos0|^2``.

    Each sweep moves every cluster to the weighted centroid of its
    neighbours (plus its anchor), then rescales the cloud back to the
    grid extent — pure quadratic relaxation collapses to the centroid,
    and the min-max rescale is the standard cheap spreading force.
    Deterministic (fixed iteration count, no RNG)."""
    P = pos0.astype(np.float64).copy()
    if P.shape[0] <= 1:
        return P
    anchors = pos0.astype(np.float64)
    denom = W.sum(axis=1) + anchor_w
    denom = np.where(denom <= 0.0, 1.0, denom)
    for _ in range(iters):
        P = (W @ P + anchor_w * anchors) / denom[:, None]
        for d in (0, 1):
            lo = P[:, d].min()
            span = P[:, d].max() - lo
            if span > 1e-9 and extent[d] > 0:
                P[:, d] = (P[:, d] - lo) / span * extent[d]
    return P
