"""Spatial-CGRA execution model (§6.3 baseline).

Port of ``repro/core/spatial.py``, line for line,
over the port's own modules.

A spatial CGRA freezes one configuration per code segment, so a mapping is
an II=1 modulo schedule where no resource is time-multiplexed (our MRRG at
II=1 enforces exactly that). Complex DFGs that do not fit are partitioned:
cut edges become store/load pairs through the SPM ("Additional loads and
stores are introduced during partition"), and each segment runs the full
trip count before the fabric is reconfigured.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.registry import register_mapper
from repro_torch.core.arch import Arch, make_arch
from repro_torch.core.dfg import DFG
from repro_torch.mapping import Mapping, NodeGreedyMapper
from repro_torch.mapping.cluster import pack_segments

RECONFIG_CYCLES = 16  # config-memory reload between segments


@dataclass
class SpatialResult:
    segments: List[Mapping]
    extra_mem_ops: int
    analytic_segments: int = 0  # fallback model (no routed mapping)
    analytic_depth: int = 0

    @property
    def n_segments(self) -> int:
        return self.analytic_segments or len(self.segments)

    def cycles(self, iterations: int) -> int:
        if self.analytic_segments:
            return self.analytic_segments * (
                iterations + self.analytic_depth + RECONFIG_CYCLES
            )
        total = 0
        for m in self.segments:
            total += iterations + m.makespan + RECONFIG_CYCLES
        return total


class SpatialMapper(NodeGreedyMapper):
    """NodeGreedyMapper pinned to II=1 (pure spatial dataflow)."""

    def map(self, dfg: DFG) -> Optional[Mapping]:
        return self.map_at_ii(dfg, 1)


def _partition(dfg: DFG, max_nodes: int, mem_cap: int = 3) -> Optional[List[List[int]]]:
    """Producer-following (vertical-slice) packing: each node goes into the
    latest segment that already holds its producers, if it has room — so
    load→mul→acc chains stay together and cut edges are rare. Memory ops
    per segment are bounded (4 mem PEs at II=1, slack left for cut pairs);
    recurrence-closed groups are atomic.

    Runs on the vectorized clustering core shared with the global analytic
    placer (:func:`repro_torch.mapping.cluster.pack_segments`); the pure-Python
    greedy is kept below as :func:`_partition_legacy` and the two are held
    decision-for-decision equivalent by ``tests/test_spatial_partition.py``.
    """
    return pack_segments(dfg, max_nodes, mem_cap)


def _partition_legacy(dfg: DFG, max_nodes: int,
                      mem_cap: int = 3) -> Optional[List[List[int]]]:
    """Reference implementation of :func:`_partition` (the pre-vectorized
    greedy), retained as the equivalence oracle."""
    asap = dfg.asap()
    order = [
        n for n in dfg.topo_order()
        if dfg.nodes[n].op not in ("const", "input")
    ]
    group_of = {n: n for n in order}
    for e in dfg.recurrence_edges():
        if e.src in group_of and e.dst in group_of:
            a, b = group_of[e.src], group_of[e.dst]
            for n, g in list(group_of.items()):
                if g == b:
                    group_of[n] = a
    is_mem = lambda n: dfg.nodes[n].op in ("load", "store")
    memo: Dict[int, bool] = {}
    segs: List[List[int]] = []
    mem_count: List[int] = []
    seg_of: Dict[int, int] = {}
    stored: Dict[int, bool] = {}
    seen = set()
    for n in order:
        grp = [m for m in order if group_of[m] == group_of[n] and m not in seen]
        if not grp:
            continue
        grp_mem = sum(1 for m in grp if is_mem(m))
        min_seg = 0
        for m in grp:
            for p_ in dfg.preds(m):
                if p_ in seg_of:
                    min_seg = max(min_seg, seg_of[p_])
        placed = False
        for si in list(range(min_seg, len(segs))) + [None]:
            if si is None:
                segs.append([])
                mem_count.append(0)
                si = len(segs) - 1
            # cut loads into si + cut stores charged to producer segments
            cut_loads = 0
            store_charge: Dict[int, int] = {}
            for m in grp:
                for p_ in dfg.preds(m):
                    if (
                        p_ in seg_of and seg_of[p_] != si
                        and not _replicable(dfg, p_, memo)
                    ):
                        cut_loads += 1
                        if not stored.get(p_):
                            store_charge[seg_of[p_]] = store_charge.get(seg_of[p_], 0) + 1
            ok = (
                len(segs[si]) + len(grp) <= max_nodes
                and mem_count[si] + grp_mem + cut_loads <= mem_cap
                and all(
                    mem_count[t] + c <= 4 for t, c in store_charge.items()
                )  # hard limit: 4 mem PEs at II=1
            )
            if ok:
                segs[si].extend(grp)
                mem_count[si] += grp_mem + cut_loads
                for t, c in store_charge.items():
                    mem_count[t] += c
                for m in grp:
                    seg_of[m] = si
                    for p_ in dfg.preds(m):
                        if p_ in seg_of and seg_of[p_] != si:
                            stored[p_] = True
                placed = True
                break
        if not placed:
            return None  # caller retries with smaller caps
        seen.update(grp)
    return [s for s in segs if s]


def _replicable(dfg: DFG, n: int, memo: Dict[int, bool]) -> bool:
    """Address-arithmetic chains (compute fed only by consts/replicable
    compute, no recurrences) are *recomputed* in each consuming segment —
    the standard rematerialization a loop compiler performs — instead of
    round-tripping through the SPM."""
    if n in memo:
        return memo[n]
    node = dfg.nodes[n]
    if node.op in ("const", "input"):
        memo[n] = True
        return True
    if not node.is_compute:
        memo[n] = False
        return False
    if any(e.src == n or e.dst == n for e in dfg.recurrence_edges()):
        memo[n] = False
        return False
    memo[n] = False  # break cycles conservatively
    ok = all(_replicable(dfg, p, memo) for p in dfg.preds(n))
    memo[n] = ok
    return ok


def _segment_dfg(dfg: DFG, nodes: List[int], tag: int) -> Tuple[DFG, int]:
    """Build a sub-DFG; cut edges become SPM store/load pairs, except
    replicable address chains which are cloned into the segment."""
    sub = DFG(f"{dfg.name}_seg{tag}")
    mapping: Dict[int, int] = {}
    member = set(nodes)
    extra = 0
    memo: Dict[int, bool] = {}

    def clone(n: int) -> int:
        if n in mapping:
            return mapping[n]
        node = dfg.nodes[n]
        ins = [clone(p) for p in dfg.preds(n)]
        nid = sub.add(node.op, node.name + "'")
        for slot, src in enumerate(ins):
            sub.connect(src, nid, operand=slot)
        mapping[n] = nid
        return nid

    # bring const/input producers along (immediates)
    for e in dfg.edges:
        if e.dst in member and dfg.nodes[e.src].op in ("const", "input"):
            if e.src not in mapping:
                mapping[e.src] = sub.add(dfg.nodes[e.src].op, dfg.nodes[e.src].name)
    for n in nodes:
        mapping[n] = sub.add(dfg.nodes[n].op, dfg.nodes[n].name)
    for e in dfg.edges:
        if e.dst in member and e.src in member:
            sub.connect(mapping[e.src], mapping[e.dst], e.distance, e.operand)
        elif e.dst in member and e.src not in member:
            if dfg.nodes[e.src].op in ("const", "input"):
                sub.connect(mapping[e.src], mapping[e.dst], e.distance, e.operand)
            elif _replicable(dfg, e.src, memo):
                src = clone(e.src)
                sub.connect(src, mapping[e.dst], e.distance, e.operand)
            else:
                # value produced in an earlier segment: load it from SPM
                ld = sub.add("load", f"cut_ld_{e.src}")
                sub.connect(ld, mapping[e.dst], e.distance, e.operand)
                extra += 1
    stored = set()
    for e in dfg.edges:
        if (
            e.src in member and e.dst not in member and e.distance == 0
            and e.src not in stored
            and not _replicable(dfg, e.src, memo)
            and dfg.nodes[e.dst].op not in ("const", "input")
        ):
            st = sub.add("store", f"cut_st_{e.src}")
            sub.connect(mapping[e.src], st)
            stored.add(e.src)
            extra += 1
    return sub, extra


@register_mapper(
    "spatial",
    jobs={"spatial": "spatial4x4"},
    result="spatial",
    description="spatial-CGRA partition + II=1 P&R (segments, SPM cut pairs)",
)
class SpatialPipelineMapper:
    """Registry adapter: gives :func:`map_spatial` the ``cls(arch, seed=,
    time_budget=).map(dfg)`` shape every other registered mapper has, so
    the spatial model is just another mapper to :func:`repro_torch.compiler.compile`.
    ``time_budget`` is accepted for interface parity; the partitioner's
    budgets are structural (segment caps), not step counts."""

    def __init__(self, arch: Arch, seed: int = 0,
                 time_budget: Optional[int] = None):
        self.arch = arch
        self.seed = seed
        self._mapper: Optional[SpatialMapper] = None

    def map(self, dfg: DFG) -> SpatialResult:
        # keep a handle on the inner II=1 mapper so the pipeline can read
        # its route/cache accounting (engine_stats) after the run
        self._mapper = SpatialMapper(self.arch, seed=self.seed)
        return map_spatial(dfg, self.arch, seed=self.seed, mapper=self._mapper)

    def engine_stats(self):
        return self._mapper.engine_stats() if self._mapper is not None else None


def map_spatial(dfg: DFG, arch: Optional[Arch] = None, seed: int = 0,
                mapper: Optional[SpatialMapper] = None) -> SpatialResult:
    arch = arch or make_arch("spatial4x4")
    # II=1 segment P&R shares the per-fabric routing engine (distance
    # tables) with the modulo mappers via the cache on the Arch instance.
    if mapper is None:
        mapper = SpatialMapper(arch, seed=seed)
    whole = mapper.map(dfg)
    if whole is not None:
        return SpatialResult([whole], 0)
    max_nodes = max(4, arch.n_fus - 2)
    mem_cap = 3
    extra_total = 0
    while max_nodes >= 4:
        parts = _partition(dfg, max_nodes, mem_cap)
        if parts is None:
            max_nodes -= 2
            mem_cap = max(1, mem_cap - 1)
            continue
        maps: List[Mapping] = []
        extra_total = 0
        ok = True
        for i, part in enumerate(parts):
            sub, extra = _segment_dfg(dfg, part, i)
            extra_total += extra
            m = mapper.map(sub)
            if m is None:
                ok = False
                break
            maps.append(m)
        if ok:
            return SpatialResult(maps, extra_total)
        max_nodes -= 2
        mem_cap = max(1, mem_cap - 1)
    return _analytic_spatial(dfg, arch)


def _analytic_spatial(dfg: DFG, arch: Arch) -> SpatialResult:
    """Resource-bound segment model for DFGs the P&R cannot partition
    routably (documented fallback): segments = what 4 mem PEs / 16 FUs can
    hold at II=1, plus SPM round-trips for edges crossing segment slices."""
    exec_nodes = [
        n for n in dfg.nodes if dfg.nodes[n].op not in ("const", "input")
    ]
    mem_ops = len(dfg.memory_nodes)
    n_fus = arch.n_fus
    n_mem_fus = len(arch.mem_fus())
    # first-order cut estimate: one store/load pair per extra segment branch
    segs = max(
        1,
        -(-mem_ops // n_mem_fus),
        -(-len(exec_nodes) // n_fus),
    )
    extra = 2 * (segs - 1) * 2  # 2 live values per boundary on average
    mem_ops += extra
    segs = max(segs, -(-mem_ops // n_mem_fus))
    asap = dfg.asap()
    depth = max(asap.values()) + 2 if asap else 2
    return SpatialResult([], extra, analytic_segments=segs, analytic_depth=depth)
