"""CGRA architecture models (port of ``repro/core/arch.py``).

Three architectures from the paper's evaluation (section 6), described as
static *resource graphs*:

* ``spatio_temporal`` — 4x4 PE array, mesh NoC (Fig. 3). Each PE: one FU
  (all ops incl. load/store), 4 output ports (registered crossbar), a small
  register file, 16-entry config memory read every cycle.
* ``spatial`` — same fabric, but the configuration is frozen for a code
  segment: every resource may carry at most one node/net for the whole
  segment.
* ``plaid`` — 2x2 or 3x3 PCU array (Fig. 9). Each PCU: 3 ALUs + 1 ALSU,
  one local router serving the ALUs (collective routing), bypass paths
  between adjacent ALUs, one global router, 16x120-bit config.

Resource nodes carry a per-cycle capacity; FU adjacency lists say which
resources an FU's operand mux can read.  ``Mapping.validate()`` reads the
FUs' op sets and ``reads`` and the resource nodes' ``cap``.  The routing
engine of the JAX package's ``Arch`` (``routing_engine``) comes with the
mapper's port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.registry import register_arch
from repro_torch.core.dfg import COMPUTE_OPS, MEMORY_OPS

ALL_EXEC_OPS = COMPUTE_OPS | MEMORY_OPS


@dataclass(frozen=True)
class FU:
    id: int
    tile: Tuple[int, int]
    kind: str  # 'pe' | 'alu' | 'alsu'
    ops: frozenset
    reads: Tuple[int, ...] = ()  # resource ids the operand mux can select


@dataclass(frozen=True)
class RNode:
    id: int
    tile: Tuple[int, int]
    kind: str  # 'fuout' | 'port' | 'reg' | 'lrouter' | 'glink' | 'gport'
    cap: int = 1
    holdable: bool = False


@dataclass
class Arch:
    name: str
    kind: str  # spatio_temporal | spatial | plaid
    rows: int
    cols: int
    fus: List[FU] = field(default_factory=list)
    rnodes: List[RNode] = field(default_factory=list)
    redges: Dict[int, List[int]] = field(default_factory=dict)  # rnode -> rnodes (1 cycle)
    fu_out: Dict[int, int] = field(default_factory=dict)  # fu id -> its output rnode
    config_entries: int = 16
    # hardwired motifs for domain specialization (kind per PCU index), §4.4
    hardwired: Dict[int, str] = field(default_factory=dict)

    @property
    def n_fus(self) -> int:
        return len(self.fus)

    def mem_fus(self) -> List[FU]:
        return [f for f in self.fus if "load" in f.ops]

    def res_mii(self, n_compute: int, n_mem: int) -> int:
        comp_fus = len([f for f in self.fus if "add" in f.ops])
        mem_fus = len(self.mem_fus())
        return max(
            -(-(n_compute + n_mem) // comp_fus),
            -(-n_mem // max(mem_fus, 1)),
            1,
        )


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

_DIRS = {"N": (-1, 0), "S": (1, 0), "E": (0, 1), "W": (0, -1)}


def build_spatio_temporal(rows: int = 4, cols: int = 4, name: str = "st4x4") -> Arch:
    a = Arch(name=name, kind="spatio_temporal", rows=rows, cols=cols)
    rid = 0
    fid = 0
    fuout: Dict[Tuple[int, int], int] = {}
    ports: Dict[Tuple[int, int, str], int] = {}
    regs: Dict[Tuple[int, int], int] = {}
    for x in range(rows):
        for y in range(cols):
            a.rnodes.append(RNode(rid, (x, y), "fuout", cap=1, holdable=True))
            fuout[(x, y)] = rid
            rid += 1
            a.rnodes.append(RNode(rid, (x, y), "reg", cap=2, holdable=True))
            regs[(x, y)] = rid
            rid += 1
            for d in _DIRS:
                a.rnodes.append(RNode(rid, (x, y), "port", cap=1, holdable=True))
                ports[(x, y, d)] = rid
                rid += 1
    for r in a.rnodes:
        a.redges[r.id] = []

    def nbr(x, y, d):
        dx, dy = _DIRS[d]
        nx, ny = x + dx, y + dy
        return (nx, ny) if 0 <= nx < rows and 0 <= ny < cols else None

    for x in range(rows):
        for y in range(cols):
            # fu output -> own ports & reg
            for d in _DIRS:
                a.redges[fuout[(x, y)]].append(ports[(x, y, d)])
            a.redges[fuout[(x, y)]].append(regs[(x, y)])
            # incoming neighbor ports -> forward to own ports / reg (crossbar)
            for d in _DIRS:
                n = nbr(x, y, d)
                if n is None:
                    continue
                # neighbor n sends toward us via its port facing d-opposite
                opp = {"N": "S", "S": "N", "E": "W", "W": "E"}[d]
                src = ports[(n[0], n[1], opp)]
                for d2 in _DIRS:
                    a.redges[src].append(ports[(x, y, d2)])
                a.redges[src].append(regs[(x, y)])
    # FUs: read own fuout/reg + neighbor ports facing them.
    # Only column-0 PEs interface the 4 SPM banks (typical HyCUBE/Morpher
    # setup; matches Plaid's 4 edge ALSUs for an equal-FU comparison).
    for x in range(rows):
        for y in range(cols):
            reads = [fuout[(x, y)], regs[(x, y)]]
            for d in _DIRS:
                n = nbr(x, y, d)
                if n is None:
                    continue
                opp = {"N": "S", "S": "N", "E": "W", "W": "E"}[d]
                reads.append(ports[(n[0], n[1], opp)])
            ops = ALL_EXEC_OPS if y == 0 else COMPUTE_OPS
            a.fus.append(FU(fid, (x, y), "pe", frozenset(ops), tuple(reads)))
            a.fu_out[fid] = fuout[(x, y)]
            fid += 1
    return a


def build_spatial(rows: int = 4, cols: int = 4, name: str = "spatial4x4") -> Arch:
    a = build_spatio_temporal(rows, cols, name)
    a.kind = "spatial"
    a.name = name
    return a


def build_plaid(rows: int = 2, cols: int = 2, name: str = "plaid2x2",
                hardwired: Optional[Dict[int, str]] = None) -> Arch:
    a = Arch(name=name, kind="plaid", rows=rows, cols=cols,
             hardwired=dict(hardwired or {}))
    rid = 0
    fid = 0
    aout: Dict[Tuple[int, int, int], int] = {}
    alsuout: Dict[Tuple[int, int], int] = {}
    lrouter: Dict[Tuple[int, int], int] = {}
    glink: Dict[Tuple[int, int], int] = {}
    gports: Dict[Tuple[int, int, str], int] = {}
    regs: Dict[Tuple[int, int], int] = {}
    for x in range(rows):
        for y in range(cols):
            for i in range(3):
                a.rnodes.append(RNode(rid, (x, y), "fuout", cap=1, holdable=True))
                aout[(x, y, i)] = rid
                rid += 1
            a.rnodes.append(RNode(rid, (x, y), "fuout", cap=1, holdable=True))
            alsuout[(x, y)] = rid
            rid += 1
            a.rnodes.append(RNode(rid, (x, y), "lrouter", cap=6, holdable=False))  # 2 ops x 3 ALUs per cycle (§4.1)
            lrouter[(x, y)] = rid
            rid += 1
            a.rnodes.append(RNode(rid, (x, y), "glink", cap=2, holdable=True))
            glink[(x, y)] = rid
            rid += 1
            # buffer registers on the global<->local paths (Fig. 9c)
            a.rnodes.append(RNode(rid, (x, y), "reg", cap=4, holdable=True))
            regs[(x, y)] = rid
            rid += 1
            for d in _DIRS:
                a.rnodes.append(RNode(rid, (x, y), "gport", cap=1, holdable=True))
                gports[(x, y, d)] = rid
                rid += 1
    for r in a.rnodes:
        a.redges[r.id] = []

    def nbr(x, y, d):
        dx, dy = _DIRS[d]
        nx, ny = x + dx, y + dy
        return (nx, ny) if 0 <= nx < rows and 0 <= ny < cols else None

    for x in range(rows):
        for y in range(cols):
            t = (x, y)
            for i in range(3):
                a.redges[aout[(x, y, i)]] += [lrouter[t], glink[t]]
                for d in _DIRS:  # output regs write onto the mesh directly
                    a.redges[aout[(x, y, i)]].append(gports[(x, y, d)])
            a.redges[alsuout[t]].append(glink[t])
            a.redges[alsuout[t]].append(lrouter[t])  # ALSU feeds local path too
            for d in _DIRS:
                a.redges[alsuout[t]].append(gports[(x, y, d)])
            # local router: feeds ALUs (via FU adjacency) and can push global
            a.redges[lrouter[t]].append(glink[t])
            # global link: deposit to local path or out to mesh
            a.redges[glink[t]].append(lrouter[t])
            for d in _DIRS:
                a.redges[glink[t]].append(gports[(x, y, d)])
            # buffer registers park values between global and local paths
            a.redges[glink[t]].append(regs[t])
            a.redges[regs[t]] += [glink[t], lrouter[t]]
            for i in range(3):
                a.redges[aout[(x, y, i)]].append(regs[t])
            a.redges[alsuout[t]].append(regs[t])
            for d in _DIRS:
                n = nbr(x, y, d)
                if n is None:
                    continue
                opp = {"N": "S", "S": "N", "E": "W", "W": "E"}[d]
                src = gports[(n[0], n[1], opp)]
                # conveyor belt: forward along mesh, drop into this PCU's
                # buffer link, or straight into the collective router
                # (HyCUBE-lineage low-latency hop)
                a.redges[src].append(glink[t])
                a.redges[src].append(lrouter[t])
                for d2 in _DIRS:
                    a.redges[src].append(gports[(x, y, d2)])

    for x in range(rows):
        for y in range(cols):
            t = (x, y)
            pcU_index = x * cols + y
            for i in range(3):
                reads = [lrouter[t], aout[(x, y, i)]]
                if i > 0:  # bypass path from the left neighbour ALU
                    reads.append(aout[(x, y, i - 1)])
                a.fus.append(FU(fid, t, "alu", frozenset(COMPUTE_OPS), tuple(reads)))
                a.fu_out[fid] = aout[(x, y, i)]
                fid += 1
            # ALSU: load/store + standalone/predication fallback, on global path
            reads = [glink[t], alsuout[t]]
            a.fus.append(FU(fid, t, "alsu", frozenset(ALL_EXEC_OPS), tuple(reads)))
            a.fu_out[fid] = alsuout[t]
            fid += 1
    return a


_ARCH_CACHE: Dict[str, Tuple[object, Arch]] = {}  # canon -> (builder, arch)


def make_arch(name: str) -> Arch:
    """Build (or return the cached) architecture for ``name``.

    Names (and aliases) come from the ``@register_arch`` registry — new
    fabrics plug in by registering a builder, no edits here.  Arch objects
    are immutable after construction, so every caller in a process shares
    one fabric per canonical name.
    """
    from repro_torch.compiler.registry import ARCHES

    canon = ARCHES.resolve(name)  # RegistryError (a ValueError) if unknown
    builder = ARCHES.get(canon)
    cached = _ARCH_CACHE.get(canon)
    if cached is None or cached[0] is not builder:
        # cache keyed by the registered builder so re-registering a name
        # (latest wins) takes effect even after a prior make_arch call
        cached = _ARCH_CACHE[canon] = (builder, builder())
    return cached[1]


# -- registered fabrics (§6 evaluation set) ---------------------------------


@register_arch("st4x4", aliases=("st", "spatio_temporal"),
               description="4x4 spatio-temporal baseline (Fig. 3)")
def _arch_st4x4() -> Arch:
    return build_spatio_temporal(4, 4, "st4x4")


@register_arch("st6x6", description="6x6 spatio-temporal scale-up")
def _arch_st6x6() -> Arch:
    return build_spatio_temporal(6, 6, "st6x6")


@register_arch("spatial4x4", aliases=("spatial",),
               description="4x4 spatial CGRA (frozen config per segment)")
def _arch_spatial4x4() -> Arch:
    return build_spatial(4, 4, "spatial4x4")


@register_arch("plaid2x2", aliases=("plaid",),
               description="Plaid 2x2 PCU array (Fig. 9)")
def _arch_plaid2x2() -> Arch:
    return build_plaid(2, 2, "plaid2x2")


@register_arch("plaid3x3", description="Plaid 3x3 PCU array (Fig. 17)")
def _arch_plaid3x3() -> Arch:
    return build_plaid(3, 3, "plaid3x3")


@register_arch("plaid_ml",
               description="ML-specialized Plaid 2x2: hardwired motifs (§4.4)")
def _arch_plaid_ml() -> Arch:
    # §4.4: 2 fan-in + 1 unicast + 1 fan-out hardwired
    return build_plaid(2, 2, "plaid_ml",
                       hardwired={0: "fanin", 1: "fanin", 2: "unicast", 3: "fanout"})
