"""Workload DFGs (Table 2): PolyBench linear algebra + image kernels and
TinyML ML kernels at the paper's unroll factors — 30 DFGs.

Port of ``repro/core/workloads.py``, line for line,
over the port's own modules.

The exact source DFGs are produced by Morpher's frontend in the paper; here
each kernel family is rebuilt from its loop-body structure (loads, address
arithmetic, multiply/reduce or stencil chains, accumulator recurrences,
stores), tuned so the (total nodes, compute nodes) counts match Table 2
exactly. The motif-covered count is then *produced by our Algorithm 1* and
compared against the paper's third number in ``benchmarks/bench_motifs.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dfg import DFG


@dataclass(frozen=True)
class Workload:
    name: str
    unroll: int
    domain: str  # linear_algebra | ml | image
    style: str  # dot | stencil | conv
    total: int
    compute: int
    covered_paper: int  # Table 2, third number
    iterations: int = 256  # loop trip count after unroll (for cycle counts)


TABLE2: List[Workload] = [
    Workload("atax", 2, "linear_algebra", "dot", 15, 6, 6),
    Workload("atax", 4, "linear_algebra", "dot", 27, 14, 11),
    Workload("bicg", 2, "linear_algebra", "dot", 23, 11, 10),
    Workload("bicg", 4, "linear_algebra", "dot", 42, 23, 19),
    Workload("doitgen", 2, "linear_algebra", "dot", 18, 9, 9),
    Workload("doitgen", 4, "linear_algebra", "dot", 34, 21, 10),
    Workload("gemm", 2, "linear_algebra", "dot", 21, 12, 12),
    Workload("gemm", 4, "linear_algebra", "dot", 37, 24, 23),
    Workload("gemver", 2, "linear_algebra", "dot", 21, 11, 10),
    Workload("gemver", 4, "linear_algebra", "dot", 41, 23, 19),
    Workload("gesumm", 2, "linear_algebra", "dot", 22, 9, 8),
    Workload("gesumm", 4, "linear_algebra", "dot", 38, 19, 16),
    Workload("conv2x2", 1, "ml", "conv", 20, 12, 10),
    Workload("conv3x3", 1, "ml", "conv", 37, 26, 17),
    Workload("dwconv", 1, "ml", "conv", 7, 3, 2),
    Workload("dwconv", 5, "ml", "conv", 31, 19, 13),
    Workload("fc", 1, "ml", "dot", 17, 8, 7),
    Workload("cholesky", 2, "image", "stencil", 14, 5, 4),
    Workload("cholesky", 4, "image", "stencil", 28, 11, 8),
    Workload("durbin", 2, "image", "stencil", 14, 7, 4),
    Workload("durbin", 4, "image", "stencil", 28, 15, 8),
    Workload("fdtd", 2, "image", "stencil", 16, 7, 6),
    Workload("fdtd", 4, "image", "stencil", 32, 15, 12),
    Workload("gramsc", 2, "image", "stencil", 15, 5, 4),
    Workload("gramsc", 4, "image", "stencil", 25, 11, 8),
    Workload("jacobi", 1, "image", "stencil", 16, 7, 5),
    Workload("jacobi", 2, "image", "stencil", 30, 15, 12),
    Workload("jacobi", 4, "image", "stencil", 54, 30, 27),
    Workload("seidel", 1, "image", "stencil", 22, 11, 9),
    Workload("seidel", 2, "image", "stencil", 44, 23, 21),
]


QUICK_N = 10  # --quick prefix of TABLE2; golden IIs in tests/golden_ii_quick.json


def quick_workloads() -> List[Workload]:
    """The quick evaluation subset (``collect --quick``, CI, and the
    routing-equivalence golden file all agree on this slice)."""
    return TABLE2[:QUICK_N]


def _alloc_noncompute(nc: int) -> Tuple[int, int, int]:
    """nc -> (consts, loads, stores)."""
    stores = 1 if nc < 12 else 2
    consts = max(1, min(4, nc // 4))
    loads = nc - stores - consts
    assert loads >= 1, nc
    return consts, loads, stores


def build_workload(w: Workload) -> DFG:
    g = DFG(f"{w.name}_u{w.unroll}")
    nc = w.total - w.compute
    consts, loads, stores = _alloc_noncompute(nc)
    cids = [g.add("const") for _ in range(consts)]

    # --- address arithmetic (compute) ---
    if w.style == "dot":
        n_mul = max(w.unroll, round(w.compute * 0.40))
        n_red = max(1, round(w.compute * 0.40))
        n_idx = w.compute - n_mul - n_red
    elif w.style == "conv":
        n_mul = max(w.unroll, round(w.compute * 0.5))
        n_red = max(1, w.compute - n_mul - max(0, w.compute // 8))
        n_idx = w.compute - n_mul - n_red
    else:  # stencil: add/mul chains
        n_mul = max(1, round(w.compute * 0.35))
        n_red = max(1, round(w.compute * 0.45))
        n_idx = w.compute - n_mul - n_red
    if n_idx < 0:
        n_red += n_idx
        n_idx = 0

    idx_ids: List[int] = []
    prev = cids[0]
    for i in range(n_idx):
        nid = g.add("add", f"idx{i}", [prev, cids[(i + 1) % len(cids)]])
        idx_ids.append(nid)
        prev = nid

    # --- loads (addressed by idx chain / consts) ---
    lids: List[int] = []
    for i in range(loads):
        addr = idx_ids[i % len(idx_ids)] if idx_ids else cids[i % len(cids)]
        lids.append(g.add("load", f"ld{i}", [addr]))

    # --- multiply / stencil chains ---
    muls: List[int] = []
    if w.style == "stencil":
        # pairwise adds of neighbour loads feeding const-weight multiplies
        feed = list(lids)
        for i in range(n_mul):
            a = feed[(2 * i) % len(feed)]
            b = feed[(2 * i + 1) % len(feed)]
            s = muls[-1] if muls and i % 3 == 2 else a
            muls.append(g.add("mul", f"w{i}", [s, b]))
    else:
        for i in range(n_mul):
            a = lids[(2 * i) % len(lids)]
            # strength-reduced index joins the first multiply (typical of
            # unrolled pointer-bumped inner loops)
            if i == 0 and idx_ids:
                b = idx_ids[-1]
            else:
                b = lids[(2 * i + 1) % len(lids)]
            muls.append(g.add("mul", f"m{i}", [a, b]))

    # --- serial accumulation chain (acc += m_i) with recurrence ---
    red_ids: List[int] = []
    feed = list(muls)
    for i in range(n_red):
        if not red_ids:
            if len(feed) >= 2:
                a, b = feed.pop(0), feed.pop(0)
            elif feed:
                a, b = feed.pop(0), (idx_ids[0] if idx_ids else cids[0])
            else:
                a, b = cids[0], (lids[0] if lids else cids[0])
        else:
            a = red_ids[-1]
            if feed:
                b = feed.pop(0)
            elif w.style == "stencil" and lids:
                b = lids[i % len(lids)]
            else:
                b = idx_ids[i % len(idx_ids)] if idx_ids else cids[0]
        nid = g.add("add", f"r{i}", [a, b])
        red_ids.append(nid)
    # loop-carried accumulation on the last reduction node
    g.connect(red_ids[-1], red_ids[-1], distance=1, operand=2)

    # --- stores ---
    for i in range(stores):
        src = red_ids[-1] if i == 0 else (muls[-1] if muls else red_ids[-1])
        g.add("store", f"st{i}", [src])

    g.validate()
    assert g.n_nodes == w.total, (w, g.n_nodes)
    assert len(g.compute_nodes) == w.compute, (w, len(g.compute_nodes))
    return g


def all_workloads() -> List[Tuple[Workload, DFG]]:
    return [(w, build_workload(w)) for w in TABLE2]


# ---------------------------------------------------------------------------
# DNN applications (Fig. 16): layer sequences adapted from TinyML
# ---------------------------------------------------------------------------

DNN_APPS: Dict[str, List[Tuple[str, int, int]]] = {
    # (kernel name, unroll, per-layer iteration count)
    "dnn10": [("conv3x3", 1, 784)] * 5 + [("dwconv", 5, 196)] * 4 + [("fc", 1, 128)],
    "dnn13": [("conv3x3", 1, 784)] * 6 + [("dwconv", 5, 196)] * 6 + [("fc", 1, 128)],
    "dnn16": [("conv3x3", 1, 784)] * 7 + [("dwconv", 5, 196)] * 8 + [("fc", 1, 128)],
}


def workload_by_name(name: str, unroll: int) -> Workload:
    for w in TABLE2:
        if w.name == name and w.unroll == unroll:
            return w
    raise KeyError((name, unroll))


def workloads_by_keys(table: List[Workload],
                      keys: List[str]) -> List[Workload]:
    """Subset of ``table`` matching ``<name>_u<unroll>`` keys; unknown keys
    raise ``KeyError`` naming every valid one (shared by ``collect
    --workloads`` and ``plaid-compile store warm --workloads``)."""
    wanted = set(keys)
    chosen = [w for w in table if f"{w.name}_u{w.unroll}" in wanted]
    missing = wanted - {f"{w.name}_u{w.unroll}" for w in chosen}
    if missing:
        raise KeyError(
            f"unknown workload key(s) {sorted(missing)}; known: "
            + ", ".join(f"{w.name}_u{w.unroll}" for w in table)
        )
    return chosen
