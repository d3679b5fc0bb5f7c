"""Cycle-accurate execution of a mapped configuration: the scalar oracle
(port of ``repro/core/simulate.py``, pure Python).

The mapped configuration (FU schedule + routed paths) is executed cycle by
cycle — values physically move along their reserved routing resources —
and every node's per-iteration value is checked against the DFG reference
interpreter.  The batched backend serves mappings its lowering cannot
express through this oracle, and ``verify --parity`` holds the batched
verdicts against it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.dfg import _apply
from repro_torch.mapping.mapping import Mapping
from repro_torch.sim.check import close


def simulate(mapping: Mapping, iterations: int = 4) -> Dict[Tuple[int, int], float]:
    """Execute ``iterations`` loop iterations; returns {(node, iter): value}
    and raises AssertionError on any mismatch with the reference interpreter.
    """
    dfg, ii = mapping.dfg, mapping.ii
    ref = dfg.eval({}, iterations)

    # per-edge route: list of (rid, offset_from_producer_issue)
    routes = {}
    for idx, e in enumerate(dfg.edges):
        if idx in mapping.routes:
            t_src = mapping.time[e.src]
            routes[idx] = [(rid, t - t_src) for rid, t in mapping.routes[idx]]

    horizon = mapping.makespan + ii * iterations + 2
    val: Dict[Tuple[int, int], float] = {}
    # capacity-k resources are k parallel channels; channel assignment is
    # implicit, so state is keyed by the VALUE identity (rid, net, iter)
    state: Dict[Tuple[int, int, int], float] = {}  # (rid, net, iter) -> value

    exec_at: Dict[int, List[int]] = {}
    for n, t in mapping.time.items():
        exec_at.setdefault(t % ii, []).append(n)

    for t in range(horizon):
        # 1) execute FUs whose issue slot matches (reads see current state)
        pending_vals: Dict[Tuple[int, int], float] = {}
        for n in exec_at.get(t % ii, []):
            t_n = mapping.time[n]
            if t < t_n or (t - t_n) % ii != 0:
                continue
            it = (t - t_n) // ii
            if it >= iterations:
                continue
            node = dfg.nodes[n]
            ops: List[Tuple[int, float]] = []
            for idx, e in enumerate(dfg.edges):
                if e.dst != n:
                    continue
                src_op = dfg.nodes[e.src].op
                want_it = it - e.distance
                if src_op in ("const", "input"):
                    ops.append((e.operand, ref[e.src][it]))
                    continue
                if want_it < 0:
                    ops.append((e.operand, 0.0))
                    continue
                rid = mapping.routes[idx][-1][0]
                v = state.get((rid, e.src, want_it))
                assert v is not None, (
                    f"cycle {t}: node {n} it {it} reads {rid} net {e.src}: "
                    f"iteration {want_it} value not present"
                )
                ops.append((e.operand, v))
            ops.sort()
            a = ops[0][1] if len(ops) > 0 else 0.0
            b = ops[1][1] if len(ops) > 1 else 0.0
            c = ops[2][1] if len(ops) > 2 else 0.0
            leaf = ref[n][it] if node.op in ("const", "input", "load") else 0.0
            pending_vals[(n, it)] = _apply(node.op, a, b, c, leaf)
        val.update(pending_vals)

        # 2) move values along routes: a step (rid, off) holds iteration
        # k's value at absolute cycle t_src + off + k*ii
        writes: Dict[Tuple[int, int, int], float] = {}
        for idx, e in enumerate(dfg.edges):
            if idx not in routes:
                continue
            t_src = mapping.time[e.src]
            for rid, off in routes[idx]:
                # iteration whose value occupies rid at cycle t+1
                k, rem = divmod((t + 1) - (t_src + off), ii)
                if rem != 0 or k < 0 or k >= iterations:
                    continue
                if (e.src, k) not in val:
                    continue
                writes[(rid, e.src, k)] = val[(e.src, k)]
        state.update(writes)

    # 3) compare against the reference interpreter
    for n in mapping.place:
        if dfg.nodes[n].op in ("const", "input"):
            continue
        for it in range(iterations):
            got = val.get((n, it))
            want = ref[n][it]
            assert got is not None, (n, it)
            assert close(got, want), (
                f"node {n}({dfg.nodes[n].op}) iter {it}: got {got}, want {want}"
            )
    return val
