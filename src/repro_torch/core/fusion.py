"""Motif-guided fusion: the paper's Algorithm 1 applied to aten graphs
(port of ``repro/core/fusion.py``, which reads jaxprs).

An aten graph is a DFG: call nodes are DFG nodes, tensors are edges.
:func:`analyze_fn` traces a function with
``make_fx(fn, tracing_mode="fake")`` — shapes only, no data, no kernel —
and runs the *same* motif extractor (:mod:`repro_torch.core.motifs`) over
the graph.  The fusion groups written as kernels are recurring 3-node
motifs:

  fan-in  -> fused SwiGLU         (two projections meet at an elementwise gate)
  unicast -> RMSNorm chain        (square -> mean -> rsqrt -> scale)
  fan-out -> residual dual-use    (one activation feeding attn + residual)

The graph keeps the jaxpr's granularity: aten ops map to op classes
through the JAX package's primitive map, layout ops are wires,
``aten.mean`` is two nodes (``add``, then ``mul``, as the jaxpr's
``reduce_sum``, ``div``), and ``aten.silu`` is one ``mul``-class node, as
the jaxpr's opaque ``jit`` call of ``jax.nn.silu`` is there.  Trace the
plain functions: a kernel wrapper that launches through ``ctypes`` cannot
take a fake tensor.
"""
from __future__ import annotations

import numbers
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.dfg import DFG
from repro_torch.core.motifs import generate_motifs, motif_cover_stats

# aten op -> DFG op class, the JAX package's primitive map
# (``repro/core/fusion.py``) read for aten names; everything unknown maps
# to 'mul'
_ATEN_MAP = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "mul",
    "mm": "mac", "bmm": "mac", "addmm": "mac", "baddbmm": "mac",
    "maximum": "max", "minimum": "min",
    "exp": "abs", "log": "abs", "rsqrt": "abs", "sqrt": "abs",
    "tanh": "abs", "sigmoid": "abs", "neg": "not",
    "sum": "add", "amax": "max", "pow": "mul",
    "where": "select", "gt": "cmp", "lt": "cmp",
    # one opaque node, as the jaxpr's ``jit`` call of jax.nn.silu
    "silu": "mul",
}
#: layout ops: transparent wires from their first tensor input
_WIRES = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "unsqueeze", "squeeze", "slice", "cat", "_to_copy", "clone",
}


def _opname(target) -> str:
    name = getattr(target, "_opname", None)
    return name if name is not None else getattr(target, "__name__",
                                                 str(target))


def _flat(args) -> List[object]:
    out: List[object] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _flat(a)
        else:
            out.append(a)
    return out


def fx_to_dfg(gm: torch.fx.GraphModule,
              name: str = "fx") -> Tuple[DFG, Dict[int, str]]:
    """Flatten a traced aten graph into a DFG (see module docstring).
    Placeholders are ``input`` nodes and each number a compute op takes
    (a jaxpr literal) a ``const`` node; returns the DFG and each input and
    compute node's label (its aten op)."""
    g = DFG(name)
    producer: Dict[torch.fx.Node, int] = {}
    labels: Dict[int, str] = {}

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            nid = g.add("input")
            producer[node] = nid
            labels[nid] = "input"
        elif node.op == "get_attr":
            producer[node] = g.add("const")
        elif node.op == "call_function":
            prim = _opname(node.target)
            args = _flat(node.args)
            if prim in _WIRES or prim == "getitem":
                src = next((a for a in args if a in producer), None)
                if src is not None:
                    producer[node] = producer[src]
                continue
            ins: List[int] = []
            for a in args:
                if isinstance(a, torch.fx.Node):
                    if a in producer:
                        ins.append(producer[a])
                elif (isinstance(a, numbers.Number)
                      and not isinstance(a, bool) and prim != "mean"):
                    ins.append(g.add("const"))
            if prim == "mean":
                # reduce_sum, then div by the (literal) element count
                s = g.add("add", name="sum", inputs=ins[:3])
                labels[s] = "mean:sum"
                nid = g.add("mul", name="div", inputs=[s, g.add("const")])
                labels[nid] = "mean:div"
            else:
                op = _ATEN_MAP.get(prim, "mul")
                nid = g.add(op, name=prim, inputs=ins[:3])
                labels[nid] = prim
            producer[node] = nid
    return g, labels


def analyze_fn(fn: Callable, *example_args, seed: int = 0):
    """Motif cover of a function's aten graph, traced on fake tensors
    (``example_args`` may be real, fake or ``meta`` tensors: only their
    shapes and dtypes are read)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn, tracing_mode="fake")(*example_args)
    g, labels = fx_to_dfg(gm, getattr(fn, "__name__", "fn"))
    motifs, standalone = generate_motifs(g, seed=seed)
    stats = motif_cover_stats(g, motifs)
    named = [
        (m.kind, tuple(labels.get(n, "?") for n in m.nodes)) for m in motifs
    ]
    return {
        "dfg": g,
        "motifs": motifs,
        "named_motifs": named,
        "standalone": standalone,
        "stats": stats,
    }


KERNEL_OF_MOTIF = {
    "fanin": "kernels/fused_swiglu.py (silu(x@w1) * (x@w3) — two edges meet)",
    "unicast": "kernels/rmsnorm.py (x^2 -> mean -> rsqrt -> scale chain)",
    "fanout": "residual dual-use (hidden feeds attention and residual add)",
}


def fusion_report(fn: Callable, *example_args) -> str:
    res = analyze_fn(fn, *example_args)
    s = res["stats"]
    lines = [
        f"aten DFG: {s['n_nodes']} nodes, {s['n_compute']} compute",
        f"motifs: {s['n_motifs']} (fan-in {s['fanin']}, fan-out {s['fanout']}, "
        f"unicast {s['unicast']}), covered {s['covered']}/{s['n_compute']}",
        "kernel mapping:",
    ]
    for kind, kern in KERNEL_OF_MOTIF.items():
        lines.append(f"  {kind:8s} -> {kern}")
    return "\n".join(lines)
