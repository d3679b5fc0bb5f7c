"""The numbers that decide ``correct``: each compared with its limit
from ``bench/limits/<cell>.json`` (set from the program's readings over a
dozen seeds and the control's and the faults', as ``PERF.md`` gives
them).  A number that is missing or not finite fails."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of the change
STILL_LEAF = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    if len(prog) != len(ref):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               skip=()) -> float:
    """The largest gap of a leaf's norm against the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    if set(prog) != set(ref):
        return math.inf
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med)
               for k in ref if k not in skip)


def still_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, g in ref_grad.items() if g < STILL_LEAF * med)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's
    readings against the reference's (``losses``, ``grad_norms``,
    ``change_norms``)."""
    skip = still_leaves(ref["grad_norms"])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": worst_leaf(prog["change_norms"],
                                     ref["change_norms"], skip)}


def rel_err(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r|| in float32."""
    p, r = p.float(), r.float()
    return float(torch.linalg.vector_norm(p - r)
                 / torch.linalg.vector_norm(r).clamp(min=1e-30))


def logit_err(p: torch.Tensor, r: torch.Tensor) -> float:
    """The largest over rows of ||p - r|| / ||r - mean(r)||."""
    p, r = p.float(), r.float()
    c = r - r.mean(-1, keepdim=True)
    return float((torch.linalg.vector_norm(p - r, dim=-1)
                  / torch.linalg.vector_norm(c, dim=-1)).max())


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best, over rows (n, V) and tokens (n,)."""
    r = ref_logits.float()
    chosen = r.gather(1, tokens.long().view(-1, 1)).squeeze(1)
    return float((r.max(-1).values - chosen).max())


def checks(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each number beside its limit, in the limits file's order; a limit
    without its number reads as infinite."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": lim["limit"]}
    return out


def passed(check: Dict[str, Dict]) -> bool:
    return all(isinstance(c["value"], (int, float))
               and c["value"] <= c["limit"] for c in check.values())
