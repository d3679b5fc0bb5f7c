"""The reference's training steps: the loss and its gradient in float32
(:func:`bench.reference.model.loss`), global-norm clipping, and AdamW with
float32 moments and a warmup + cosine schedule, the parameters stored
between steps in the configuration's bfloat16.  Its readings are those the
comparison takes: each step's loss, the first step's gradient as the
optimizer gets it (clipped) by leaf, and the parameters' change after the
steps by leaf."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from bench.reference import model as M


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _split(tree, fn, stacked: bool = False):
    """A tree of ``fn`` over leaves; under ``layers`` each leaf becomes a
    list of its per-layer slices."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _split(val, fn, stacked or key == "layers")
        elif isinstance(val, list):
            out[key] = [fn(s) for s in val]
        elif stacked:
            out[key] = [fn(s) for s in val.unbind(0)]
        else:
            out[key] = fn(val)
    return out


def _parts(v):
    return v if isinstance(v, list) else [v]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then a cosine down to a tenth
    of ``learning_rate`` at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (
        1.0 + math.cos(math.pi * frac)))


def run(conf: Dict, params: Dict, batches: List[Dict], opt: Dict,
        quant: Optional[str] = None) -> Dict:
    """``len(batches)`` steps from ``params`` (a tree of the configuration's
    dtypes on the device; left unchanged).  Returns ``losses``,
    ``grad_norms`` (the first step's clipped gradient's norm by leaf path)
    and ``change_norms`` (the norm of each leaf's change after the
    steps)."""
    M.no_tf32()
    a = M.Arch(conf)
    stored = _split(params, lambda t: t.detach().clone())
    m = _split(stored, lambda t: torch.zeros(t.shape, device=t.device))
    v = _split(stored, lambda t: torch.zeros(t.shape, device=t.device))
    losses, grad_norms = [], {}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for step, batch in enumerate(batches, start=1):
        w = _split(stored,
                   lambda t: t.to(torch.float32, copy=True).requires_grad_())
        loss = M.loss(a, w, batch["tokens"], batch["labels"], quant)
        loss.backward()
        losses.append(float(loss.detach()))
        flat = list(_leaves(w))
        norms = {path: math.sqrt(sum(_norm(p.grad) ** 2 for p in _parts(x)))
                 for path, x in flat}
        gnorm = math.sqrt(sum(n ** 2 for n in norms.values()))
        scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) \
            if opt["grad_clip"] else 1.0
        lr = lr_at(opt, step)
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for (path, x), (_, ps), (_, ms), (_, vs) in zip(
                flat, _leaves(stored), _leaves(m), _leaves(v)):
            if step == 1:
                grad_norms[path] = norms[path] * scale
            for p, sp, mp, vp in zip(_parts(x), _parts(ps), _parts(ms),
                                     _parts(vs)):
                g = p.grad * scale
                mp.mul_(b1).add_((1 - b1) * g)
                vp.mul_(b2).add_((1 - b2) * g * g)
                delta = (mp / bc1) / (torch.sqrt(vp / bc2) + eps) \
                    + wd * sp.float()
                sp.copy_(sp.float() - lr * delta)
        del w, loss, flat
    change = {}
    for (path, x0), (_, x) in zip(_leaves(params), _leaves(stored)):
        starts = x0.unbind(0) if isinstance(x, list) else [x0]
        change[path] = math.sqrt(sum(
            _norm(p.float() - p0.float()) ** 2
            for p, p0 in zip(_parts(x), starts)))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
