"""AdamW with a choice of state dtype, global-norm clipping and a
warmup + cosine schedule, the port of ``repro/train/optimizer.py``.

The arithmetic is the JAX package's: each update in float32, then one cast
to the parameter's and the state's dtypes (so with bf16 parameters, lr
3e-4 and a 100-step warmup, the first updates mostly round away, as they
do there).  Unlike the JAX package, which returns new arrays,
:func:`apply_updates` writes parameters and state in place.

The device decides, as for the other kernels: on CUDA (or on fake tensors
standing for the card's) the norm and the update are the two CUDA kernels
of :mod:`repro_torch.kernels.adamw`, which take every leaf whole with no
float32 temporaries, the update the loop's bit for bit given the same clip
scale, and raise for a leaf they cannot take.  On the CPU they are the
plain loop, which walks a leaf stacked over layers one layer slice at a
time, so the float32 temporaries are one slice's (``mlp.w1`` of
llama3_2_3b whole would be a 2.8 GB float32 temporary).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import adamw, fake
from repro_torch.models.layers import Spec, spec_map
from repro_torch.train.tree import leaves, slices, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 scalar on ``step``'s device: linear warmup, then a cosine down
    to a tenth of ``learning_rate`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def opt_state_spec(param_specs, cfg: AdamWConfig) -> Dict:
    """The optimizer state's spec tree (no allocation): ``m`` and ``v`` in
    ``state_dtype`` with each parameter's shape and axes, and a scalar
    int32 ``step`` (``repro/train/optimizer.py:40-47``)."""
    dt = _DTYPES[cfg.state_dtype]
    mv = spec_map(lambda s: Spec(s.shape, s.axes, dt, init="zeros"),
                  param_specs)
    return {"m": mv, "v": mv, "step": Spec((), (), torch.int32, init="zeros")}


def init_opt_state(params: Dict, cfg: AdamWConfig) -> Dict:
    """Zero first and second moments in ``state_dtype`` beside each
    parameter, and the step count (int32, 0)."""
    dt = _DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares (a
    stacked leaf summed slice by slice)."""
    total = 0.0
    for leaf in leaves(tree):
        for s in slices(leaf):
            total = total + torch.sum(s.float() ** 2)
    return torch.sqrt(total)


def plain_update(params, grads, ms, vs, lr, bc1, bc2, scale,
                 cfg: AdamWConfig) -> None:
    """The loop: AdamW in place over the leaves ``params``, ``grads``,
    ``ms`` and ``vs`` with clip scale ``scale``, slice by slice, in float32
    aten ops, each result cast once to its leaf's dtype."""
    for p, g, m, v in zip(params, grads, ms, vs):
        for ps, gs, ms_, vs_ in zip(slices(p), slices(g), slices(m),
                                    slices(v)):
            g32 = gs.float() * scale
            m1 = cfg.b1 * ms_.float() + (1 - cfg.b1) * g32
            v1 = cfg.b2 * vs_.float() + (1 - cfg.b2) * g32 * g32
            delta = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps) \
                + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            ms_.copy_(m1)
            vs_.copy_(v1)


@torch.no_grad()
def apply_updates(params: Dict, grads: Dict, opt_state: Dict,
                  cfg: AdamWConfig) -> Tuple[Dict, Dict, Dict[str, Any]]:
    """One AdamW step of ``params`` with ``grads``: clipped to
    ``grad_clip`` global norm, moments in ``state_dtype``, decoupled
    weight decay.  Updates ``params`` and ``opt_state`` in place and
    returns them with ``{"grad_norm", "lr"}`` (float32 scalars).  On the
    card the two kernels of :mod:`repro_torch.kernels.adamw` (``ValueError``
    for a leaf they cannot take), on the CPU the loop
    (:func:`plain_update`)."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    ps, gs = leaves(params), leaves(grads)
    ms, vs = leaves(opt_state["m"]), leaves(opt_state["v"])
    if ps[0].is_cpu and not fake.modelled(ps[0]):
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if cfg.grad_clip else 1.0
        plain_update(ps, gs, ms, vs, lr, bc1, bc2, scale, cfg)
    else:
        gnorm, scale = adamw.global_norm_cuda(gs, cfg.grad_clip)
        adamw.adamw_update_cuda(ps, gs, ms, vs, lr, bc1, bc2, scale, cfg)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
