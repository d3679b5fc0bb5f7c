#!/usr/bin/env python3
"""How well float32 holds a model's train-step parity: each gradient leaf
of the card's float32 run and of the CPU's against a float64 run.

    python3 scripts/train_parity_conditioning.py           # on one card
    python3 scripts/train_parity_conditioning.py --arch whisper_tiny
    python3 scripts/train_parity_conditioning.py --smoke   # smoke width, CPU
    python3 scripts/train_parity_conditioning.py --arch whisper_tiny --cpu

Builds the model of ``chip_smoke.py``'s train parity phase for ``--arch``
(llama3_2_3b unless given) in float32 (``chip_smoke.train_parity_model``:
for llama3_2_3b the first 2 layers sliced from the full 28-layer draw;
whisper_tiny whole at the fan-in scale, or at ``init_params``' scale
with ``--init-scale``).  It takes the loss and its gradient on 2 x 256
tokens of ``batch_for_step`` on the card (the kernels), on the CPU (the
plain versions), and on the CPU in float64 (``Tensor.float`` keeps a
float64 tensor float64 for that run, so the plain versions, the
cross-entropy's logits, RoPE and the SSMs' float32 steps compute in
float64).  Prints, per leaf, the relative L2 error of card vs CPU, card
vs float64 and CPU vs float64, and, for the dense model, the largest
activation of the residual stream.  With ``--smoke`` the "card" is a
second CPU copy of the smoke config (8 layers drawn, 2 kept); with
``--cpu`` a second CPU copy at full width.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def grads(cfg, model, batch, dev, dtype):
    """(loss, {leaf: gradient}) of ``model`` on ``batch``."""
    from repro_torch.train import steps
    from repro_torch.train.loop import batch_to
    from repro_torch.train.tree import items

    loss, _, g = steps.value_and_grad(cfg, model, batch_to(batch, dev,
                                                           dtype))
    return loss.item(), {k: v.detach().clone() for k, v in items(g)}


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import zoo
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.tree import tree_map

    smoke = "--smoke" in argv
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "llama3_2_3b"
    dev = "cpu" if smoke or "--cpu" in argv else "cuda"
    if dev == "cuda":
        if not torch.cuda.is_available():
            print("needs an NVIDIA card (or --smoke)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
    if smoke:
        full = smoke_config(arch).replace(n_layers=8)
        card = cs.first_layers(full, 2, torch.float32, dev)
    else:
        full = get_config(arch)
        card = cs.train_parity_model(arch, dev,
                                     fan_in="--init-scale" not in argv)
    cfg = card.cfg
    T = 32 if smoke else 256
    batch = batch_for_step(cfg, ShapeSpec("parity", T, 2, "train"), cs.SEED,
                           0)
    cpu = zoo.build(cfg, tree_map(lambda t: t.cpu().clone(), card.params))
    f64 = zoo.build(cfg, tree_map(lambda t: t.cpu().double(), card.params))
    peak = {}

    def watch(name):
        def hook(module, args, out):
            peak[name] = max(peak.get(name, 0.0), float(out.abs().max()))
        return hook

    results = {}
    for name, model, where, dtype in (("card", card, dev, torch.float32),
                                      ("cpu", cpu, "cpu", torch.float32)):
        results[name] = grads(cfg, model, batch, where, dtype)
    real_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else real_float(self, *a, **kw))
    try:
        results["f64"] = grads(cfg, f64, batch, "cpu", torch.float64)
        if cfg.family == "dense":  # the residual stream, layer by layer
            with torch.no_grad():
                x, positions = f64._inputs({k: torch.from_numpy(v)
                                            for k, v in batch.items()})
                x = x.double()
                for i, w in enumerate(f64.layers):
                    x = f64._block_out(w, x, positions)
                    peak[f"residual after layer {i}"] = float(x.abs().max())
    finally:
        torch.Tensor.float = real_float
    where = "cpu" if dev == "cpu" else torch.cuda.get_device_name(0)
    print(f"{arch} first {cfg.n_layers} layers of a {full.n_layers}-layer "
          f"config, d_model "
          f"{cfg.d_model}, batch 2 x {T}, card = {where}")
    print("loss: card {:.9f} cpu {:.9f} f64 {:.9f}".format(
        results["card"][0], results["cpu"][0], results["f64"][0]))
    for key in results["f64"][1]:
        c, h, d = (results[n][1][key] for n in ("card", "cpu", "f64"))
        print(f"{key}: card vs cpu {rel(c, h):.3g}, card vs f64 "
              f"{rel(c, d):.3g}, cpu vs f64 {rel(h, d):.3g}")
    for name, value in peak.items():
        print(f"largest |activation| {name}: {value:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
