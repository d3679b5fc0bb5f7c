#!/usr/bin/env python3
"""How well float32 can hold falcon_mamba_7b's card-vs-CPU parity.

    python3 scripts/ssm_parity_conditioning.py           # on one card
    python3 scripts/ssm_parity_conditioning.py --smoke   # smoke width, CPU

Builds the first 2 layers of falcon_mamba_7b in float32 twice: drawn at 2
layers (``init_params`` divides a stacked weight by the square root of its
layer count, so these weights are sqrt(32) times the served model's) and
sliced from the full 64-layer draw (``chip_smoke.first_layers``, the model
of ``chip_smoke.py``'s parity phase).  Each prefills 2 x 128 tokens and
takes 4 teacher-forced decode steps on the card (the kernels), on the CPU
(the plain versions) and on the CPU in float64 (``Tensor.float`` keeps a
float64 tensor float64 for the run, so the SSM's float32 casts stay
float64).  Prints, per step, how far each float32 run is from the float64
one as a share of ``chip_smoke.PARITY_TOL``, and the largest ``dt`` and
state.  With ``--smoke`` the "card" is a second CPU copy.
"""
from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def share(got, want, tol) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    limit = tol["atol"] + tol["rtol"] * want.abs()
    return ((got - want).abs() / limit).max().item()


def run(model, toks, dev, biggest):
    """Prefill and 4 teacher-forced decode logits of ``model`` on ``dev``,
    (B, 5, V); ``biggest`` collects the largest |dt| and |h|."""
    import torch

    from repro_torch.models import ssm

    scan = ssm._mamba1_scan

    def watched(dt, Bm, Cm, xs, A, h, Q):
        y, hT = scan(dt, Bm, Cm, xs, A, h, Q)
        biggest[0] = max(biggest[0], dt.abs().max().item())
        biggest[1] = max(biggest[1], hT.abs().max().item())
        return y, hT

    ssm._mamba1_scan = watched
    try:
        with torch.inference_mode():
            cache, logits = model.prefill({"tokens": toks[:, :128].to(dev)})
            out = [logits]
            for i in range(4):
                cache, logits = model.decode_step(
                    cache, toks[:, 128 + i:129 + i].to(dev))
                out.append(logits)
    finally:
        ssm._mamba1_scan = scan
    return torch.cat(out, dim=1).cpu()


def main(argv) -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import zoo

    smoke = "--smoke" in argv
    dev = "cpu" if smoke else "cuda"
    if not smoke:
        if not torch.cuda.is_available():
            print("needs an NVIDIA card (or --smoke)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0))
    full = (smoke_config if smoke else get_config)("falcon_mamba_7b")
    if smoke:
        full = full.replace(n_layers=8)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    drawn = {
        "drawn at 2 layers": zoo.init_model(
            full.replace(n_layers=2), gen, dev, torch.float32),
        "sliced from the full draw": cs.first_layers(
            full, 2, torch.float32, dev),
    }
    toks = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, full.vocab_size, (2, 132)).astype(np.int32))
    keep64 = torch.Tensor.float
    for name, card in drawn.items():
        biggest = [0.0, 0.0]
        cpu = copy.deepcopy(card).to("cpu")
        got = {"card": run(card, toks, dev, biggest),
               "CPU": run(cpu, toks, "cpu", biggest)}
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
            else keep64(t)
        try:
            want = run(copy.deepcopy(cpu).double(), toks, "cpu", [0.0, 0.0])
        finally:
            torch.Tensor.float = keep64
        for side, logits in got.items():
            shares = [share(logits[:, i], want[:, i], cs.PARITY_TOL)
                      for i in range(5)]
            print(f"{name}: float32 {side} vs float64 CPU, share of "
                  f"PARITY_TOL at the prefill and decode steps 1-4: "
                  f"{', '.join(f'{s:.3f}' for s in shares)}")
        print(f"{name}: card vs CPU: "
              f"{share(got['card'], got['CPU'], cs.PARITY_TOL):.3f} of "
              f"PARITY_TOL; largest |dt| {biggest[0]:.4g}, largest |h| "
              f"{biggest[1]:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
