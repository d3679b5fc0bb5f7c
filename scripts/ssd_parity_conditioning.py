#!/usr/bin/env python3
"""How well float32 holds zamba2_1_2b's card-vs-CPU parity, with the SSD's
decays taken as differences of float64 prefix sums rounded once (the
port) or as differences of float32 prefix sums (the JAX package's
arithmetic).

    python3 scripts/ssd_parity_conditioning.py           # on one card
    python3 scripts/ssd_parity_conditioning.py --smoke   # smoke width, CPU

Builds the first 7 layers of zamba2_1_2b in float32, sliced from the full
38-layer draw with ``ssm_chunk`` 64 (``chip_smoke.first_layers``, the
model of ``chip_smoke.py``'s parity phase).  For each form of
``repro_torch.models.ssm._ssd`` it prefills 2 x 128 tokens and takes 4
teacher-forced decode steps on the card (the kernels) and on the CPU (the
plain versions), and once on the CPU in float64 (``Tensor.float`` keeps a
float64 tensor float64 for that run).  Prints, per form, how far each
float32 run is from the float64 one and from the other side as a share of
``chip_smoke.PARITY_TOL``, and the most negative prefix sum of a chunk.
With ``--smoke`` the "card" is a second CPU copy.
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


def prefix_difference_ssd(la, Bm, Cm, xh, h, Q: int):
    """``_ssd`` with seg(t, s) = cum_t - cum_s, as ``repro/models/ssm.py``
    computes it."""
    import torch

    T = la.shape[-1]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=la.device).tril()
    ys = []
    for t0 in range(0, T, Q):
        cum = la[..., t0:t0 + Q].cumsum(-1)
        bc, cc = Bm[:, None, t0:t0 + Q], Cm[:, None, t0:t0 + Q]
        xc = xh[:, :, t0:t0 + Q]
        decay = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
            ~causal, float("-inf")).exp_()
        y = ((cc @ bc.transpose(-1, -2)) * decay) @ xc \
            + (cc @ h.transpose(-1, -2)) * cum.exp()[..., None]
        dec_from = (cum[..., -1:] - cum).exp()
        h = cum[..., -1].exp()[..., None, None] * h \
            + (xc * dec_from[..., None]).transpose(-1, -2) @ bc
        ys.append(y)
    return torch.cat(ys, dim=2), h


def run(model, toks, dev, form, lowest):
    """Prefill and 4 teacher-forced decode logits of ``model`` on ``dev``
    with ``form`` as the SSD, (B, 5, V); ``lowest[0]`` takes the most
    negative in-chunk prefix sum."""
    import torch

    from repro_torch.models import ssm

    real = ssm._ssd

    def watched(la, Bm, Cm, xh, h, Q):
        lowest[0] = min(lowest[0], la.unflatten(-1, (-1, Q)).cumsum(-1)
                        .min().item())
        # the model's zero state is float32 even in the float64 run
        return form(la, Bm, Cm, xh, h.to(la.dtype), Q)

    ssm._ssd = watched
    try:
        with torch.inference_mode():
            cache, logits = model.prefill({"tokens": toks[:, :128].to(dev)})
            out = [logits]
            for i in range(4):
                cache, logits = model.decode_step(
                    cache, toks[:, 128 + i:129 + i].to(dev))
                out.append(logits)
    finally:
        ssm._ssd = real
    return torch.cat(out, dim=1).cpu()


def main(argv) -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import ssm

    smoke = "--smoke" in argv
    dev = "cpu" if smoke else "cuda"
    if not smoke:
        if not torch.cuda.is_available():
            print("needs an NVIDIA card (or --smoke)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0))
    full = (smoke_config if smoke else get_config)("zamba2_1_2b")
    if smoke:
        full = full.replace(n_layers=38, attn_every=6)
    full = full.replace(ssm_chunk=cs.PARITY_SSM_CHUNK)
    card = cs.first_layers(full, 7, torch.float32, dev)
    cpu = copy.deepcopy(card).to("cpu")
    toks = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, full.vocab_size, (2, 132)).astype(np.int32))
    keep64 = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
        else keep64(t)
    try:
        want = run(copy.deepcopy(cpu).double(), toks, "cpu", ssm._ssd, [0.0])
    finally:
        torch.Tensor.float = keep64
    forms = {"float64 prefix differences (the port)": ssm._ssd,
             "prefix differences (the JAX form)": prefix_difference_ssd}
    for name, form in forms.items():
        lowest = [0.0]
        got = {"card": run(card, toks, dev, form, lowest),
               "CPU": run(cpu, toks, "cpu", form, lowest)}
        for side, logits in got.items():
            shares = [share(logits[:, i], want[:, i], cs.PARITY_TOL)
                      for i in range(5)]
            print(f"{name}: float32 {side} vs float64 CPU, share of "
                  f"PARITY_TOL at the prefill and decode steps 1-4: "
                  f"{', '.join(f'{s:.3f}' for s in shares)}")
        print(f"{name}: card vs CPU: "
              f"{share(got['card'], got['CPU'], cs.PARITY_TOL):.3f} of "
              f"PARITY_TOL; most negative prefix sum of a chunk "
              f"{lowest[0]:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
