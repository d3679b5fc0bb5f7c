#!/usr/bin/env python3
"""How well float32 can hold a served model's card-vs-CPU parity: the
prefill and teacher-forced decode logits of ``chip_smoke.py``'s serve
parity phase on the card, on the CPU and on the CPU in float64.

    python3 scripts/serve_parity_conditioning.py --arch h2o_danube_3_4b
    python3 scripts/serve_parity_conditioning.py --arch llama3_2_3b --smoke

Builds the parity phase's float32 model of ``--arch``
(``chip_smoke.serve_parity_model``: its ``PARITY_LAYERS`` at full width)
and its inputs (``chip_smoke.parity_inputs``: 2 x 128 prompt tokens, 1 x
4600 for h2o_danube_3_4b, and 4 tokens to feed), then prefills and takes
4 teacher-forced decode steps on the card (the kernels), on the CPU (the
plain versions) and on the CPU in float64 (``Tensor.float`` keeps a
float64 tensor float64 for that run; positions are cast to float32 as
RoPE takes them, and multiply float64 frequencies).  Prints, for the
prefill logits, the
decode logits and the full forward's, each pair's largest difference as
a share of ``chip_smoke.PARITY_TOL``, and the largest |logit|.  With
``--smoke`` the config is the arch's smoke config and the "card" a second
CPU copy.
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


def logits(cs, model, toks, extra, dev):
    """(prefill, decode, forward) logits of the parity phase's run."""
    import torch

    P = toks.shape[1] - 4
    extra = {k: v.to(dev) for k, v in extra.items()}
    toks = toks.to(dev)
    with torch.inference_mode():
        pre = model.prefill({"tokens": toks[:, :P], **extra})[1]
    dec, full = cs.teacher_forced(model, toks[:, :P], toks[:, P:], 4, extra)
    return pre, dec, full


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import smoke_config
    from repro_torch.train.tree import tree_map

    arch = argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "h2o_danube_3_4b"
    smoke = "--smoke" in argv
    dev = "cpu" if smoke else "cuda"
    if not smoke:
        if not torch.cuda.is_available():
            print("needs an NVIDIA card (or --smoke)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
    if smoke:
        cfg = smoke_config(arch)
        gen = torch.Generator().manual_seed(cs.SEED)
        from repro_torch.models import zoo

        card = zoo.init_model(cfg, gen, "cpu", torch.float32)
    else:
        card = cs.serve_parity_model(arch, dev)
    cfg = card.cfg
    cpu = copy.deepcopy(card).to("cpu")
    f64 = copy.deepcopy(cpu)
    f64.params = tree_map(lambda t: t.double(), f64.params)
    f64 = f64.double()
    toks, extra = cs.parity_inputs(arch, cfg)
    runs = {"card": logits(cs, card, toks, extra, dev),
            "cpu": logits(cs, cpu, toks, extra, "cpu")}
    real_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else real_float(self, *a, **kw))
    try:
        runs["f64"] = logits(cs, f64, toks,
                             {k: v.double() if v.is_floating_point() else v
                              for k, v in extra.items()}, "cpu")
    finally:
        torch.Tensor.float = real_float
    where = "cpu (smoke)" if smoke else torch.cuda.get_device_name(0)
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, prompt "
          f"{tuple(toks[:, :-4].shape)} + 4 fed, card = {where}")
    for i, what in enumerate(("prefill", "decode", "forward")):
        c, h, d = (runs[n][i] for n in ("card", "cpu", "f64"))
        print(f"{what} logits (largest |logit| {d.abs().max().item():.6g}): "
              f"share of PARITY_TOL card vs cpu "
              f"{share(c, h, cs.PARITY_TOL):.3f}, card vs f64 "
              f"{share(c, d, cs.PARITY_TOL):.3f}, cpu vs f64 "
              f"{share(h, d, cs.PARITY_TOL):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
