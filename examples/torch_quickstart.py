"""Quickstart of the PyTorch/CUDA port: the two tracks of this repo in a
minute, on the card by default.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

Track A compiles a TABLE2 workload onto the Plaid fabric and proves the
mapping cycle by cycle (one ``sim_loop`` launch on the card); Track B
trains a reduced qwen3_14b for a few steps through the port's kernels; the
bridge runs Algorithm 1 over a transformer block's aten graph.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.compiler.artifact import CompileResult  # noqa: E402
from repro_torch.compiler.pipeline import (compile, job_grid,  # noqa: E402
                                           list_mappers)
from repro_torch.configs import RunConfig, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.fusion import fusion_report  # noqa: E402
from repro_torch.core.motifs import (generate_motifs,  # noqa: E402
                                     motif_cover_stats)
from repro_torch.core.power_area import energy_uj, headline_ratios  # noqa: E402
from repro_torch.core.workloads import (build_workload,  # noqa: E402
                                        workload_by_name)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402


def block(x, w1, w3, w2, scale):
    h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * scale
    y = torch.nn.functional.silu(h @ w1) * (h @ w3)
    return x + y @ w2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"=== Track A: Plaid (paper-faithful), on {device} ===")
    print("registered mappers:", list_mappers())
    print("evaluation grid:", job_grid())
    w = workload_by_name("atax", 2)
    g = build_workload(w)
    motifs, _ = generate_motifs(g, seed=1)
    print("Algorithm-1 motif cover:", motif_cover_stats(g, motifs))
    result = compile("atax", unroll=2, arch="plaid2x2", mapper="hierarchical",
                     seed=0, verify=True, device=device)
    print(f"compiled onto Plaid 2x2: II={result.ii}, makespan="
          f"{result.makespan}, verified={result.verified}")
    if not result.verified:
        raise SystemExit("the compiled mapping did not verify")
    # the artifact round-trips through JSON and re-verifies without P&R
    with tempfile.TemporaryDirectory() as tmp:
        path = result.save(os.path.join(tmp, "atax_u2.json"))
        CompileResult.load(path).simulate(iterations=3, device=device)
    print("loaded artifact re-simulates against the DFG oracle (no P&R "
          "re-run)")
    print(f"{w.iterations} iterations -> {result.cycles} cycles, "
          f"{energy_uj('plaid2x2', result.cycles):.3f} uJ on the Plaid fabric")
    print("derived headline ratios:",
          {k: round(v, 3) for k, v in headline_ratios().items()})

    print(f"\n=== Track B: the LM framework (smoke config), on {device} ===")
    cfg = smoke_config("qwen3_14b").replace(n_layers=2)
    with tempfile.TemporaryDirectory() as ckpt:
        run = RunConfig(model=cfg, shape=ShapeSpec("smoke", 32, 2, "train"),
                        checkpoint_dir=ckpt, checkpoint_every=0,
                        learning_rate=3e-3, total_steps=20)
        out = train(run, steps=args.steps, device=device)
    print("losses:", [round(v, 3) for v in out["losses"]])

    print("\n=== Bridge: motif fusion pass over an aten graph ===")
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    print(fusion_report(block, meta(4, 16), meta(16, 32), meta(16, 32),
                        meta(32, 16), meta(16)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
