"""Full Track-A walkthrough of the paper's pipeline on one kernel, with the
PyTorch/CUDA port:

  C-loop DFG -> Algorithm 1 motifs -> Algorithm 2 hierarchical mapping
  -> cycle-accurate simulation (on the card) -> power/area/energy vs both
  baselines.

  PYTHONPATH=src python examples/torch_plaid_walkthrough.py [kernel] \\
      [unroll] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.arch import make_arch  # noqa: E402
from repro_torch.core.motifs import generate_motifs  # noqa: E402
from repro_torch.core.power_area import (energy_sweep, energy_uj,  # noqa: E402
                                         fabric_area_um2, fabric_power_uw)
from repro_torch.core.spatial import map_spatial  # noqa: E402
from repro_torch.core.workloads import (build_workload,  # noqa: E402
                                        workload_by_name)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mapping import HierarchicalMapper, NodeGreedyMapper  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", nargs="?", default="gemm")
    ap.add_argument("unroll", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    w = workload_by_name(args.kernel, args.unroll)
    g = build_workload(w)
    print(f"DFG {g.name}: {g.n_nodes} nodes ({len(g.compute_nodes)} compute, "
          f"{len(g.memory_nodes)} memory)")

    motifs, standalone = generate_motifs(g, seed=1, feasibility="strict")
    for m in motifs:
        print(f"  motif {m.kind:8s} nodes={m.nodes}")
    print(f"  standalone: {standalone}")

    plaid = HierarchicalMapper(make_arch("plaid2x2"), seed=0).map(g)
    st = NodeGreedyMapper(make_arch("st4x4"), seed=0).map(g)
    sp = map_spatial(g)
    print(f"\nPlaid 2x2      : II={plaid.ii:2d}  cycles({w.iterations} it)="
          f"{plaid.cycles(w.iterations)}")
    print(f"Spatio-temporal: II={st.ii:2d}  cycles={st.cycles(w.iterations)}")
    print(f"Spatial        : segments={sp.n_segments}  "
          f"cycles={sp.cycles(w.iterations)}")

    # both modulo mappings verify through ONE batched simulator call on the
    # device; the spatial result has no modulo mapping, so its row stays
    # analytic
    rows = energy_sweep([("plaid2x2", plaid, w.iterations),
                         ("st4x4", st, w.iterations)], device=device)
    for r in rows:
        if not r["verified"]:
            raise SystemExit(f"mapping not verified: {r}")
        print(f"{r['arch']:12s} power={r['power_uw']:7.1f}uW  "
              f"area={r['area_um2']:8.0f}um2  energy="
              f"{r['energy_uj']:8.4f}uJ  (verified, {r['sim_backend']})")
    sp_cycles = sp.cycles(w.iterations)
    print(f"{'spatial4x4':12s} power="
          f"{fabric_power_uw('spatial4x4')['total']:7.1f}uW  "
          f"area={fabric_area_um2('spatial4x4')['total']:8.0f}um2  "
          f"energy={energy_uj('spatial4x4', sp_cycles):8.4f}uJ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
