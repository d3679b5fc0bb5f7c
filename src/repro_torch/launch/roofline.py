"""Roofline analysis from the dry run on H100 terms, the port of
``repro/launch/roofline.py``.

Each cell's dry run (:mod:`repro_torch.launch.dryrun`) is traced at full
depth: a torch trace counts every layer, so no extrapolation is needed for
correctness.  The JAX package's extrapolation from small *unrolled* models
(XLA's cost analysis counts a scan body once) stays as a cross-check
(``--extrapolate``), with the same points and coefficients:

  dense/moe/ssm/vlm :  total(L) = (2-L)·C(1) + (L-1)·C(2)
  encdec            :  total(4) = -2·C(1) + 3·C(2)           (enc=dec=L)
  hybrid (zamba2)   :  total = -36·A + 5·B + 32·C with
                       A=(k=1,L=1)  B=(k=1,L=2)  C=(k=2,L=2)

Terms (NVIDIA H100 SXM5 80GB HBM3 at 700 W, from NVIDIA's data sheet):
compute = FLOPs a device / 989 TFLOP/s (dense bf16 tensor cores);
memory = bytes a device / 3.35 TB/s (HBM3); collective = the bytes of the
collectives over the ``model`` axis / 450 GB/s (NVLink 4, one direction of
its 900 GB/s) plus those over ``data`` and ``pod`` / 50 GB/s (one 400 Gb/s
InfiniBand NDR port a GPU).  The JAX package's TPU v5e terms (197 TF/s,
819 GB/s, 50 GB/s ICI) do not carry over.

The record keeps the JAX package's keys where they mean the same thing;
``hlo_flops_global`` is ``traced_flops_global`` here (there is no HLO: the
FLOPs of the traced step, kernels included, times the devices), and
``collective_s_by_axis`` splits the collective term.

Usage (``--out`` and ``--dry-dir`` have no default):
  PYTHONPATH=src python -m repro_torch.launch.roofline --sweep \\
      --out DIR --dry-dir DRYDIR [--multi-pod] [--arch A] [--extrapolate]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Dict, List, Optional, Tuple

#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12
#: H100 SXM HBM3 rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: NVLink 4 within a node, one direction (NVIDIA data sheet: 900 GB/s both)
NVLINK_BYTES_PER_S = 450e9
#: InfiniBand NDR, one 400 Gb/s port a GPU (NVIDIA DGX H100 data sheet)
IB_BYTES_PER_S = 50e9


def bound_ms(n_bytes: float, ops: float, ops_rate: float) -> Tuple[float,
                                                                   str]:
    """(ms, "bytes" or "operations"): the least time the card takes to move
    ``n_bytes`` and do ``ops`` at ``ops_rate``, whichever is larger."""
    bounds = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / ops_rate * 1e3}
    by = max(bounds, key=bounds.get)
    return bounds[by], by


def link_rate(axes: str) -> float:
    """The rate of a collective over ``axes`` (``"model"``, ``"data"``,
    ``"pod+data"``, ...): NVLink inside a node, InfiniBand across."""
    return NVLINK_BYTES_PER_S if axes == "model" else IB_BYTES_PER_S


def points_for(cfg) -> List[Tuple[str, Dict, float]]:
    """(tag, cfg overrides, combination coefficient) per family."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = L // cfg.attn_every
        # solve: A = base+m+a ; B = base+2m+2a ; C = base+2m+a
        # => m = C-A ; a = B-C ; base = 2A-B
        # total = base + L·m + n·a = (2-L)·A + (n-1)·B + (L-n)·C
        return [
            ("A", {"unroll_layers": True, "n_layers": 1, "attn_every": 1}, 2 - L),
            ("B", {"unroll_layers": True, "n_layers": 2, "attn_every": 1}, n_attn - 1),
            ("C", {"unroll_layers": True, "n_layers": 2, "attn_every": 2}, L - n_attn),
        ]
    if cfg.family == "encdec":
        E = cfg.n_enc_layers
        assert E == L, "extrapolation assumes enc==dec layer count"
        return [
            ("A", {"unroll_layers": True, "n_layers": 1, "n_enc_layers": 1}, 2 - L),
            ("B", {"unroll_layers": True, "n_layers": 2, "n_enc_layers": 2}, L - 1),
        ]
    return [
        ("A", {"unroll_layers": True, "n_layers": 1}, 2 - L),
        ("B", {"unroll_layers": True, "n_layers": 2}, L - 1),
    ]


def combine(points: List[Tuple[Dict, float]]) -> Dict[str, float]:
    """Linear combination of per-device costs across extrapolation points."""
    out = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    for rec, coef in points:
        out["flops"] += coef * rec.get("flops_per_device", 0.0)
        out["bytes"] += coef * rec.get("bytes_per_device", 0.0)
        coll = rec.get("collectives", {})
        out["coll_bytes"] += coef * sum(v["bytes"] for v in coll.values())
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6ND a training step, 2ND a prefill, 2N a decoded token
    a sequence (N active for MoE)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_active * shape.global_batch * shape.seq_len
    return 2 * n_active * shape.global_batch


def terms(rec: Dict, cfg, shape) -> Dict:
    """The roofline of one dry-run record of ``cfg`` at ``shape``."""
    n_dev = rec["mesh"]["n_devices"]
    compute_t = rec["flops_per_device"] / BF16_OPS_PER_S
    memory_t = rec["bytes_per_device"] / HBM_BYTES_PER_S
    by_axis: Dict[str, float] = {}
    for v in rec.get("collectives", {}).values():
        for axes, nbytes in v.get("by_axis", {}).items():
            by_axis[axes] = by_axis.get(axes, 0.0) + nbytes / link_rate(axes)
    coll_t = sum(by_axis.values())
    dominant = max(
        (("compute", compute_t), ("memory", memory_t), ("collective", coll_t)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(cfg, shape)
    traced_global = rec["flops_per_device"] * n_dev
    bound = max(compute_t, memory_t, coll_t)
    return {
        "flops_per_device": rec["flops_per_device"],
        "bytes_per_device": rec["bytes_per_device"],
        "coll_bytes_per_device": sum(
            v["bytes"] for v in rec.get("collectives", {}).values()),
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "collective_s_by_axis": by_axis,
        "dominant": dominant,
        "model_flops": mf,
        "traced_flops_global": traced_global,
        "useful_ratio": mf / traced_global if traced_global else None,
        "roofline_s": bound,
        "roofline_fraction": (
            (mf / n_dev / BF16_OPS_PER_S) / bound if bound > 0 else None),
    }


def _cell_path(out_dir, arch, shape, multi_pod, tag, extra=""):
    mp = "mp" if multi_pod else "sp"
    suf = f"__{extra}" if extra else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mp}__{tag}{suf}.json")


def run_point(path: str, arch, shape, multi_pod, overrides, *,
              device: str = "cuda", timeout=1800) -> Optional[Dict]:
    """One dry-run record at ``path`` (one subprocess), reused where an ok
    record is there already."""
    from repro_torch.launch import dryrun

    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            return rec
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    p = subprocess.run(
        dryrun.cell_command(arch, shape, multi_pod, path, device, overrides),
        capture_output=True, text=True, env=dryrun.subprocess_env(),
        timeout=timeout)
    if p.returncode != 0:
        print(f"[roofline FAIL] {arch} {shape} {overrides}: "
              f"{p.stderr[-500:]}")
        return None
    with open(path) as f:
        return json.load(f)


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
                 out_dir: str, dry_dir: str, extra_overrides=None,
                 extra_tag: str = "", extrapolate: bool = False,
                 device: str = "cuda") -> Optional[Dict]:
    """The roofline of one cell from its full-depth dry run (read from, or
    written to, ``dry_dir`` under the dry-run sweep's name), and with
    ``extrapolate`` the JAX package's small-model points (in ``out_dir``)
    combined beside it."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.dryrun import cell_tag

    cfg = get_config(arch)
    if extra_overrides:
        cfg = cfg.replace(**{k: v for k, v in extra_overrides.items()
                             if k not in ("n_layers", "n_enc_layers",
                                          "attn_every")})
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    suf = f"__{extra_tag}" if extra_tag else ""
    full = run_point(
        os.path.join(dry_dir, cell_tag(arch, shape_name, multi_pod) + suf
                     + ".json"),
        arch, shape_name, multi_pod, dict(extra_overrides or {}),
        device=device)
    if full is None or full.get("status") != "ok":
        return None
    out = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "extra": extra_tag, **terms(full, cfg, shape)}
    if extrapolate:
        pts = []
        for tag, ov, coef in points_for(get_config(arch)):
            ov = dict(ov, **(extra_overrides or {}))
            rec = run_point(_cell_path(out_dir, arch, shape_name, multi_pod,
                                       tag, extra_tag),
                            arch, shape_name, multi_pod, ov, device=device)
            if rec is None or rec.get("status") != "ok":
                return None
            pts.append((rec, coef))
        tot = combine(pts)
        out["extrapolated"] = tot
        out["extrapolated_flops_match"] = tot["flops"] == \
            full["flops_per_device"]
    return out


def sweep(out_dir: str, dry_dir: str, multi_pod: bool = False,
          only: Optional[str] = None, extrapolate: bool = False,
          device: str = "cuda"):
    from repro_torch.configs import ARCH_IDS, SHAPES

    out = {}
    for arch in ARCH_IDS:
        if only and arch != only:
            continue
        for shape in SHAPES:
            r = analyze_cell(arch, shape, multi_pod, out_dir=out_dir,
                             dry_dir=dry_dir, extrapolate=extrapolate,
                             device=device)
            if r is None:
                print(f"[no data] {arch} {shape}")
                continue
            out[f"{arch}__{shape}"] = r
            if "skipped" not in r:
                print(f"{arch:22s} {shape:12s} comp={r['compute_s']*1e3:8.2f}ms "
                      f"mem={r['memory_s']*1e3:8.2f}ms coll={r['collective_s']*1e3:8.2f}ms "
                      f"dom={r['dominant']:10s} frac={r['roofline_fraction'] and round(r['roofline_fraction'],3)}",
                      flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"summary_{'mp' if multi_pod else 'sp'}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--out", required=True,
                    help="the roofline points and summary")
    ap.add_argument("--dry-dir", required=True,
                    help="the full-depth dry-run records (read or written)")
    ap.add_argument("--extrapolate", action="store_true",
                    help="also combine the JAX package's small-model points")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.sweep:
        sweep(args.out, args.dry_dir, args.multi_pod, only=args.arch,
              extrapolate=args.extrapolate, device=args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
