"""Training launcher of the port: random weights from a seed, synthetic
batches from (seed, step), AdamW, checkpoints, on the card.

    python -m repro_torch.launch.train --arch llama3_2_3b --batch 4 \\
        --seq 4096 --steps 4                 # full config, cuda
    python -m repro_torch.launch.train --arch granite_moe_1b_a400m \\
        --batch 4 --seq 4096 --steps 4       # moe, full config
    python -m repro_torch.launch.train --arch falcon_mamba_7b --layers 8 \\
        --batch 4 --seq 4096 --steps 4       # ssm, its first 8 layers
    python -m repro_torch.launch.train --arch llama3_2_3b --smoke \\
        --steps 3 --device cpu               # reduced, on the host

Every family trains: dense, vlm, moe, ssm (Mamba-1), hybrid (Mamba-2 and
the shared block) and encdec.  
The flags are ``repro/launch/train.py``'s plus ``--device`` and
``--layers`` (a depth cut: the first N layers, each at the full model's
weight scale, :func:`repro_torch.models.zoo.depth_cut`).  Without
``--smoke`` the full config runs (the JAX launcher's smoke flag is the only
way it runs; here it is off unless given) at ``--shape``'s sequence and
global batch (:data:`repro_torch.configs.SHAPES`), and ``--seq`` and
``--batch``, where given, replace them: that is how a full config is cut
to one card (the JAX launcher reads them only with ``--smoke``).  With
``--smoke`` the shape is ``--seq`` x ``--batch``, 64 x 4 unless given.  Prints the final step, the losses and the stragglers, then a
``time:`` line: the median step seconds over the steps after the first
(each ends in a device synchronisation), tokens a second, and on a card
the model FLOPs a step over the step time as a share of the dense bf16
rate (:data:`repro_torch.launch.roofline.BF16_OPS_PER_S`) and the peak
device memory.
"""
from __future__ import annotations

import argparse
import logging
import os
import statistics
import sys
from typing import Dict, List, Optional

import torch

from repro_torch.configs import SHAPES, RunConfig, get_config, smoke_config
from repro_torch.configs.base import ShapeSpec, default_checkpoint_dir
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import BF16_OPS_PER_S
from repro_torch.train.loop import CUBLAS_WORKSPACE, train


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES),
                    help="the full config's sequence and global batch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (smoke_config)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence length (replaces --shape's)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (replaces --shape's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut)")
    ap.add_argument("--ckpt-dir", default=default_checkpoint_dir())
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def resolve_shape(args: argparse.Namespace) -> ShapeSpec:
    """The run's shape: with ``--smoke`` ``--seq`` x ``--batch`` (64 x 4
    unless given), else ``SHAPES[--shape]`` with ``--seq`` and ``--batch``
    replacing its sequence and global batch where given (the name gains
    the cut, as ``train_4k@4x4096``)."""
    if args.smoke:
        return ShapeSpec("smoke", args.seq or 64, args.batch or 4, "train")
    base = SHAPES[args.shape]
    seq = args.seq or base.seq_len
    batch = args.batch or base.global_batch
    name = base.name if (seq, batch) == (base.seq_len, base.global_batch) \
        else f"{base.name}@{batch}x{seq}"
    return ShapeSpec(name, seq, batch, base.kind)


def causal_pairs(T: int, window: int = 0) -> int:
    """The (query, key) pairs a causal (windowed) attention over T tokens
    computes."""
    if not window or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def model_flops(cfg, batch: int, seq: int) -> Dict[str, float]:
    """The model FLOPs of one training step of ``batch`` x ``seq`` tokens,
    forward and backward: 6 x parameters x the tokens they act on for the
    products (the tied embedding counts once, as the output head), and 12
    x head dim x query heads x (query, key) pairs x batch for attention's
    two products.  Per family:

    * dense, vlm: every parameter on every token; causal (windowed) pairs
      in every layer;
    * moe: the parameters a token uses (``param_count(active_only=
      True)``: top_k of the experts);
    * hybrid: the shared block counted once a site (n_layers //
      attn_every), and causal pairs at the sites only;
    * encdec: the encoder's parameters and the decoder's cross-attention
      ``wk`` / ``wv`` on the ``enc_seq`` audio frames, the rest of the
      decoder and the head on the ``seq`` tokens; all enc_seq^2 pairs in
      each encoder layer, causal pairs and seq x enc_seq cross pairs in
      each decoder layer;
    * ssm: the products only.

    The SSM scans (Mamba-1's recurrence, Mamba-2's chunked SSD) are left
    out: elementwise work and batched float32 products off the bf16
    tensor cores, not model FLOPs of the products above."""
    tokens = batch * seq
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    # what param_count counts besides the stacked decoder layers: the
    # hybrid's shared block, the encdec's encoder (and the embedding)
    unstacked = cfg.replace(n_layers=0).param_count() - cfg.vocab_size * d
    if cfg.family == "encdec":
        cross_kv = cfg.n_layers * 2 * d * cfg.n_kv_heads * hd
        on_frames = unstacked + cross_kv
        dense = 6.0 * (on_frames * batch * cfg.enc_seq
                       + (cfg.param_count() - on_frames) * tokens)
        pairs = (cfg.n_enc_layers * cfg.enc_seq ** 2
                 + cfg.n_layers * (causal_pairs(seq) + seq * cfg.enc_seq))
    else:
        params = cfg.param_count(active_only=cfg.family == "moe")
        layers = cfg.n_layers
        if cfg.family == "hybrid":
            layers = cfg.n_layers // cfg.attn_every
            params += (layers - 1) * unstacked
        dense = 6.0 * params * tokens
        pairs = 0 if cfg.family == "ssm" else \
            layers * causal_pairs(seq, cfg.sliding_window)
    pair_flops = 12.0 * hd * H * batch
    attn = pair_flops * pairs
    return {"products": dense, "attention": attn, "total": dense + attn}


def run(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, train, print the report; returns the training
    result with the config, the shape and the timing figures."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    args = parse_args(argv)
    device = resolve_device(args.device)
    shape = resolve_shape(args)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run_cfg = RunConfig(model=cfg, shape=shape, checkpoint_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        total_steps=max(args.steps, 10),
                        grad_compression=args.grad_compression)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = train(run_cfg, steps=args.steps, device=device, layers=args.layers)
    cfg = out["model"].cfg
    n_params = sum(p.numel() for p in out["model"].parameters())
    depth = "" if args.layers is None else \
        f", depth cut to {args.layers} layers"
    print(f"model: {cfg.arch_id} ({'smoke' if args.smoke else 'full'}"
          f"{depth}) "
          f"{cfg.n_layers}L d_model={cfg.d_model} vocab={cfg.vocab_size}, "
          f"{n_params} params, remat={cfg.remat}, {shape.name}: batch "
          f"{shape.global_batch} x {shape.seq_len} on {device}")
    print(f"final step {out['final_step']}  losses: "
          f"{[round(v, 4) for v in out['losses']]}  grad norms: "
          f"{[round(v, 4) for v in out['grad_norms']]}  stragglers: "
          f"{out['stragglers']}")
    times = out["step_s"][1:] or out["step_s"]
    report = {"cfg": cfg, "shape": shape, **out}
    if times:
        step_s = statistics.median(times)
        tokens = shape.global_batch * shape.seq_len
        flops = model_flops(cfg, shape.global_batch, shape.seq_len)
        line = (f"time: median step {step_s:.6f} s over {len(times)} steps "
                f"after the first; {tokens / step_s:.1f} tokens/s")
        report.update(step_s_median=step_s, tokens_per_s=tokens / step_s,
                      model_flops=flops)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            mfu = flops["total"] / step_s / BF16_OPS_PER_S
            line += (f"; model FLOPs {flops['total']:.4g} a step "
                     f"({flops['products']:.4g} products + "
                     f"{flops['attention']:.4g} attention), "
                     f"{100 * mfu:.2f}% of the {BF16_OPS_PER_S / 1e12:.0f} "
                     f"TFLOP/s dense bf16 peak (H100 SXM data sheet); peak "
                     f"device memory {peak:.3f} GiB")
            report.update(mfu=mfu, peak_gib=peak)
        print(line)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
