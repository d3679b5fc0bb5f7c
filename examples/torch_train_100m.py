"""End-to-end driver of the PyTorch/CUDA port: train a ~100M-parameter
llama-family model, on the card by default.

Full run (a few hundred steps):
  PYTHONPATH=src python examples/torch_train_100m.py --steps 300

CI-scale validation:
  PYTHONPATH=src python examples/torch_train_100m.py --steps 3 --seq 128 \\
      --batch 4 [--device cpu]

The run exercises the port's training substrate end to end: deterministic
data pipeline, AdamW + cosine schedule, checkpoint/auto-resume, straggler
watchdog, and (optionally) int8 gradient compression.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402


def model_100m() -> ModelConfig:
    return ModelConfig(
        arch_id="llama_100m",
        family="dense",
        n_layers=10,
        d_model=640,
        n_heads=10,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=32_000,
        rope_theta=10_000.0,
        remat="nothing",
        logits_chunk=2048,
        attn_chunk=256,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m()
    print(f"model: {cfg.param_count()/1e6:.1f}M params on {device}")
    run = RunConfig(
        model=cfg,
        shape=ShapeSpec("train100m", args.seq, args.batch, "train"),
        learning_rate=args.lr,
        warmup_steps=20,
        total_steps=max(args.steps, 100),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=50,
        grad_compression="int8" if args.compress else "none",
    )
    out = train(run, steps=args.steps, device=device)
    losses = out["losses"]
    print(f"steps {out['final_step']}  first losses {losses[:3]}  "
          f"last {losses[-3:]}")
    print(f"stragglers flagged: {out['stragglers']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
