"""Serving launcher of the port: random weights from a seed, a batch of
random prompts, greedy decoding on the card, for every ported family
(dense, vlm, moe, ssm, hybrid, encdec).

    python -m repro_torch.launch.serve --arch llama3_2_3b --batch 4 \\
        --prompt-len 500 --new-tokens 32               # full config, cuda
    python -m repro_torch.launch.serve --arch llama3_2_3b --smoke \\
        --device cpu                                   # reduced, on the host
    python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \\
        --batch 4 --prompt-len 500 --new-tokens 32     # MoE, full config
    python -m repro_torch.launch.serve --arch falcon_mamba_7b --smoke \\
        --device cpu                                   # Mamba-1, reduced
    python -m repro_torch.launch.serve --arch zamba2_1_2b --batch 4 \\
        --prompt-len 500 --new-tokens 32               # Mamba-2 hybrid
    python -m repro_torch.launch.serve --arch whisper_tiny --batch 4 \\
        --prompt-len 224 --new-tokens 32               # encoder-decoder
    python -m repro_torch.launch.serve --arch qwen2_vl_72b --layers 8 \\
        --batch 4 --prompt-len 500 --new-tokens 32     # vlm, 8 layers

Without ``--smoke`` the full config runs (the JAX launcher's ``--smoke``
is always on; here it is off unless given); ``--layers N`` keeps its first
N layers, each at the full model's weight scale
(:func:`repro_torch.models.zoo.depth_cut`).  Prompts are drawn with numpy
from ``--seed``, and after them the vlm's embeddings and the encdec's
audio-frame embeddings (B, enc_seq, d_model), both in bfloat16; weights
with a ``torch.Generator`` seeded from it on the device, in each
parameter's spec dtype (bfloat16; float32 for the MoE router and the
SSMs' ``dt_bias``, ``A_log`` and ``Dskip``).  Prints the
generated tokens, the cache length, the prefill time and the decode time
per token.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import zoo
from repro_torch.serve.loop import generate

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (smoke_config)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, serve, print the report; returns what was built and
    produced (config, model, prompts, tokens, info, wall times)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = zoo.init_model(cfg, gen, device, layers=args.layers)
    cfg = model.cfg
    rng = np.random.default_rng(args.seed)
    B, T = args.batch, args.prompt_len
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(device)
    extra = None
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
        extra = {
            "embeds": torch.from_numpy(
                rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
            ).to(device=device, dtype=torch.bfloat16),
            "positions": torch.from_numpy(
                np.stack([pos, pos, pos], axis=1).copy()).to(device),
        }
    elif cfg.family == "encdec":
        extra = {"audio_embeds": torch.from_numpy(
            rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
                np.float32)).to(device=device, dtype=torch.bfloat16)}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tokens, info = generate(cfg, model, prompts,
                            max_new_tokens=args.new_tokens, extra_batch=extra)
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = " and ".join(sorted({str(p.dtype).split(".")[-1]
                                  for p in model.parameters()}))
    per_tok = info["decode_s"] / max(info["decode_steps"], 1)
    print(f"model: {cfg.arch_id} ({'smoke' if args.smoke else 'full'}) "
          f"{cfg.n_layers}L d_model={cfg.d_model} vocab={cfg.vocab_size}, "
          f"{n_params} params in {dtypes} on {device}; set-up "
          f"{setup_s:.3f} s")
    print("generated:", tokens.tolist())
    print(f"info: cache_length={info['cache_length']} "
          f"logits_finite={info['logits_finite']}")
    print(f"time: prefill {info['prefill_s'] * 1e3:.3f} ms for {B}x{T} "
          f"tokens; decode {per_tok * 1e3:.3f} ms per token "
          f"({info['decode_steps']} steps)")
    return {"cfg": cfg, "model": model, "prompts": prompts, "tokens": tokens,
            "info": info, "extra_batch": extra, "setup_s": setup_s}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
