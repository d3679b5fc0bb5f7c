"""Batched serving across architecture families with the PyTorch/CUDA
port (smoke configs; on the card by default).

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.loop import generate  # noqa: E402

ARCHS = ("llama3_2_3b", "falcon_mamba_7b", "zamba2_1_2b", "h2o_danube_3_4b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--new-tokens", type=int, default=6)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in ARCHS:
        cfg = smoke_config(arch)
        gen = torch.Generator(device=device).manual_seed(0)
        model = zoo.init_model(cfg, gen, device)
        prompts = torch.randint(0, cfg.vocab_size, (4, 12),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32).to(device)
        tokens, info = generate(cfg, model, prompts,
                                max_new_tokens=args.new_tokens)
        if not info["logits_finite"]:
            raise SystemExit(f"{arch}: non-finite logits")
        print(f"{arch:18s} family={cfg.family:7s} generated "
              f"{tuple(tokens.shape)} cache_len={info['cache_length']}  "
              f"sample={tokens[0].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
