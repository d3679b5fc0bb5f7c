"""The reference's prefill: the configuration's model over whole prompts
in float32, one layer at a time (each layer's weights cast from the
served bfloat16 as it is reached), so that a 40-layer model fits beside
the served one."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

from bench.reference import model as M


@torch.no_grad()
def layers(conf: Dict, params: Dict, tokens: torch.Tensor,
           quant: Optional[str] = None
           ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Over prompts ``tokens`` (B, T): yields each layer's keys after RoPE
    and its values, (B, T, kv heads x head dim), then, alone, the final
    normed hidden states (B, T, d)."""
    M.no_tf32()
    a = M.Arch(conf)
    B, T = tokens.shape
    x = params["emb"][tokens.long()].float()
    for i in range(a.L):
        w = M.layer_weights(params["layers"], i, cast=lambda t: t.float())
        x, _, k, v = M.block(a, w, x, quant, {}, i)
        del w
        yield k.reshape(B, T, -1), v.reshape(B, T, -1)
    yield (M.rms_norm(x, params["ln_f"].float(), a.eps),)


@torch.no_grad()
def logits(h: torch.Tensor, emb: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Logits (n, V) of hidden states h (n, d) through the tied head."""
    return M.mm(h, emb.float().T, quant)
