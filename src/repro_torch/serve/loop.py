"""Batched serving loop of the port: prefill once, then decode with
greedy sampling (``repro/serve/loop.py`` with the step builders of
``repro/train/steps.py:78-93``).

PyTorch runs eagerly, so the steps are plain functions where the JAX
package jits them.  ``generate`` also reports what a serving user feels:
the prefill time (to the first token) and the decode time, each ended by a
device synchronisation on ``cuda``, and whether every logit was finite.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.kvcache import grow_cache


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache, tokens):
        """One decode step; greedy next-token."""
        new_cache, logits = model.decode_step(cache, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32)[:, None]
        return new_cache, next_tok, logits

    return serve_step


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def generate(cfg: ModelConfig, model, prompts: torch.Tensor,  # (B, T) int32
             max_new_tokens: int = 16,
             extra_batch: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Dict]:
    """Greedy-decode exactly ``max_new_tokens`` tokens per prompt (0 means
    prefill only).  Returns (tokens (B, max_new_tokens) int32, info) with
    info ``cache_length``, ``prefill_s``, ``decode_s``, ``decode_steps``
    and ``logits_finite``."""
    batch = {"tokens": prompts}
    if extra_batch:
        batch.update(extra_batch)
    device = prompts.device
    t0 = _sync(device)
    cache, logits = make_prefill_step(cfg)(model, batch)
    finite = torch.isfinite(logits).all()
    next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    t1 = _sync(device)
    info = {"prefill_s": t1 - t0, "decode_s": 0.0, "decode_steps": 0}
    if max_new_tokens <= 0:
        # exactly zero new tokens: prefill only (cache stays usable for a
        # later decode)
        tokens = torch.zeros((prompts.shape[0], 0), dtype=torch.int32,
                             device=device)
        info.update(cache_length=int(cache["length"][0]),
                    logits_finite=bool(finite))
        return tokens, info
    serve = make_serve_step(cfg)
    cache = grow_cache(cache, max_new_tokens, window=cfg.sliding_window)
    out: List[torch.Tensor] = [next_tok]
    t1 = _sync(device)
    for _ in range(max_new_tokens - 1):
        cache, next_tok, logits = serve(model, cache, next_tok)
        finite &= torch.isfinite(logits).all()
        out.append(next_tok)
    t2 = _sync(device)
    info.update(decode_s=t2 - t1, decode_steps=max_new_tokens - 1,
                cache_length=int(cache["length"][0]),
                logits_finite=bool(finite))
    return torch.cat(out, dim=1), info
