"""KV-cache utilities of the port (``repro/serve/kvcache.py``).

``grow_cache`` pads a prefill-produced cache with empty decode headroom:
prefill allocates exactly the prompt length, serving extends it once before
decoding, and ``decode_step`` then writes each new slot in place (the JAX
package instead rebuilds the cache each step under buffer donation).
Sliding-window ring buffers are already window-bounded and wrap correctly.
"""
from __future__ import annotations

from typing import Dict

import torch


def grow_cache(cache: Dict, extra: int, *, window: int = 0) -> Dict:
    if extra <= 0 or "k" not in cache:
        return cache
    S = cache["k"].shape[-2]
    if window:
        # a window-bounded ring never needs to exceed the window; a
        # prompt-sized cache below the window still must grow
        extra = min(window, S + extra) - S
        if extra <= 0:
            return cache
    out = dict(cache)
    for key in ("k", "v"):
        if key in out:
            t = out[key]  # (..., B, S, kvd): grow S
            room = t.new_zeros(t.shape[:-2] + (extra, t.shape[-1]))
            out[key] = torch.cat([t, room], dim=-2)
    if "pos" in out:
        p = out["pos"]
        out["pos"] = torch.cat([p, p.new_full((p.shape[0], extra), -1)],
                               dim=1)
    return out
