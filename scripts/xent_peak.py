#!/usr/bin/env python3
"""The device memory of the training loss's chunked cross-entropy at
llama3_2_3b's train shape, for two ways of reading each token's label
logit.

    python3 scripts/xent_peak.py      # on one card

Hidden states (4, 4096, 3072) and the tied embedding (128256, 3072) in
bf16 and labels from seed 0, chunks of 8192 tokens (the config's
``logits_chunk``), under ``train.loop.deterministic()``:

- ``cross_entropy``: ``layers.chunked_xent`` as the port runs it;
- ``indexing``: the same loop with each chunk's sum taken as
  ``logsumexp(logits) - logits[arange, labels]`` (advanced indexing).

For each form: the loss and its backward twice, the gradients compared bit
for bit; the peak of ``torch.cuda.max_memory_allocated`` over one loss and
backward above what was allocated before it, in GiB; then the two forms'
losses and gradients against each other.  Exit 0 when both are
deterministic; 1 otherwise; 2 without a card.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _indexing_chunk(hh, yy, emb):
    import torch

    logits = (hh @ emb.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits[torch.arange(hh.shape[0], device=hh.device), yy]
    return torch.sum(lse - gold)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.models import layers as L
    from repro_torch.train.loop import deterministic

    B, T, D, V, chunk = 4, 4096, 3072, 128256, 8192
    rng = np.random.default_rng(0)
    dev, bf = "cuda", torch.bfloat16
    h = torch.from_numpy(rng.standard_normal((B, T, D), np.float32)).to(
        dev, bf)
    emb = torch.from_numpy((rng.standard_normal((V, D), np.float32) * 0.02)
                           ).to(dev, bf)
    y = torch.from_numpy(rng.integers(0, V, (B, T))).to(dev)
    ported = L._xent_chunk

    def run(chunk_fn):
        L._xent_chunk = chunk_fn
        try:
            hh = h.clone().requires_grad_(True)
            ee = emb.clone().requires_grad_(True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss = L.chunked_xent(hh, ee, y, chunk)
            loss.backward()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            return loss.detach(), hh.grad, ee.grad, peak
        finally:
            L._xent_chunk = ported

    print(f"chunked_xent at ({B}, {T}, {D}) x vocab {V}, chunks of {chunk}, "
          f"bf16 on {torch.cuda.get_device_name(0)}")
    results, ok = {}, True
    with deterministic():
        for name, fn in (("cross_entropy", ported),
                         ("indexing", _indexing_chunk)):
            first, again = run(fn), run(fn)
            same = all(torch.equal(a, b) for a, b in zip(first[:3],
                                                         again[:3]))
            ok &= same
            results[name] = first
            print(f"xent: {name}: loss {first[0].item():.9f}, peak above "
                  f"the inputs {first[3]:.6f} / {again[3]:.6f} GiB, twice "
                  f"{'bitwise equal' if same else 'DIFFERENT'}")
    a, b = results["cross_entropy"], results["indexing"]
    for name, u, w in zip(("loss", "d hidden", "d emb"), a[:3], b[:3]):
        diff = (u.float() - w.float()).abs().max().item()
        print(f"xent: cross_entropy vs indexing, {name}: max abs diff "
              f"{diff:.6g}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
