"""Deterministic synthetic-token pipeline with background prefetch, the
port of ``repro/train/data.py``.

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the JAX package draws it, so both packages train on the same bytes and
a restarted job resumes bit-identically.  Batches are numpy arrays; the
loop moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


def batch_for_step(cfg: ModelConfig, shape: ShapeSpec, seed: int,
                   step: int) -> Dict[str, np.ndarray]:
    """The batch for one optimizer step (global view): tokens and labels
    (the tokens shifted by one) for the dense family, embeddings, M-RoPE
    positions and random labels for the vlm, audio frames, tokens and
    labels for the encdec."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B, T = shape.global_batch, shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal(
            (B, T, cfg.d_model), np.float32).astype(np.float32) * 0.02
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
        out["positions"] = np.stack([pos, pos, pos], axis=1)
    elif cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), np.float32).astype(
                np.float32) * 0.02
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, T),
                                     dtype=np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, T),
                                     dtype=np.int32)
    if "tokens" in out:
        out["labels"] = np.roll(out["tokens"], -1, axis=1)
    else:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, T),
                                     dtype=np.int32)
    return out


class Prefetcher:
    """Background-thread double buffering: batches from ``start_step`` on,
    ``depth`` ahead of the consumer."""

    def __init__(self, cfg, shape, seed: int, start_step: int = 0,
                 depth: int = 2):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, self.shape, self.seed, step)
            try:
                self.q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def next(self):
        """(step, batch) of the next step."""
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
