"""Fault-tolerant training loop, the port of ``repro/train/loop.py``.

  * checkpoint every N steps with an atomic publish; auto-resume from the
    latest;
  * step retry: the injected failure (``fail_hook``, a test's stand-in for
    a lost node) re-runs the step from the last good state.  Unlike the
    JAX package, which retries every ``RuntimeError``, only the hook's
    failure is retried: a kernel's refused launch or a CUDA fault raises
    ``RuntimeError`` too, and retrying it would spin for ever;
  * straggler watchdog: steps slower than ``straggler_threshold`` x the
    running median are logged with their index.  A step's time ends in a
    device synchronisation (the JAX loop's ``block_until_ready``);
  * deterministic data and kernels: (seed, step) -> batch, no float
    atomics in the kernels, and ``torch.use_deterministic_algorithms``
    while the loop runs (:func:`deterministic`), so a resumed run is
    bit-identical to a straight one.
"""
from __future__ import annotations

import contextlib
import logging
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import zoo
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib
from repro_torch.train.data import batch_for_step

log = logging.getLogger("repro_torch.train")

#: cuBLAS's deterministic workspace setting; it is read when cuBLAS first
#: runs in a process, so an entry point sets it before any CUDA work
CUBLAS_WORKSPACE = ":4096:8"


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.times: List[float] = []
        self.window = window
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.threshold * med:
                self.flagged.append(step)
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
                slow = True
        self.times.append(dt)
        return slow


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block (the
    embedding's backward sums with atomics otherwise), with
    ``CUBLAS_WORKSPACE_CONFIG`` set unless the caller set it, and without
    filling each new tensor with NaN (every kernel writes all of its
    output); the previous settings come back after."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    det = torch.utils.deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        det.fill_uninitialized_memory = before[2]


def batch_to(batch: Dict[str, np.ndarray], device: torch.device,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: integer arrays keep their
    type, floating ones (the vlm's embeddings, the encdec's audio) take
    the model's ``dtype``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(run: RunConfig, *, steps: int, rng_seed: int = 0,
          fail_hook: Optional[Callable[[int], None]] = None,
          device=None, layers: Optional[int] = None) -> Dict[str, Any]:
    """Train for ``steps`` optimizer steps on ``device`` (``cuda`` unless
    given): weights drawn from ``rng_seed`` on the device (with
    ``layers``, the first ``layers`` layers of ``run.model``:
    :func:`repro_torch.models.zoo.depth_cut`), resumed from the newest
    checkpoint in ``run.checkpoint_dir`` if there is one.
    ``fail_hook(step)`` runs before each step; a ``RuntimeError`` it raises
    is logged and the step retried.  Returns the model, its params, the
    optimizer state, the losses and gradient norms, each step's metrics
    (the loss's parts, ``grad_norm``, ``lr``), the flagged
    stragglers, the final step and each step's seconds."""
    device = resolve_device(device)
    with deterministic():
        gen = torch.Generator(device=device).manual_seed(rng_seed)
        model = zoo.init_model(run.model, gen, device, layers=layers)
        cfg = model.cfg
        ocfg = steps_lib.adamw_config(cfg, run)
        opt_state = opt_lib.init_opt_state(model.params, ocfg)

        start = 0
        last = ckpt_lib.latest_step(run.checkpoint_dir)
        if last is not None:
            ckpt_lib.restore(run.checkpoint_dir, last,
                             {"params": model.params,
                              "opt_state": opt_state})
            start = last
            log.info("resumed from step %d", start)

        step_fn = steps_lib.make_train_step(cfg, run)
        wd = StragglerWatchdog(run.straggler_threshold)
        losses: List[float] = []
        grad_norms: List[float] = []
        history: List[Dict[str, float]] = []
        step = start
        while step < steps:
            batch = batch_to(batch_for_step(cfg, run.shape, run.seed, step),
                             device, model.emb.dtype)
            t0 = time.perf_counter()
            if fail_hook is not None:
                try:
                    fail_hook(step)  # may raise to simulate node loss
                except RuntimeError as e:
                    log.warning("step %d failed (%s); retrying", step, e)
                    continue
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            _sync(device)
            wd.observe(step, time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
            losses.append(history[-1]["loss"])
            grad_norms.append(history[-1]["grad_norm"])
            step += 1
            if run.checkpoint_every and step % run.checkpoint_every == 0:
                ckpt_lib.save(
                    run.checkpoint_dir, step,
                    {"params": model.params, "opt_state": opt_state,
                     "extra": {"losses_tail": losses[-4:]}},
                    keep=run.keep_checkpoints)
    return {
        "model": model,
        "params": model.params,
        "opt_state": opt_state,
        "losses": losses,
        "grad_norms": grad_norms,
        "metrics": history,
        "stragglers": wd.flagged,
        "final_step": step,
        "step_s": wd.times,
    }
