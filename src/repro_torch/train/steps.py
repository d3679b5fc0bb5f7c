"""Training step functions of the port (``repro/train/steps.py``).

PyTorch runs eagerly, so a step is a plain function where the JAX package
jits one.  A step takes the model of any family (``params``, the tree its
parameters view, is what the optimizer updates, in place), the optimizer
state and a batch of tensors, and returns them with its metrics.  The
gradient of each leaf lands in the model's gradient tree (its
``grad_views``, :func:`repro_torch.models.dense.grad_views`: a slice a
layer for the stacked trees, one leaf for a tree used at many sites, the
hybrid's shared block), zeroed before each backward.  The prefill and
decode steps are ``repro_torch.serve.loop``'s.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import zoo
from repro_torch.parallel.compression import compress_tree_int8
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import leaves, slices, tree_map


def adamw_config(cfg: ModelConfig, run: RunConfig) -> opt_lib.AdamWConfig:
    """The optimizer of a run: its training knobs and the model's state
    dtype."""
    return opt_lib.AdamWConfig(
        learning_rate=run.learning_rate,
        weight_decay=run.weight_decay,
        grad_clip=run.grad_clip,
        warmup_steps=run.warmup_steps,
        total_steps=run.total_steps,
        state_dtype=cfg.opt_state_dtype,
    )


def grads_of(model: torch.nn.Module) -> Dict:
    """The model's gradient tree, made (and training turned on) at
    the first call."""
    if getattr(model, "grads", None) is None:
        model.grads = model.grad_views()
    return model.grads


def value_and_grad(cfg: ModelConfig, model: torch.nn.Module,
                   batch: Dict):
    """(loss, metrics, grads): the loss of ``batch`` and, in the model's
    gradient tree (zeroed first), its gradient with respect to
    every parameter: ``jax.value_and_grad`` of ``zoo.loss_fn``."""
    grads = grads_of(model)
    for g in leaves(grads):
        g.zero_()
    loss, metrics = zoo.loss_fn(cfg, model, batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """One optimizer step: forward, backward, the optional int8 gradient
    compression, AdamW."""
    ocfg = adamw_config(cfg, run)

    def train_step(model, opt_state, batch):
        _, metrics, grads = value_and_grad(cfg, model, batch)
        if run.grad_compression == "int8":
            grads = compress_tree_int8(grads)
        _, opt_state, om = opt_lib.apply_updates(model.params, grads,
                                                 opt_state, ocfg)
        return model, opt_state, dict(metrics, **om)

    return train_step


def make_grad_accum_step(cfg: ModelConfig, run: RunConfig):
    """Micro-batched gradient accumulation: the batch's leaves are (accum,
    micro_batch, ...); each micro-batch's gradient is added into a float32
    tree, whose mean over the micro-batches the optimizer takes."""
    assert run.grad_accum > 1
    ocfg = adamw_config(cfg, run)

    def step(model, opt_state, batch):
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), model.params)
        losses = []
        for i in range(run.grad_accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss, _, grads = value_and_grad(cfg, model, mb)
            for a, g in zip(leaves(acc), leaves(grads)):
                for sa, sg in zip(slices(a), slices(g)):
                    sa.add_(sg.float())
            losses.append(loss)
        grads = tree_map(lambda a: a / run.grad_accum, acc)
        _, opt_state, om = opt_lib.apply_updates(model.params, grads,
                                                 opt_state, ocfg)
        return model, opt_state, dict(loss=torch.stack(losses).mean(), **om)

    return step
