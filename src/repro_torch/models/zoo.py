"""Model zoo of the port: one API over the ported families
(``repro/models/zoo.py``).

Every family module exposes ``param_spec``, ``cache_spec``, ``loss_fn``
and its model class as ``Model``, with ``forward``, ``prefill``,
``decode_step`` and ``grad_views`` methods; callers hold the built model
and call those methods.  Every family of the JAX package's zoo is ported
and trains (:func:`loss_fn`); an unknown family raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import dense, encdec, hybrid, moe, ssm
from repro_torch.models.layers import Spec, init_params, spec_map

FAMILY_MODULES = {
    "dense": dense,
    "vlm": dense,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}


def get_module(cfg: ModelConfig):
    if cfg.family not in FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not a ported family: "
            f"{sorted(FAMILY_MODULES)}")
    return FAMILY_MODULES[cfg.family]


def param_spec(cfg: ModelConfig):
    return get_module(cfg).param_spec(cfg)


def build(cfg: ModelConfig, params: Dict) -> torch.nn.Module:
    """The family's model around a params tree shaped like
    :func:`param_spec`."""
    return get_module(cfg).Model(cfg, params)


def depth_cut(cfg: ModelConfig, layers: int):
    """(config, spec) of the first ``layers`` layers of ``cfg``'s model:
    every tree stacked over ``cfg.n_layers`` (a leaf whose leading axis is
    ``"layers"`` and that long; the encdec's encoder too where it is as
    deep) keeps its first ``layers`` entries, each normal weight scaled
    by the full stack's fan-in.  ``init_params`` divides a stacked weight
    by the square root of its layer count, so a model drawn at the cut
    depth would have weights sqrt(n_layers / layers) times the full
    model's; drawn from this spec, each layer has the full model's
    scale, without drawing the full model."""
    if not 0 < layers <= cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: cannot keep {layers} of "
                         f"{cfg.n_layers} layers")

    def cut(s: Spec) -> Spec:
        if s.axes[:1] != ("layers",) or s.shape[0] != cfg.n_layers:
            return s
        return dataclasses.replace(s, shape=(layers,) + s.shape[1:],
                                   fan_in=s.fan_in or s.shape[0])

    return (cfg.replace(n_layers=layers),
            spec_map(cut, param_spec(cfg)))


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device,
               dtype: Optional[torch.dtype] = None,
               layers: Optional[int] = None) -> torch.nn.Module:
    """A model with seeded random weights drawn on ``device`` (see
    :func:`repro_torch.models.layers.init_params`); with ``layers``, the
    :func:`depth_cut` of its first ``layers`` layers."""
    spec = param_spec(cfg)
    if layers is not None:
        cfg, spec = depth_cut(cfg, layers)
    return build(cfg, init_params(spec, generator, device, dtype))


def loss_fn(cfg: ModelConfig, model: torch.nn.Module, batch: Dict):
    """(loss, metrics) of ``model`` on a training ``batch`` of tensors
    (``repro/models/zoo.py``'s ``loss_fn``), for every family: the mean
    next-token cross-entropy, plus the MoE family's 0.01 x aux loss."""
    return get_module(cfg).loss_fn(cfg, model, batch)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    return get_module(cfg).cache_spec(cfg, batch, seq_len)


# ---------------------------------------------------------------------------
# Batch input specs per serving shape cell
# ---------------------------------------------------------------------------


def input_spec(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Spec tree for the *data* inputs of one train, prefill or decode
    cell (no allocation), as ``repro/models/zoo.py:62-89`` gives it: a
    train batch holds ``labels`` beside the inputs of a full sequence
    (the vlm's ``embeds`` and ``positions`` in place of ``tokens``; the
    encdec's ``audio_embeds`` and ``tokens``)."""
    get_module(cfg)
    B, T = shape.global_batch, shape.seq_len
    tok = lambda t: Spec((B, t), ("batch", "seq"), torch.int32)  # noqa: E731
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Spec] = {}
        if cfg.family == "vlm":
            batch["embeds"] = Spec((B, T, cfg.d_model), ("batch", "seq", None))
            batch["positions"] = Spec((B, 3, T), ("batch", None, "seq"),
                                      torch.int32)
        elif cfg.family == "encdec":
            batch["audio_embeds"] = Spec((B, cfg.enc_seq, cfg.d_model),
                                         ("batch", None, None))
        if shape.kind == "train":
            if cfg.family != "vlm":
                batch["tokens"] = tok(T)
            batch["labels"] = tok(T)
        else:  # the vlm's tokens serve the cache bookkeeping only
            batch["tokens"] = tok(T)
        return batch
    if shape.kind == "decode":
        return {"tokens": Spec((B, 1), ("batch", None), torch.int32)}
    raise ValueError(shape.kind)
