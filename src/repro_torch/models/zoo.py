"""Model zoo of the port: one API over the ported families
(``repro/models/zoo.py``).

Every family module exposes ``param_spec``, ``cache_spec`` and its model
class as ``Model``, with ``forward``, ``prefill`` and ``decode_step``
methods; callers hold the built model and call those methods.  The dense
module (dense and vlm) also trains: :func:`loss_fn`.  Every
family of the JAX package's zoo is ported; an unknown family raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import dense, encdec, hybrid, moe, ssm
from repro_torch.models.layers import Spec, init_params

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


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """A model with seeded random weights drawn on ``device`` (see
    :func:`repro_torch.models.layers.init_params`)."""
    return build(cfg, init_params(param_spec(cfg), generator, device, dtype))


#: the families that train so far (the others serve only)
TRAINED_FAMILIES = ("dense", "vlm")


def loss_fn(cfg: ModelConfig, model: torch.nn.Module, batch: Dict):
    """(loss, metrics) of ``model`` on a training ``batch`` of tensors
    (``repro/models/zoo.py``'s ``loss_fn``).  The dense and vlm families
    train; moe, ssm, hybrid and encdec serve only and raise
    ``NotImplementedError``."""
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) does not train in the "
            f"port yet; training families: {list(TRAINED_FAMILIES)}")
    return get_module(cfg).loss_fn(cfg, model, batch)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    return get_module(cfg).cache_spec(cfg, batch, seq_len)


# ---------------------------------------------------------------------------
# Batch input specs per serving shape cell
# ---------------------------------------------------------------------------


def input_spec(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Spec tree for the *data* inputs of one prefill or decode cell (no
    allocation); training cells are not served."""
    get_module(cfg)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        batch: Dict[str, Spec] = {}
        if cfg.family == "vlm":
            batch["embeds"] = Spec((B, T, cfg.d_model), ("batch", "seq", None))
            batch["positions"] = Spec((B, 3, T), ("batch", None, "seq"),
                                      torch.int32)
        elif cfg.family == "encdec":
            batch["audio_embeds"] = Spec((B, cfg.enc_seq, cfg.d_model),
                                         ("batch", None, None))
        # the vlm's tokens serve the cache bookkeeping only
        batch["tokens"] = Spec((B, T), ("batch", "seq"), torch.int32)
        return batch
    if shape.kind == "decode":
        return {"tokens": Spec((B, 1), ("batch", None), torch.int32)}
    raise ValueError(shape.kind)
