"""Model zoo of the port: one API over the ported families
(``repro/models/zoo.py``).

Every family module exposes ``param_spec``, ``cache_spec`` and its model
class as ``Model``, with ``forward``, ``prefill`` and ``decode_step``
methods; callers hold the built model and call those methods.  Families
not yet ported raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import dense, moe, ssm
from repro_torch.models.layers import Spec, init_params

FAMILY_MODULES = {
    "dense": dense,
    "vlm": dense,
    "moe": moe,
    "ssm": ssm,
}
#: where ROADMAP.md section 1 queues each family not yet ported
NOT_PORTED = {
    "hybrid": "ROADMAP.md section 1 item 1 (repro/models/hybrid.py, with "
              "the Mamba-2 half of repro/models/ssm.py)",
    "encdec": "ROADMAP.md section 1 item 2 (repro/models/encdec.py)",
}


def get_module(cfg: ModelConfig):
    if cfg.family not in FAMILY_MODULES:
        where = NOT_PORTED.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: "
            f"{where}")
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
        # vlm: for cache bookkeeping
        batch["tokens"] = Spec((B, T), ("batch", "seq"), torch.int32)
        return batch
    if shape.kind == "decode":
        return {"tokens": Spec((B, 1), ("batch", None), torch.int32)}
    raise ValueError(shape.kind)
