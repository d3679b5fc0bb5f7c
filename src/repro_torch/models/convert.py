"""Carry a parameter tree of the JAX package over to the port.

``jax.random`` cannot be reproduced in PyTorch, so the tests build
parameters with the JAX package's ``init_of``, pass them through numpy and
load them here; both packages then compute the same function.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.models import zoo
from repro_torch.models.layers import Spec


def tree_from_numpy(tree: Dict, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """Each array of a nested dict as a tensor on ``device`` (via float32
    for floating arrays, so numpy's bfloat16 extension type needs no
    support here), cast to ``dtype`` where given; integer arrays keep
    their type."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = tree_from_numpy(val, device, dtype)
            continue
        a = np.asarray(val)
        if np.issubdtype(a.dtype, np.integer):
            out[key] = torch.from_numpy(a.copy()).to(device)
        else:
            t = torch.from_numpy(a.astype(np.float32))
            out[key] = t.to(device=device, dtype=dtype or torch.float32)
    return out


def _cast_to_spec(spec, tree: Dict, dtype: torch.dtype) -> Dict:
    if isinstance(spec, Spec):
        return tree if spec.dtype == torch.float32 else tree.to(dtype)
    return {k: _cast_to_spec(spec[k], v, dtype) for k, v in tree.items()}


def params_from_numpy(cfg, tree: Dict, device: Union[str, torch.device],
                      dtype: torch.dtype) -> torch.nn.Module:
    """The port's model for ``cfg`` holding the JAX parameter ``tree``
    (numpy arrays shaped like ``param_spec(cfg)``) on ``device``: each
    leaf cast to ``dtype``, except the leaves whose spec is float32 (the
    MoE router; the SSM's ``dt_bias``, ``A_log`` and ``Dskip``), which
    stay float32 as in the JAX package."""
    return zoo.build(cfg, _cast_to_spec(zoo.param_spec(cfg),
                                        tree_from_numpy(tree, device),
                                        dtype))
