"""Checkpoints with a manifest, the port of ``repro/train/checkpoint.py``,
on the same disk layout, so each package restores the other's:

    <dir>/step_<n>/
        manifest.json    (step, time, each leaf's shape and dtype, extra)
        arrays.npz       (the params and optimizer-state leaves)

A leaf is keyed ``params/<path>`` or ``opt_state/<path>`` (its dict keys
joined by ``/``, in sorted order, as ``jax.tree_util`` names them).  npz
cannot hold bfloat16, so a bf16 leaf is stored as its ``uint16`` bits with
dtype ``"bfloat16"`` in the manifest; the port reads and writes those bits
through ``tensor.view(torch.int16)`` and numpy ``uint16``, without
``ml_dtypes``.  A checkpoint is written to ``step_<n>.tmp`` and renamed
into place (a crash never leaves a torn one), and only the newest
``keep`` survive.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.train.tree import items


def _to_numpy(t: torch.Tensor):
    """(array, dtype name) of a tensor as the manifest records it."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=not arr.flags["C_CONTIGUOUS"])
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         keep: int = 3) -> str:
    """Write ``state`` = {'params': tree, 'opt_state': tree, 'extra':
    jsonable} as step ``step``; returns the checkpoint's directory."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                "leaves": {}}
    for group in ("params", "opt_state"):
        for key, leaf in items(state[group]):
            full = f"{group}/{key}"
            arr, dtype_name = _to_numpy(leaf)
            arrays[full] = arr
            manifest["leaves"][full] = {"shape": list(arr.shape),
                                        "dtype": dtype_name}
    manifest["extra"] = state.get("extra", {})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish
    _gc(ckpt_dir, keep)
    return path


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Dict[str, Any],
            shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore step ``step`` into the structure of ``like`` ({'params': …,
    'opt_state': …}); returns {'params', 'opt_state', 'extra'}.

    A leaf of ``like`` that holds memory is overwritten in place with the
    stored bits (its shape and dtype must match; nothing else is
    allocated on its device, so a full-width state restores without a
    second copy) and returned; a ``meta`` leaf (from ``shapes_of``) gives a
    new CPU tensor in the stored dtype.  ``shardings`` is accepted for the
    JAX package's signature and ignored: the port runs on one card, so
    there is nothing to re-lay out."""
    del shardings
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {"extra": manifest.get("extra", {})}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for group in ("params", "opt_state"):
            flat = {}
            for key, leaf in items(like[group]):
                full = f"{group}/{key}"
                t = _from_numpy(data[full], manifest["leaves"][full]["dtype"])
                if list(t.shape) != list(leaf.shape):
                    raise ValueError(f"{full}: stored {tuple(t.shape)}, "
                                     f"expected {tuple(leaf.shape)}")
                if leaf.device.type == "meta":
                    flat[key] = t
                    continue
                if t.dtype != leaf.dtype:
                    raise ValueError(f"{full}: stored {t.dtype}, expected "
                                     f"{leaf.dtype}")
                with torch.no_grad():
                    leaf.copy_(t)
                flat[key] = leaf
            out[group] = _unflatten_like(like[group], flat)
    return out


def _unflatten_like(like: Dict, flat: Dict[str, Any], prefix: str = ""):
    return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
            if isinstance(v, dict) else flat[f"{prefix}{k}"]
            for k, v in like.items()}
