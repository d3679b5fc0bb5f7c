"""Nested dicts of tensors as the JAX package's pytrees: leaves in
``jax.tree.flatten`` order (sorted keys) and ``/``-joined key paths, the
names the checkpoint's manifest uses (``params/layers/mlp/w1``)."""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import torch


def items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted-key order; a leaf's path joins its keys
    with ``/``."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from items(val, path + "/")
        else:
            yield path, val


def leaves(tree: Dict):
    """The leaves in sorted-key order."""
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """A tree shaped like ``tree`` of ``fn(leaf, *leaves of rest)``."""
    return {key: tree_map(fn, val, *(r[key] for r in rest))
            if isinstance(val, dict) else fn(val, *(r[key] for r in rest))
            for key, val in tree.items()}


def slices(t: torch.Tensor):
    """``t`` one slice of its leading axis at a time where it has three or
    more (a leaf stacked over layers), else ``t`` whole: what the optimizer
    walks so that no float32 temporary of a whole stacked leaf is made."""
    return t.unbind(0) if t.dim() >= 3 else (t,)
