"""Logical-axis sharding rules on a ``DeviceMesh``, the port of
``repro/parallel/sharding.py``.

The paper's thesis is that communication should be provisioned to match
what the dataflow needs.  At pod scale that decision *is* the logical ->
mesh axis mapping below: which tensor dims ride the fast in-node links
(``model``: tensor and expert parallelism inside one 8-GPU NVLink node),
which ride the scale-out fabric (``data``: batch and FSDP; ``pod``: pure
data parallelism, gradient sync only), and which stay local.

A pspec is the port's own: a tuple with one entry a tensor dim, each
``None`` (replicated), a mesh axis name or a tuple of them, equal element
for element to the JAX package's ``PartitionSpec``.
:func:`placements_for` turns one into ``torch.distributed.tensor``
placements on a ``DeviceMesh``; :func:`local_shape` is the shard one
device holds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.models.layers import Spec, spec_map

Axis = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[Axis, ...]


def logical_rules(cfg, *, multi_pod: bool = False) -> Dict[str, Axis]:
    """Map logical tensor-dim names to mesh axes for this architecture."""
    rules: Dict[str, Axis] = {
        # activations
        "batch": ("pod", "data") if multi_pod else ("data",),
        "seq": None,
        "cache_seq": ("data",),  # long-context (B=1) decode: shard the KV cache
        # params — tensor/expert parallel over the 'model' ICI axis
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        # params — FSDP over the 'data' ICI axis (never over the DCN 'pod' axis:
        # pods keep full replicas and sync gradients only — the 'global
        # datapath' carries inter-motif traffic only)
        "embed": ("data",) if cfg.fsdp else None,
        # never sharded
        "layers": None,
        "state": None,
        "conv": None,
        "dt": None,
        "capacity": ("data",),  # MoE dispatch buffer token-capacity dim
    }
    return rules


#: the H100 production mesh's extents (:mod:`repro_torch.launch.mesh`), used
#: for divisibility fallbacks (odd vocab sizes like whisper's 51865 or
#: granite's 49155 fall back to replicated).  The JAX package's are a TPU
#: v5e pod's, ``{"pod": 2, "data": 16, "model": 16}``.
PROD_AXIS_SIZES = {"pod": 2, "data": 32, "model": 8}


def _pspec_for(
    axes: Tuple[Optional[str], ...],
    rules: Dict[str, Axis],
    shape,
    axis_sizes: Optional[Dict[str, int]] = None,
) -> PSpec:
    sizes = axis_sizes or PROD_AXIS_SIZES
    parts = []
    used = set()  # a mesh axis may shard at most one dim; first dim wins
    for dim, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        mapped = rules.get(name)
        if mapped is None:
            parts.append(None)
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        if any(a in used for a in mapped):
            parts.append(None)
            continue
        extent = 1
        for a in mapped:
            extent *= sizes.get(a, 1)
        if dim % extent != 0:
            parts.append(None)  # replicate rather than pad unevenly
            continue
        used.update(mapped)
        parts.append(mapped if len(mapped) > 1 else mapped[0])
    return tuple(parts)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Each mesh axis's extent: a ``DeviceMesh``'s named dims, or the
    ``shape`` mapping of anything shaped like the JAX package's mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # per dim, without building the rank tensor
        return {name: mesh.size(i) for i, name in enumerate(names)}
    return dict(mesh.shape)


def _axes(part: Axis) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def local_shape(shape, pspec: PSpec, sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """The shard of a ``shape`` tensor that one device holds under
    ``pspec`` (every sharded dim divides evenly, as :func:`_pspec_for`
    guarantees)."""
    out = []
    for dim, part in zip(shape, pspec):
        extent = 1
        for a in _axes(part):
            extent *= sizes.get(a, 1)
        if dim % extent:
            raise ValueError(f"dim {dim} does not split over {part} "
                             f"({extent})")
        out.append(dim // extent)
    return tuple(out)


def placements_for(pspec: PSpec, mesh):
    """The ``torch.distributed.tensor`` placements of ``pspec`` on
    ``mesh``: one a mesh dim, ``Shard(d)`` where tensor dim ``d`` is
    sharded over that mesh axis (a dim sharded over ``("pod", "data")``
    is ``Shard(d)`` on both, in mesh order), ``Replicate()`` elsewhere.
    Axes the mesh does not have are ignored."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {a: d for d, part in enumerate(pspec) for a in _axes(part)}
    return tuple(Shard(owner[name]) if name in owner else Replicate()
                 for name in mesh.mesh_dim_names)


def shardings_for(spec_tree, mesh, cfg, *, multi_pod: bool = False):
    """Spec tree -> tree of placements on ``mesh`` (divisibility-safe: a dim
    that does not divide by its mesh-axis extent is replicated)."""
    rules = logical_rules(cfg, multi_pod=multi_pod)
    sizes = mesh_sizes(mesh)

    def one(s: Spec):
        return placements_for(_pspec_for(s.axes, rules, s.shape, sizes),
                              mesh)

    return spec_map(one, spec_tree)


def pspecs_for(spec_tree, cfg, *, multi_pod: bool = False, axis_sizes=None):
    rules = logical_rules(cfg, multi_pod=multi_pod)
    return spec_map(lambda s: _pspec_for(s.axes, rules, s.shape, axis_sizes),
                    spec_tree)


def batch_pspec(global_batch: int, mesh, multi_pod: bool) -> PSpec:
    """Batch-dim spec; falls back to replicated if batch doesn't divide."""
    sizes = mesh_sizes(mesh)
    axes = ("pod", "data") if multi_pod else ("data",)
    total = 1
    for a in axes:
        total *= sizes[a]
    if global_batch % total == 0:
        return (axes if len(axes) > 1 else axes[0],)
    if global_batch % sizes["data"] == 0:
        return ("data",)
    return (None,)


# ---------------------------------------------------------------------------
# In-graph constraints
# ---------------------------------------------------------------------------


def constrain(x: torch.Tensor, *axis_names: Optional[str]) -> torch.Tensor:
    """Redistribute a ``DTensor`` so that dim ``i`` is sharded over mesh
    axis ``axis_names[i]`` (``None``, or an axis the mesh lacks:
    replicated); a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    present = tuple(a if a in mesh.mesh_dim_names else None
                    for a in axis_names)
    return x.redistribute(mesh, placements_for(present, mesh))
