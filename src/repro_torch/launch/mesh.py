"""Production and host meshes of the port (``repro/launch/mesh.py``).

Kept as functions (never module-level constants), and no process group is
made at import.

H100 layout (the JAX package's pod meshes are a TPU v5e layout and do not
carry over):
  single-pod : (data=32, model=8)           — 256 GPUs, 32 nodes of 8
  multi-pod  : (pod=2, data=32, model=8)    — 512 GPUs

``model`` is the innermost axis and spans one 8-GPU node, so tensor and
expert parallelism ride NVLink; ``data`` (batch, FSDP) and ``pod`` (pure
data parallelism, gradient sync only) cross the InfiniBand fabric between
nodes.

:func:`make_production_mesh` lays the mesh over a fake process group of
world 256 or 512 (``torch.testing``'s ``FakeStore``, backend ``"fake"``:
no device, no traffic), the counterpart of the JAX dry run's 512 fake host
devices.  Its device type is ``cpu``: the mesh is a layout for the plan,
nothing runs on it.  :func:`make_host_mesh` lays a mesh over the world
that exists (world 1 over gloo on the CPU, NCCL on a card).  Both make the
default group only when none exists; :func:`production_mesh` and
:func:`host_mesh` destroy the group they made on leaving.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

#: (axis names, shape) of each production mesh
PRODUCTION = {False: (("data", "model"), (32, 8)),
              True: (("pod", "data", "model"), (2, 32, 8))}


def _ensure_group(world: int, backend: str, **kw) -> bool:
    """Make the default process group of ``world`` ranks (rank 0) unless
    one exists; True when this call made it.  An existing group of
    another size raises ``RuntimeError``."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} exists; "
                f"this mesh needs {world}")
        return False
    dist.init_process_group(backend, rank=0, world_size=world, **kw)
    return True


def make_production_mesh(*, multi_pod: bool = False):
    """The H100 production mesh over a fake group of 256 (512 with
    ``multi_pod``) ranks, made here unless a group of that size exists."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    names, shape = PRODUCTION[multi_pod]
    world = 1
    for n in shape:
        world *= n
    _ensure_group(world, "fake", store=FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_host_mesh(*, model: int = 1, device: str = "cuda"):
    """A ``(data, model)`` mesh over the world that exists, of
    ``device``'s type; with no group, a world of 1 (gloo on ``cpu``, NCCL
    on ``cuda``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        fd, path = tempfile.mkstemp(prefix="repro_torch_mesh_")
        os.close(fd)
        os.unlink(path)  # the file store makes it afresh
        _ensure_group(1, "gloo" if device == "cpu" else "nccl",
                      init_method=f"file://{path}")
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def _owning(make):
    """``make()``'s mesh; the default group is destroyed on leaving if
    ``make`` created it."""
    import torch.distributed as dist

    existed = dist.is_initialized()
    try:
        yield make()
    finally:
        if not existed and dist.is_initialized():
            dist.destroy_process_group()


def production_mesh(*, multi_pod: bool = False):
    """``with production_mesh(multi_pod=...) as mesh:`` the production mesh,
    its fake group destroyed on leaving if it was made here."""
    return _owning(lambda: make_production_mesh(multi_pod=multi_pod))


def host_mesh(*, model: int = 1, device: str = "cuda"):
    """``with host_mesh(device=...) as mesh:`` the host mesh, its group
    destroyed on leaving if it was made here."""
    return _owning(lambda: make_host_mesh(model=model, device=device))


def validate_mesh(mesh) -> dict:
    """Sanity facts recorded beside every dry-run cell."""
    names = mesh.mesh_dim_names
    return {
        "shape": {name: mesh.size(i) for i, name in enumerate(names)},
        "n_devices": mesh.size(),
        "axis_names": list(names),
    }
