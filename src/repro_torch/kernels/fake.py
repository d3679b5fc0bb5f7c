"""The kernels' fake rule: what a kernel wrapper does with fake tensors.

A dry run (:mod:`repro_torch.launch.dryrun`) traces the program the card
runs on ``FakeTensor`` s, which have shapes and no data.  A kernel launched
through ``ctypes`` is not an aten op and cannot run on them, so each
language-model kernel's wrapper, given fake operands that model the card
(:func:`modelled`), allocates exactly the outputs (and scratch) it would
allocate for the launch, skips the launch, and records the call with its
bytes and operations (:mod:`repro_torch.kernels.cost`) in the active
:class:`KernelTally`.  A fake call is not a launch: the wrappers'
``launches`` counters never move for one.

Fake tensors model the card when they lie on ``cuda``, or lie on the CPU
while a tally that models ``cuda`` is active: autograd aborts the process
on a fake ``cuda`` tensor in a build of PyTorch without CUDA (it asks for
the device's guard), so there the dry run traces fake CPU tensors and says
which program they stand for.  A real tensor never takes this rule: a CPU
tensor takes the plain version, a CUDA tensor launches or raises.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from torch._subclasses.fake_tensor import FakeTensor


class KernelTally:
    """The fake kernel calls of one trace: each kernel's calls (and routes
    where it has them), and the bytes and operations of all of them."""

    def __init__(self, device: str = "cuda"):
        #: the program the fake tensors stand for: ``cuda`` (the kernels)
        #: or ``cpu`` (the plain versions: nothing is recorded)
        self.device = device
        self.calls: Dict[str, int] = {}
        self.routes: Dict[str, Dict[str, int]] = {}
        self.bytes = 0.0
        self.ops = 0.0

    def record(self, name: str, n_bytes: float, ops: float,
               route: Optional[str] = None) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes += n_bytes
        self.ops += ops
        if route is not None:
            by = self.routes.setdefault(name, {})
            by[route] = by.get(route, 0) + 1


_ACTIVE: List[KernelTally] = []


@contextlib.contextmanager
def tally(device: str = "cuda"):
    """``with tally() as t:`` the fake kernel calls made inside, in ``t``."""
    t = KernelTally(device)
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)


def modelled(t) -> bool:
    """Whether ``t`` takes the fake rule: a ``FakeTensor`` on ``cuda``, or
    one on the CPU while the active tally models ``cuda``."""
    if not isinstance(t, FakeTensor):
        return False
    return t.device.type == "cuda" or bool(
        _ACTIVE and _ACTIVE[-1].device == "cuda")


def record(name: str, cost, route: Optional[str] = None) -> None:
    """Record one fake call of kernel ``name`` with its ``(bytes,
    operations, rate)`` in the active tally, if any."""
    if _ACTIVE:
        _ACTIVE[-1].record(name, cost[0], cost[1], route)


def aligned(*tensors) -> bool:
    """Whether fake ``tensors`` all start on 16-byte boundaries, as a
    kernel's TMA route needs: a fake has no address, so its offset into
    its storage stands for it (storages are allocated aligned)."""
    return all(t.storage_offset() * t.element_size() % 16 == 0
               for t in tensors)
