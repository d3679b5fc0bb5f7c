"""Name registries of the mappers and the fabrics (port of
``repro/compiler/registry.py``).

Mapper entries are factories ``factory(arch, seed=..., time_budget=...)``
returning an object with ``.map(dfg)``; arch entries are zero-argument
functions returning an :class:`~repro_torch.core.arch.Arch`.  Both are
registered under a canonical name with aliases and keyword metadata
(``jobs`` drives the evaluation grid,
:func:`repro_torch.compiler.pipeline.job_grid`):

    @register_mapper("hierarchical", jobs={"plaid": "plaid2x2"})
    class HierarchicalMapper: ...

    @register_arch("plaid2x2", aliases=("plaid",))
    def _build(): return build_plaid(2, 2, "plaid2x2")

Unknown names raise :class:`RegistryError` (a ``ValueError``) whose
message lists every registered option.

Leaf-level on purpose: ``repro_torch.core.arch`` and
``repro_torch.mapping.mappers`` register here at import time, and the
pipeline imports them — a cycle unless the registry stays a leaf.  The
lookup helpers (``get_mapper``, ``list_mappers``, ...) live in
:mod:`repro_torch.compiler.pipeline`, whose imports guarantee the
built-ins are registered before the first query.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional


class RegistryError(ValueError):
    """Lookup of a name that was never registered."""


class Registry:
    """An ordered name -> object registry with aliases and metadata."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, object] = {}
        self._meta: Dict[str, Dict[str, object]] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, name: str, obj: Optional[object] = None, *,
                 aliases: Iterable[str] = (), **meta: object):
        """Register ``obj`` under ``name``; usable as a decorator when
        ``obj`` is omitted.  Re-registering a name replaces it (latest
        wins)."""

        def _do(target):
            self._items[name] = target
            self._meta[name] = dict(meta)
            for a in aliases:
                self._aliases[a] = name
            return target

        if obj is None:
            return _do
        return _do(obj)

    def resolve(self, name: str) -> str:
        """Canonical name for ``name`` (follows aliases); raises
        :class:`RegistryError` listing the registered options."""
        if name in self._items:
            return name
        if name in self._aliases:
            return self._aliases[name]
        raise RegistryError(
            f"unknown {self.kind} {name!r}; registered {self.kind}s: "
            + ", ".join(self.names())
        )

    def get(self, name: str) -> object:
        return self._items[self.resolve(name)]

    def meta(self, name: str) -> Dict[str, object]:
        return self._meta[self.resolve(name)]

    def names(self) -> List[str]:
        return list(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items or name in self._aliases


MAPPERS = Registry("mapper")
ARCHES = Registry("arch")


def register_mapper(name: str, **kw) -> Callable:
    """Decorator: register a mapper factory (``cls(arch, seed=, time_budget=)``
    with a ``.map(dfg)`` method) under ``name``.  Keyword metadata: ``jobs``
    maps grid job names to arch names; ``result="spatial"`` marks
    factories whose ``.map`` returns a
    :class:`~repro_torch.core.spatial.SpatialResult` instead of a
    :class:`~repro_torch.mapping.mapping.Mapping`."""
    return MAPPERS.register(name, **kw)


def register_arch(name: str, **kw) -> Callable:
    """Decorator: register a zero-argument architecture builder."""
    return ARCHES.register(name, **kw)
