"""Name registry of the fabrics (port of the arch half of
``repro/compiler/registry.py``).

Arch entries are zero-argument builders returning an
:class:`~repro_torch.core.arch.Arch`, registered under a canonical name
with aliases:

    @register_arch("plaid2x2", aliases=("plaid",))
    def _build(): return build_plaid(2, 2, "plaid2x2")

Unknown names raise :class:`RegistryError` (a ``ValueError``) whose
message lists every registered option.  The mapper half waits for the
mapper's port.

Leaf-level on purpose: ``repro_torch.core.arch`` registers its builders
here at import time.
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


ARCHES = Registry("arch")


def register_arch(name: str, **kw) -> Callable:
    """Decorator: register a zero-argument architecture builder."""
    return ARCHES.register(name, **kw)
