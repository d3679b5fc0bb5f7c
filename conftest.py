"""Test isolation shared by every test directory.

The compiler's mapper registry (``repro.compiler.registry.MAPPERS``) is the
process's.  A test module that registers a mapper of its own would leave it
there for every module that pytest-xdist later runs in the same worker, and
a module that walks every registered mapper would meet it.  After each
module, the mappers whose class that module defined are taken out again.
"""
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def _module_mappers_leave_with_it(request):
    yield
    registry = sys.modules.get("repro.compiler.registry")
    if registry is None:
        return
    mappers = registry.MAPPERS
    for name, target in list(mappers._items.items()):
        if getattr(target, "__module__", None) == request.module.__name__:
            del mappers._items[name]
            mappers._meta.pop(name, None)
