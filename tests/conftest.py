import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_addoption(parser):
    parser.addoption(
        "--quick", action="store_true", default=False,
        help="exercise mappers at reduced SA budgets (sets REPRO_QUICK=1; "
        "faster suite, slightly weaker mapping quality)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
    if config.getoption("--quick"):
        # Mappers read this at construction time (see _BaseMapper.__init__),
        # so setting it before test modules import repro is sufficient.
        os.environ["REPRO_QUICK"] = "1"


@pytest.fixture(scope="session")
def workload_dfg():
    """Session-cached workload DFG factory: ``workload_dfg(name, unroll)``.

    DFG construction is deterministic and mappers never mutate the graph, so
    one instance per (name, unroll) can serve every test in the session.
    """
    from repro.core.workloads import build_workload, workload_by_name

    cache = {}

    def get(name: str, unroll: int):
        key = (name, unroll)
        g = cache.get(key)
        if g is None:
            g = cache[key] = build_workload(workload_by_name(name, unroll))
        return g

    return get


@pytest.fixture(scope="session")
def arch():
    """Session-cached architecture factory: ``arch(name)``.

    ``make_arch`` itself caches per process now (the routing engine's
    distance tables hang off each instance); this fixture just gives tests
    an injection point that makes the sharing explicit.
    """
    from repro.core.arch import make_arch

    return make_arch
