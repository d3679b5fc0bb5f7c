"""`repro_torch.mapping` — the layered mapper package (port of
``repro/mapping``).

The paper's compiler is staged — motif identification (Alg. 1),
hierarchical motif placement (Alg. 2), routing, congestion negotiation —
and this package mirrors those stages as an explicit pass pipeline:

* :mod:`repro_torch.mapping.mrrg` — the time-extended MRRG (flat occupancy
  / history arrays, zobrist state hashes) + fabric latency helpers;
* :mod:`repro_torch.mapping.mapping` — :class:`Mapping` (placement +
  schedule + routes, structural validation, the record form the artifacts
  store), per-DFG tables, mapper stats;
* :mod:`repro_torch.mapping.passes` — the pass library: extraction,
  placement engines, routing, negotiation, finalize, over a shared
  :class:`~repro_torch.mapping.passes.base.PassContext`;
* :mod:`repro_torch.mapping.mappers` — registered mappers as thin pass
  compositions (``sa``, ``hierarchical``, ``node_greedy``, ``pathfinder``,
  ``pathfinder_selective``, ``pathfinder_global``, ``pathfinder_window``).

The JAX package's ``repro.core.mapper`` re-export shim has no counterpart:
callers import from here.
"""
from repro_torch.mapping.mapping import (  # noqa: F401
    DfgTables,
    Mapping,
    MapperStats,
)
from repro_torch.mapping.mappers import (  # noqa: F401
    HierarchicalMapper,
    NodeGreedyMapper,
    PathFinderMapper,
    PathFinderMapper2,
    PathFinderSelectiveMapper,
    PipelineMapper,
    SAMapper,
)
from repro_torch.mapping.mrrg import (  # noqa: F401
    BIG,
    MRRG,
    RouteStats,
    min_span,
    start_resources,
)
from repro_torch.mapping.passes import (  # noqa: F401
    MapperPass,
    MapState,
    PassContext,
    Unit,
    motif_templates,
    route_edge,
)

__all__ = [
    "BIG", "MRRG", "RouteStats", "min_span", "start_resources",
    "DfgTables", "Mapping", "MapperStats",
    "MapperPass", "MapState", "PassContext", "Unit", "motif_templates",
    "route_edge",
    "PipelineMapper", "SAMapper", "PathFinderMapper", "HierarchicalMapper",
    "NodeGreedyMapper", "PathFinderMapper2", "PathFinderSelectiveMapper",
]
