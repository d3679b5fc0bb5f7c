"""Pass library for the `repro_torch.mapping` pipeline.

Port of ``repro/mapping/passes/__init__.py``, line for line,
over the port's own modules.

Layering (a DAG):

* :mod:`~repro_torch.mapping.passes.base` — :class:`PassContext` / `MapState` /
  `MapperPass` framework (depends only on the mapping/mrrg layers);
* :mod:`~repro_torch.mapping.passes.route` — the per-edge router + incremental
  reroute primitives;
* :mod:`~repro_torch.mapping.passes.extract` — motif/unit extraction;
* :mod:`~repro_torch.mapping.passes.place` — node and unit placement engines and
  their passes (greedy, SA, multi-start, overuse construction);
* :mod:`~repro_torch.mapping.passes.negotiate` — full + selective rip-up
  negotiation;
* :mod:`~repro_torch.mapping.passes.finalize` — completeness + validation.
"""
from repro_torch.mapping.passes.base import (  # noqa: F401
    CONTINUE,
    FAIL,
    MapperPass,
    MapState,
    PassContext,
)
from repro_torch.mapping.passes.extract import (  # noqa: F401
    Unit,
    UnitExtractionPass,
    hierarchical_units,
    motif_templates,
    node_units,
)
from repro_torch.mapping.passes.finalize import FinalizePass  # noqa: F401
from repro_torch.mapping.passes.negotiate import (  # noqa: F401
    LegacyNegotiationPass,
    NegotiatedMultiStartPass,
    negotiate_selective,
)
from repro_torch.mapping.passes.place import (  # noqa: F401
    GreedyConstructionPass,
    MultiStartUnitPlacementPass,
    NodePlacer,
    OveruseNodeConstructionPass,
    SAImprovementPass,
    UnitPlacer,
)
from repro_torch.mapping.passes.route import (  # noqa: F401
    Router,
    _route_edge_once,
    route_edge,
)

__all__ = [
    "CONTINUE", "FAIL", "MapperPass", "MapState", "PassContext",
    "Unit", "UnitExtractionPass", "hierarchical_units", "motif_templates",
    "node_units", "FinalizePass", "LegacyNegotiationPass",
    "NegotiatedMultiStartPass", "negotiate_selective",
    "GreedyConstructionPass", "MultiStartUnitPlacementPass", "NodePlacer",
    "OveruseNodeConstructionPass", "SAImprovementPass", "UnitPlacer",
    "Router", "route_edge",
]
