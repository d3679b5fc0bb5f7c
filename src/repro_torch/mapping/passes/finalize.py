"""Schedule/finalize pass: completeness checks + structural validation.

Port of ``repro/mapping/passes/finalize.py``, line for line,
over the port's own modules.

The last stage of every pipeline: optionally re-check completeness (the SA
baseline places *every* DFG node, const/input included, so its check
differs from the unit mappers' executable-node count), then run
:meth:`~repro_torch.mapping.mapping.Mapping.validate` — placement legality, route
presence/timing, and modulo-slot capacity — before the mapping is handed
out of the mapper.
"""
from __future__ import annotations

from repro_torch.mapping.passes.base import (
    CONTINUE,
    FAIL,
    MapperPass,
    MapState,
    PassContext,
)


class FinalizePass(MapperPass):
    """Validate the finished mapping (and, for node-level pipelines, fail
    the II attempt when construction/annealing left nodes unplaced, slots
    overused, or edges unrouted)."""

    name = "finalize"

    def __init__(self, check_nodes: bool = False):
        #: re-check completeness over the construction order (SA baseline);
        #: unit pipelines already proved validity in their placement pass
        self.check_nodes = check_nodes

    def run(self, ctx: PassContext, state: MapState) -> str:
        dfg, mrrg, mapping = state.dfg, state.mrrg, state.mapping
        if self.check_nodes:
            order = state.scratch["order"]
            unplaced = [x for x in order if x not in mapping.place]
            if unplaced or mrrg.has_overuse() \
                    or not ctx.placer.all_routed(dfg, mapping):
                return FAIL
        mapping.validate()
        return CONTINUE
