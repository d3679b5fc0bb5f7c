"""Registered mappers as thin pass compositions (top layer of
`repro_torch.mapping`; port of ``repro/mapping/mappers.py``: the same
registrations, grid jobs, budgets, RNG streams and ``REPRO_QUICK`` clamps).

Each mapper is configuration plus a pass pipeline over a shared
:class:`~repro_torch.mapping.passes.base.PassContext`:

========================  ==================================================
mapper                    pipeline
========================  ==================================================
``sa``                    place (greedy) → anneal → finalize
``PathFinderMapper``      place (overuse greedy) → negotiate (legacy rounds)
``hierarchical``          extract → place (multi-start units) → finalize
``node_greedy``           extract (node units) → place → finalize
``pathfinder``            extract → place+negotiate (multi-start, composite)
``pathfinder_selective``  same, selective rip-up pinned on
``pathfinder_global``     extract → global_place → place+negotiate
``pathfinder_window``     same, top-K candidate-window route beam opted in
========================  ==================================================

Composing a new mapper is: subclass :class:`PipelineMapper`, return pass
instances from :meth:`~PipelineMapper.build_passes`, register with
``@register_mapper`` — see docs/mapper.md.  At equal configuration every
trajectory is bit-identical to the JAX package's (goldens in
``tests/golden_ii_quick.json``); ``pathfinder`` negotiates
``"selective"`` by default, ``"full"`` stays selectable.
"""
from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

from repro_torch.compiler.registry import register_mapper
from repro_torch.core.arch import Arch
from repro_torch.core.dfg import DFG
from repro_torch.mapping.mapping import Mapping, MapperStats
from repro_torch.mapping.passes.base import FAIL, MapperPass, MapState, PassContext
from repro_torch.mapping.passes.extract import (
    Unit,
    UnitExtractionPass,
    hierarchical_units,
    node_units,
)
from repro_torch.mapping.passes.finalize import FinalizePass
from repro_torch.mapping.passes.global_place import GlobalPlacementPass
from repro_torch.mapping.passes.negotiate import (
    LegacyNegotiationPass,
    NegotiatedMultiStartPass,
)
from repro_torch.mapping.passes.place import (
    GreedyConstructionPass,
    MultiStartUnitPlacementPass,
    OveruseNodeConstructionPass,
    SAImprovementPass,
    UnitPlacer,
)
from repro_torch.mapping.passes.route import Router


class PipelineMapper:
    """Base mapper: II sweep over a pass pipeline.

    Subclasses configure the composition (:meth:`build_passes`) and the
    knobs passes read through the context (budget, restarts, ordering and
    cache switches, RNG streams).  Config attributes are read at use time,
    so instance- and class-level overrides (the test suites tune
    ``restarts``/``time_budget``/``candidate_ordering`` after construction)
    behave exactly as they did on the monolith.
    """

    max_ii = 16
    #: distance-guided vectorized candidate scoring/ordering (bit-identical
    #: to the scalar path; the off switch exists for the equivalence tests)
    candidate_ordering = True
    #: cross-move route memoization (exact tier; see RouteCache)
    use_route_cache = True
    #: scoped cache tier — only for mappers with their own golden records
    route_cache_scoped = False
    #: analytic global seed placement ahead of detailed placement
    #: (global-then-detailed; read at use time by GlobalPlacementPass)
    global_seed = False
    #: route search core — "auto" (span-dispatched array/scalar hybrid),
    #: "vector" (always the array-DP core), "legacy" (the scalar
    #: equivalence oracle); all three are bit-identical (read at use time
    #: by Router.route_edge_list)
    route_engine = "auto"
    #: opt-in congestion-aware candidate window: keep only the K cheapest
    #: slots per search layer (deterministic beam).  Trajectory-CHANGING —
    #: off (None) by default and golden-gated separately
    #: (tests/golden_ii_quick_window.json)
    route_window: Optional[int] = None
    #: per-II RNG stream multiplier (node-level pipelines share one RNG
    #: between construction and annealing, exactly like the monolith)
    rng_stride = 1337

    def __init__(self, arch: Arch, seed: int = 0, time_budget: int = 4000):
        self.arch = arch
        self.seed = seed
        if os.environ.get("REPRO_QUICK"):
            # reduced SA budget for the test suite's --quick path
            time_budget = min(time_budget, 800)
        self.time_budget = time_budget  # SA/negotiation step budget per II
        self.ctx = PassContext(self)
        self.ctx.router = Router(self.ctx)
        self.ctx.placer = UnitPlacer(self.ctx)
        self._passes: Tuple[MapperPass, ...] = tuple(self.build_passes())

    def set_deadline(self, deadline: Optional[float]):
        """Arm a cooperative wall-clock deadline (a ``time.monotonic()``
        timestamp).  Passes check it between stages / restarts /
        negotiation rounds / SA step blocks and raise
        :class:`~repro_torch.compiler.errors.CompileTimeout` — carrying the
        partial per-pass stats — once it passes.  The checks are pure
        clock reads, so a run that finishes in time is bit-identical to
        an undeadlined one.  This is the hook ``compile(...,
        deadline_s=)`` uses; mappers outside this framework simply lack
        the method and rely on the grid runner's hard per-cell timeout.
        """
        self.ctx.set_deadline(deadline)

    # -- composition ---------------------------------------------------------
    def build_passes(self) -> Tuple[MapperPass, ...]:
        raise NotImplementedError

    def make_rng(self, ii: int) -> random.Random:
        return random.Random(self.seed + ii * self.rng_stride)

    def restart_rng(self, ii: int, restart: int) -> random.Random:
        """Per-restart RNG stream for multi-start passes."""
        return random.Random(self.seed + ii * 9173 + restart * 101)

    def units_of(self, dfg: DFG) -> List[Unit]:
        raise NotImplementedError  # unit-level pipelines override

    # -- accounting ----------------------------------------------------------
    @property
    def stats(self) -> MapperStats:
        return self.ctx.stats

    @property
    def _route_cache(self):
        return self.ctx.route_cache

    def engine_stats(self):
        """Router/negotiation wall time, per-pass timings, and route-cache
        counters accumulated over this mapper's lifetime (the pipeline
        stores them per compile)."""
        return self.ctx.stats.snapshot(self.ctx.route_cache)

    # -- driving -------------------------------------------------------------
    def mii(self, dfg: DFG) -> int:
        n_comp = len(dfg.compute_nodes)
        return max(
            self.arch.res_mii(n_comp, len(dfg.memory_nodes)), dfg.rec_mii()
        )

    def map(self, dfg: DFG) -> Optional[Mapping]:
        for ii in range(self.mii(dfg), self.max_ii + 1):
            self.ctx.check_deadline(f"II sweep (II={ii})")
            m = self.map_at_ii(dfg, ii)
            if m is not None:
                return m
        return None

    def map_at_ii(self, dfg: DFG, ii: int) -> Optional[Mapping]:
        ctx = self.ctx
        # run the per-DFG reset up front: the scan memo / candidate-array
        # caches key on node ids, which collide across DFGs (e.g. spatial
        # segments mapped by one mapper instance back to back)
        ctx.tables(dfg)
        state = MapState(dfg, ii, rng=self.make_rng(ii))
        for p in self._passes:
            if ctx.run(p, state) == FAIL:
                return None
        return state.mapping


# ---------------------------------------------------------------------------
# Node-level SA mapper (baseline; also the spatial engine at II=1)
# ---------------------------------------------------------------------------


@register_mapper("sa", description="node-level simulated annealing baseline")
class SAMapper(PipelineMapper):
    """Plain simulated annealing over single-node moves [3, 68, 73]."""

    fixed_ii: Optional[int] = None
    rng_stride = 1337

    def __init__(self, arch: Arch, seed: int = 0, time_budget: int = 4000):
        super().__init__(arch, seed, time_budget)
        if type(self) is SAMapper:
            # scoped route-cache tier for SA moves (slot_epoch-validated
            # reuse across displace/re-place cycles), golden-gated by
            # tests/golden_ii_sa.json.  Instance-only: subclasses
            # (hierarchical / node_greedy / legacy pathfinder) keep their
            # own golden-gated settings.
            self.route_cache_scoped = True

    def build_passes(self):
        return (GreedyConstructionPass(), SAImprovementPass(),
                FinalizePass(check_nodes=True))

    def map(self, dfg: DFG) -> Optional[Mapping]:
        if self.fixed_ii is not None:
            return self.map_at_ii(dfg, self.fixed_ii)
        return super().map(dfg)


# ---------------------------------------------------------------------------
# PathFinder-style negotiated congestion mapper (legacy node-level baseline)
# ---------------------------------------------------------------------------


class PathFinderMapper(SAMapper):
    """Negotiation-based router [38]: placement greedy, then iterative
    rip-up & re-route with growing history costs; re-place nodes whose
    edges stay congested."""

    rng_stride = 7331

    def build_passes(self):
        return (OveruseNodeConstructionPass(), LegacyNegotiationPass())


# ---------------------------------------------------------------------------
# Hierarchical (Plaid) mapper — Algorithm 2
# ---------------------------------------------------------------------------


@register_mapper(
    "hierarchical",
    jobs={"plaid": "plaid2x2", "plaid3x3": "plaid3x3", "plaid_ml": "plaid_ml"},
    description="Algorithm 2: motif-level hierarchical place & route",
)
class HierarchicalMapper(SAMapper):
    """Algorithm 2: sort motifs by dependency, map each motif to the unit
    with the least routing cost (multi-start greedy construction with
    flexible schedule templates), II++ until valid."""

    restarts = 10

    def __init__(self, arch: Arch, seed: int = 0, time_budget: int = 1500,
                 motif_seed: int = 0, global_seed: Optional[bool] = None,
                 route_window: Optional[int] = None):
        super().__init__(arch, seed, time_budget)
        self.motif_seed = motif_seed
        if global_seed is not None:
            self.global_seed = global_seed
        if route_window is not None:
            self.route_window = route_window
        if os.environ.get("REPRO_QUICK"):
            self.restarts = 4  # test-suite --quick path: fewer restarts

    def build_passes(self):
        # GlobalPlacementPass is a no-op unless global_seed is on (read at
        # use time), so default compositions stay bit-identical
        return (UnitExtractionPass(), GlobalPlacementPass(),
                MultiStartUnitPlacementPass(), FinalizePass())

    def units_of(self, dfg: DFG) -> List[Unit]:
        return hierarchical_units(self.ctx, dfg, self.motif_seed)

    @property
    def _units_cache(self):
        """Legacy introspection point: the pipeline's motif-cover stats
        read the (dfg, units) tuple the mapper actually used."""
        return self.ctx._units_cache


# ---------------------------------------------------------------------------
# Node-level mappers built on the same multi-start greedy construction
# ---------------------------------------------------------------------------


@register_mapper(
    "node_greedy",
    jobs={"st": "st4x4", "node_on_plaid": "plaid2x2"},
    description="node-level multi-start greedy (the Fig. 18 generic mapper)",
)
class NodeGreedyMapper(HierarchicalMapper):
    """Node-level baseline: same stochastic multi-start construction but
    every unit is a single node (no motif knowledge). This is the
    'generic mapper' of Fig. 18 — the delta against HierarchicalMapper
    isolates exactly the motif-scheduling contribution."""

    def units_of(self, dfg: DFG) -> List[Unit]:
        return node_units(dfg)


@register_mapper(
    "pathfinder",
    jobs={"pf_on_plaid": "plaid2x2"},
    description="negotiated-congestion baseline (PathFinder rip-up/re-route)",
)
class PathFinderMapper2(NodeGreedyMapper):
    """Negotiated-congestion baseline: construct with overuse allowed,
    then iteratively rip-up & re-route with growing history costs [38].

    ``negotiation`` selects the rip-up policy per round:

    * ``"selective"`` (default) — the VPR optimization: only nets crossing
      an overused resource (plus any still-unrouted edges) are ripped, so
      converged nets keep their paths across rounds.  II-equal to the full
      policy on every quick cell (the A/B gate in
      ``tests/test_placement_engine.py`` enforces no-worse there) and
      II-neutral on the full TABLE2 grid (28/30 equal, durbin_u4 one
      better, jacobi_u4 one worse — net zero), and faster; guarded by its
      own golden records (``tests/golden_ii_quick_selective.json``,
      ``tests/golden_ii_full.json``).  The scoped route cache tier is
      enabled here (paths with untouched slots are reusable even though
      the global state moved on).
    * ``"full"`` — the textbook algorithm: every net is ripped and
      re-routed each round.  Bit-identical to the pre-option behaviour and
      to ``tests/golden_ii_quick.json``'s ``pf_on_plaid`` column.
    """

    neg_rounds = 25
    negotiation = "selective"
    construction_restarts = 4

    def __init__(self, arch: Arch, seed: int = 0, time_budget: int = 1500,
                 motif_seed: int = 0, negotiation: Optional[str] = None,
                 global_seed: Optional[bool] = None,
                 route_window: Optional[int] = None):
        super().__init__(arch, seed, time_budget, motif_seed, global_seed)
        if route_window is not None:
            self.route_window = route_window
        if negotiation is not None:
            self.negotiation = negotiation
        if self.negotiation not in ("full", "selective"):
            raise ValueError(
                f"negotiation must be 'full' or 'selective', "
                f"got {self.negotiation!r}"
            )
        self.route_cache_scoped = self.negotiation == "selective"

    def build_passes(self):
        return (UnitExtractionPass(), GlobalPlacementPass(),
                NegotiatedMultiStartPass())

    def restart_rng(self, ii: int, restart: int) -> random.Random:
        return random.Random(self.seed + ii * 77 + restart * 13)


@register_mapper(
    "pathfinder_selective",
    description="PathFinder with VPR-style selective rip-up of congested nets",
)
class PathFinderSelectiveMapper(PathFinderMapper2):
    """``PathFinderMapper2`` with ``negotiation="selective"`` pinned on (the
    class predates selective becoming the ``pathfinder`` default and stays
    registered so ``compile(mapper="pathfinder_selective")`` keeps working).
    Not part of the evaluation grid (no ``jobs``); quality is gated by
    ``tests/golden_ii_quick_selective.json``."""

    negotiation = "selective"


@register_mapper(
    "pathfinder_global",
    description="global analytic seed placement + negotiated congestion",
)
class PathFinderGlobalMapper(PathFinderMapper2):
    """``pathfinder`` (selective) with the global-then-detailed flow on:
    cluster → quadratic relaxation over the distance tables → legalized
    seed placement (``global_place`` pass), consumed by the negotiated
    construction as one extra warm-start attempt ahead of its unchanged
    restart loop.  II is structurally no worse than ``pathfinder`` on
    every cell (the fallback restarts are bit-identical); gated by
    ``tests/golden_ii_quick_global.json`` and the ci.sh quick-grid diff.
    Not part of the evaluation grid (no ``jobs``) — select it with
    ``compile(..., mapper="pathfinder_global")`` or ``global_seed=True``
    on the ``pathfinder`` family."""

    global_seed = True


@register_mapper(
    "pathfinder_window",
    description="pathfinder with the congestion-aware top-K route window",
)
class PathFinderWindowMapper(PathFinderMapper2):
    """``pathfinder`` (selective) with the congestion-aware candidate
    window opted in: every route-search layer is pruned to its
    ``route_window`` cheapest slots (deterministic beam over the array-DP
    core).  Trajectory-changing by design — the coarser search trades
    optimality of individual routes for narrower layers — so it carries
    its own golden record (``tests/golden_ii_quick_window.json``, held
    II-no-worse than the default engine's quick golden by the ci.sh
    gate).  Not part of the evaluation grid (no ``jobs``); select it with
    ``compile(..., mapper="pathfinder_window")`` or ``route_window=K`` on
    any ``PipelineMapper``."""

    route_window = 12
