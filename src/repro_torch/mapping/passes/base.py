"""Pass-pipeline framework (layer 2 of `repro_torch.mapping`).

Port of ``repro/mapping/passes/base.py``, line for line,
over the port's own modules.

A mapper is a composition of :class:`MapperPass` objects run over a shared
:class:`PassContext` (seeded RNG factory, budget, stats, per-DFG caches)
and a per-``map_at_ii`` :class:`MapState` (DFG, II, MRRG, mapping, RNG).
The context owns everything that must survive across II attempts and
restarts — router accounting, the route cache, candidate-array/scan memos —
and resets the node-id-keyed caches whenever the DFG changes (one mapper
instance mapping several graphs back to back, e.g. spatial segments, must
behave exactly like fresh mappers).

Every pass invocation is timed through :meth:`PassContext.run`, which
accumulates wall seconds + counters into the uniform per-pass schema on
:class:`~repro_torch.mapping.mapping.MapperStats` (surfaced in
``CompileResult.pass_stats`` and ``plaid-compile inspect``).
"""
from __future__ import annotations

import random
from time import monotonic, perf_counter
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.errors import CompileTimeout
from repro_torch.core.dfg import DFG
from repro_torch.core.routing import RouteCache
from repro_torch.mapping.mapping import DfgTables, Mapping, MapperStats
from repro_torch.mapping.mrrg import MRRG

#: pass outcomes: CONTINUE hands the state to the next pass, FAIL aborts
#: this II attempt (the mapper's II sweep returns None and tries the next II)
CONTINUE = "continue"
FAIL = "fail"


class MapState:
    """Mutable state of one ``map_at_ii`` run, threaded through the passes."""

    __slots__ = ("dfg", "ii", "mrrg", "mapping", "rng", "units", "scratch")

    def __init__(self, dfg: DFG, ii: int, rng: Optional[random.Random] = None):
        self.dfg = dfg
        self.ii = ii
        self.mrrg: Optional[MRRG] = None
        self.mapping: Optional[Mapping] = None
        self.rng = rng
        self.units = None  # set by the extraction pass (unit-level mappers)
        self.scratch: Dict[str, object] = {}  # pass-to-pass hand-off


class MapperPass:
    """One stage of a mapper pipeline.

    Subclasses set :attr:`name` (the key in the per-pass stats schema) and
    implement :meth:`run`, returning :data:`CONTINUE` or :data:`FAIL`.
    Passes are stateless between runs — everything mutable lives on the
    context or the state — so one pass instance can be shared by every
    ``map_at_ii`` call of a mapper.
    """

    name = "pass"
    #: a self-timed (composite) pass ticks its own phase rows via
    #: :meth:`PassContext.tick` instead of one outer row per invocation
    self_timed = False

    def run(self, ctx: "PassContext", state: MapState) -> str:
        raise NotImplementedError


class PassContext:
    """Shared pipeline state + config read-through for one mapper instance.

    Configuration (budget, restarts, ordering/cache switches, negotiation
    policy, ...) is read through :attr:`config` — the owning mapper — at
    use time, so instance- or class-attribute overrides (the equivalence
    tests flip ``candidate_ordering`` on the class; callers tune
    ``restarts``/``time_budget`` on the instance) behave exactly as they
    did on the monolith.
    """

    def __init__(self, config):
        self.config = config  # the owning mapper: config attribute source
        self.arch = config.arch
        self.stats = MapperStats()
        self.route_cache: Optional[RouteCache] = None
        # cooperative wall-clock deadline (time.monotonic() value), set by
        # PipelineMapper.set_deadline for compile(..., deadline_s=...)
        self.deadline: Optional[float] = None
        self._deadline_t0: Optional[float] = None
        # -- per-DFG acceleration state (reset by _on_new_dfg) -------------
        self._dfg_tables: Optional[Tuple[DFG, DfgTables]] = None
        self._units_cache: Optional[Tuple[DFG, list]] = None
        self.cand_arrays_cache: Dict[tuple, tuple] = {}
        self.scan_memo: Dict[tuple, object] = {}
        # global-placement relaxed positions (II-independent, so the II
        # sweep reuses one relaxation per DFG); (dfg, ndarray) like tables
        self.relax_pos_cache: Optional[tuple] = None
        # op -> FU-id candidates; arch-dependent only, survives DFG changes
        self.fu_cand_cache: Dict[str, List[int]] = {}

    # -- per-DFG state ------------------------------------------------------
    def tables(self, dfg: DFG) -> DfgTables:
        cached = self._dfg_tables
        if cached is None or cached[0] is not dfg:
            cached = (dfg, DfgTables(dfg))
            self._dfg_tables = cached
            self._on_new_dfg()
        return cached[1]

    def _on_new_dfg(self):
        """Reset per-DFG acceleration state (net ids are DFG node ids, so a
        route cache must not outlive its graph); counters are preserved."""
        self.stats.absorb_cache(self.route_cache)
        self.route_cache = (
            RouteCache(scoped=self.config.route_cache_scoped)
            if self.config.use_route_cache else None
        )
        self.cand_arrays_cache.clear()
        self.scan_memo.clear()
        self._units_cache = None
        self.relax_pos_cache = None

    def units_for(self, dfg: DFG) -> list:
        """Cached unit decomposition (``config.units_of`` is deterministic
        per (mapper, dfg)), so motif generation runs once per workload
        instead of once per II attempt.  ``tables()`` must run first so the
        per-DFG reset cannot wipe a fresh decomposition."""
        self.tables(dfg)
        cached = self._units_cache
        if cached is None or cached[0] is not dfg:
            self._units_cache = cached = (dfg, self.config.units_of(dfg))
        return cached[1]

    def fu_candidates(self, dfg: DFG, n: int) -> List[int]:
        op = dfg.nodes[n].op
        out = self.fu_cand_cache.get(op)
        if out is None:
            out = [
                fu.id for fu in self.arch.fus
                if op in ("const", "input", "output") or op in fu.ops
            ]
            self.fu_cand_cache[op] = out
        return list(out)  # callers shuffle in place

    def new_mrrg(self, ii: int) -> MRRG:
        return MRRG(self.arch, ii, stats=self.stats.route)

    # -- deadline -------------------------------------------------------------
    def set_deadline(self, deadline: Optional[float]):
        """Arm (or clear) the cooperative wall-clock deadline — a
        ``time.monotonic()`` timestamp, not a duration."""
        self.deadline = deadline
        self._deadline_t0 = monotonic() if deadline is not None else None

    def check_deadline(self, where: str = ""):
        """Raise :class:`~repro_torch.compiler.errors.CompileTimeout` if the
        armed deadline has passed.

        Deliberately a **pure clock read**: no RNG draw, no state mutation
        — a compile that finishes inside its deadline is bit-identical
        (same II, same mapping) to one run with no deadline at all, which
        is what keeps the golden-II records valid under ``deadline_s``.
        The exception carries the partial per-pass stats accumulated so
        far, so a timeout is still attributable to the pass that consumed
        the budget.
        """
        dl = self.deadline
        if dl is None:
            return
        now = monotonic()
        if now < dl:
            return
        t0 = self._deadline_t0
        elapsed = (now - t0) if t0 is not None else None
        budget = (dl - t0) if t0 is not None else None
        raise CompileTimeout(
            f"place & route exceeded its wall-clock deadline"
            + (f" of {budget:.3g}s" if budget is not None else "")
            + (f" at {where}" if where else ""),
            deadline_s=budget,
            elapsed_s=elapsed,
            where=where,
            pass_stats=self.stats.snapshot(self.route_cache)["passes"],
        )

    # -- pass execution -----------------------------------------------------
    def run(self, pss: MapperPass, state: MapState) -> str:
        """Run one pass, accumulating its wall time in the per-pass stats
        (composite passes tick their own phase rows instead).  The armed
        deadline is checked before every pass: pipelines time out between
        stages even if no inner loop cooperates."""
        self.check_deadline(f"before pass {pss.name}")
        if pss.self_timed:
            return pss.run(self, state)
        t0 = perf_counter()
        try:
            return pss.run(self, state)
        finally:
            self.stats.tick_pass(pss.name, perf_counter() - t0)

    def tick(self, name: str, wall_s: float, **counters: int):
        """Sub-pass accounting hook for composite passes (e.g. the
        negotiated multi-start construction times its placement and
        negotiation phases separately)."""
        self.stats.tick_pass(name, wall_s, **counters)
