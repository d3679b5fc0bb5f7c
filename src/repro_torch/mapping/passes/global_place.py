"""Global analytic placement (the global-then-detailed tentpole).

Port of ``repro/mapping/passes/global_place.py``, line for line,
over the port's own modules.

:class:`GlobalPlacer` produces a *seed placement* — a ``{node: (fu, t)}``
warm start — in three vectorized stages over the clustering core
(:mod:`repro_torch.mapping.cluster`):

1. **Cluster.**  The DFG is clustered at the motif-unit level (the same
   ``units_of`` decomposition the detailed passes consume, so motif
   knowledge carries through), and unit affinities are counted from the
   intra edges crossing unit boundaries.
2. **Relax.**  A quadratic wirelength objective over the tile grid is
   relaxed by Jacobi sweeps (:func:`~repro_torch.mapping.cluster.relax_positions`)
   from ASAP-depth-spread initial positions — connected units pull
   together, the min-max rescale keeps the cloud spread over the fabric.
3. **Legalize.**  Units are snapped onto concrete FU×cycle slots in
   dependency order, reusing the detailed engine's cached candidate
   arrays and its exact span/reachability filters
   (:meth:`~repro_torch.mapping.passes.place.UnitPlacer.span_mask` /
   ``reachable_mask`` over the routing engine's distance tables), picking
   per unit the free candidate nearest its relaxed position
   (``np.lexsort`` — deterministic, ties resolve to enumeration order).

The seed is *advisory*: units that legalize nowhere are skipped, and the
detailed passes fall back to their from-scratch scans per unit
(:meth:`UnitPlacer.place_unit_seeded` refuses stale slots).  Quality is
therefore structurally no worse than the unseeded composition — the
seeded attempt is one extra restart in front of the unchanged restart
loop (golden-gated in ``tests/test_global_place.py`` and ci.sh).
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.mapping.cluster import affinity_matrix, relax_positions
from repro_torch.mapping.mapping import Mapping
from repro_torch.mapping.passes.base import CONTINUE, MapperPass, MapState, PassContext


class GlobalPlacer:
    """Vectorized global placement over the FU×FU distance tables."""

    #: Jacobi sweeps of the quadratic relaxation
    relax_iters = 32
    #: anchor weight tying clusters to their ASAP-depth start positions
    anchor_w = 0.25

    def __init__(self, ctx: PassContext):
        self.ctx = ctx
        self.placer = ctx.placer

    # -- stage 1+2: cluster + relax ------------------------------------------
    def relaxed_positions(self, dfg, units) -> np.ndarray:
        """Continuous (row, col) tile positions per unit after relaxation."""
        arch = self.ctx.arch
        tab = self.ctx.tables(dfg)
        n_units = len(units)
        owner = {n: ui for ui, u in enumerate(units) for n in u.nodes}
        W = affinity_matrix(dfg, owner, n_units)
        depth = np.asarray(
            [min(tab.asap[n] for n in u.nodes) for u in units],
            dtype=np.float64,
        )
        max_depth = depth.max() if depth.size and depth.max() > 0 else 1.0
        rows = max(arch.rows - 1, 0)
        cols = max(arch.cols - 1, 0)
        # initial positions: dependency depth sweeps down the rows, a
        # golden-ratio sequence spreads units across the columns (both
        # deterministic; the relaxation pulls connected units together)
        x0 = depth / max_depth * rows
        y0 = ((np.arange(n_units) * 0.6180339887498949) % 1.0) * cols
        pos0 = np.stack([x0, y0], axis=1)
        return relax_positions(W, pos0, (float(rows), float(cols)),
                               anchor_w=self.anchor_w,
                               iters=self.relax_iters)

    # -- stage 3: legalization -----------------------------------------------
    def seed_placement(self, dfg, units, ii: int
                       ) -> Optional[Dict[int, Tuple[int, int]]]:
        """Legalize the relaxed positions onto FU×cycle slots.

        Returns a (possibly partial) ``{node: (fu, t)}`` seed, or ``None``
        when there is nothing to seed.  Bookkeeping only — no MRRG is
        touched and no routing runs; the span/reachability filters are the
        same one-sided (never-rejects-a-routable-candidate) predicates the
        detailed scan uses."""
        if not units:
            return None
        placer = self.placer
        arch = self.ctx.arch
        # the relaxation is II-independent: cache it per DFG so the II
        # sweep legalizes fresh each attempt but relaxes only once
        cached = self.ctx.relax_pos_cache
        if cached is not None and cached[0] is dfg:
            pos = cached[1]
        else:
            pos = self.relaxed_positions(dfg, units)
            self.ctx.relax_pos_cache = (dfg, pos)
        eng = None
        seed_map = Mapping(dfg, ii, arch=arch)
        occ = np.zeros(len(arch.fus) * ii, dtype=bool)
        for ui, u in enumerate(units):
            cols, F_all, T0 = placer.candidate_arrays(dfg, u, ii)
            if F_all.shape[0] == 0:
                continue
            T_all = T0 + placer.unit_ready(dfg, seed_map, u)
            mask = placer.span_mask(dfg, seed_map, cols, F_all, T_all)
            if not mask.any():
                continue
            F = F_all[mask]
            T = T_all[mask]
            if eng is None:
                from repro_torch.core.routing import engine_for
                eng = engine_for(arch)
            keep = placer.reachable_mask(dfg, seed_map, cols, F, T, ii, eng)
            F = F[keep]
            T = T[keep]
            if F.shape[0] == 0:
                continue
            slots = F * ii + T % ii
            free = ~occ[slots].any(axis=1)
            if slots.shape[1] > 1:
                srt = np.sort(slots, axis=1)
                free &= (srt[:, 1:] != srt[:, :-1]).all(axis=1)
            if not free.any():
                continue
            F = F[free]
            T = T[free]
            slots = slots[free]
            fx, fy, _, _ = eng.fu_aux()
            fu0 = F[:, 0]
            dist = (np.abs(fx[fu0] - pos[ui, 0])
                    + np.abs(fy[fu0] - pos[ui, 1]))
            maxt = T.max(axis=1)
            # nearest-to-relaxed-position first, earliest-finishing as the
            # tie-break; lexsort is stable, so exact ties resolve to the
            # candidate enumeration order
            pick = int(np.lexsort((maxt, np.round(dist, 9)))[0])
            for j, n in enumerate(cols):
                seed_map.place[n] = int(F[pick, j])
                seed_map.time[n] = int(T[pick, j])
            occ[slots[pick]] = True
        if not seed_map.place:
            return None
        return {n: (seed_map.place[n], seed_map.time[n])
                for n in seed_map.place}


class GlobalPlacementPass(MapperPass):
    """Pipeline stage wrapping :class:`GlobalPlacer`.

    Runs only when the owning mapper's ``global_seed`` knob is on (read at
    use time, like every other config attribute) — compositions that keep
    it off are bit-identical to pipelines without this stage.  The seed is
    handed to the detailed passes through ``state.scratch["global_seed"]``
    and the stage ticks its own ``global_place`` row (units clustered,
    nodes seeded) into the uniform per-pass stats schema."""

    name = "global_place"
    self_timed = True

    def run(self, ctx: PassContext, state: MapState) -> str:
        if not getattr(ctx.config, "global_seed", False):
            return CONTINUE
        t0 = perf_counter()
        units = state.units if state.units is not None \
            else ctx.units_for(state.dfg)
        seed = GlobalPlacer(ctx).seed_placement(state.dfg, units, state.ii)
        if seed:
            state.scratch["global_seed"] = seed
        ctx.tick("global_place", perf_counter() - t0,
                 units=len(units or ()), seeded=len(seed or ()))
        return CONTINUE
