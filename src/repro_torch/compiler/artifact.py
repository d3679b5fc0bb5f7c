"""Serializable mapping artifacts (port of ``repro/compiler/artifact.py``).

A :class:`CompileResult` is the JSON form of one compile (schema
``repro.compiler/artifact@1``..``@5``, written by either package's
``compile()``): the headline numbers, per-stage timings, motif-cover and
per-pass statistics, the full placement/routing mapping(s) with their
DFG, and, from ``@5`` on, the lowered ``compiled_sim`` forms bound to the
mappings by ``mappings_sha256``.  :meth:`CompileResult.to_json` writes the
JAX package's form, keys in its order, so the artifact store
(:mod:`repro_torch.compiler.store`) digests alike in both packages.
:meth:`CompileResult.simulate` rebuilds and validates the stored
mapping(s) against their fabric, then re-verifies them on the card,
without re-running place & route.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.errors import (SIM_FAULTS, MappingInfeasible,
                                         SimulationFault)
from repro_torch.compiler.fsio import atomic_write_json, sha256_of_json
from repro_torch.mapping.mapping import (Mapping, mapping_from_record,
                                         normalize_record)

ARTIFACT_SCHEMA = "repro.compiler/artifact@5"
SUPPORTED_SCHEMAS = ("repro.compiler/artifact@1", "repro.compiler/artifact@2",
                     "repro.compiler/artifact@3", "repro.compiler/artifact@4",
                     ARTIFACT_SCHEMA)
#: the JAX package's toolchain version: store keys are namespaced by it
REPRO_VERSION = "0.4.0"


@dataclass
class CompileResult:
    """One loaded artifact (see the JAX package's module docstring for the
    on-disk schema)."""

    arch: str
    mapper: str
    seed: int
    budget: Optional[int] = None
    workload: Dict[str, object] = field(default_factory=dict)
    ii: Optional[int] = None
    cycles: Optional[int] = None
    makespan: Optional[int] = None
    timings: Dict[str, float] = field(default_factory=dict)
    motifs: Optional[Dict[str, int]] = None
    mappings: List[Dict[str, object]] = field(default_factory=list)
    spatial: Optional[Dict[str, object]] = None
    #: lowered ``repro.sim/compiled@1`` forms of ``mappings``, bound to
    #: them by ``mappings_sha256``; a mismatch means "lower freshly"
    compiled_sim: Optional[Dict[str, object]] = None
    verified: Optional[bool] = None
    degraded: Optional[Dict[str, object]] = None
    provenance: Dict[str, object] = field(default_factory=dict)
    route_cache: Optional[Dict[str, object]] = None
    #: uniform per-pass breakdown from the mapper's pass pipeline: one row
    #: per pass ({"name", "wall_s", "calls", ...}), in execution order
    pass_stats: Optional[List[Dict[str, object]]] = None
    #: set by ``compile(..., store=...)`` only: True = served from the
    #: store without P&R, False = freshly compiled (and inserted), None =
    #: no store involved.  Runtime-only — never serialized, so a hit
    #: round-trips byte-identically to the artifact it was stored from.
    store_hit: Optional[bool] = field(default=None, compare=False)

    @property
    def key(self) -> str:
        """Workload key as used by the collect cache / golden files."""
        w = self.workload
        if "name" in w and "unroll" in w:
            return f"{w['name']}_u{w['unroll']}"
        return str(w.get("dfg_name", "dfg"))

    @property
    def mapped(self) -> bool:
        return bool(self.mappings) or (
            self.spatial is not None and self.spatial.get("analytic")
        )

    def to_json(self) -> Dict[str, object]:
        return {
            "schema": ARTIFACT_SCHEMA,
            "workload": self.workload,
            "arch": self.arch,
            "mapper": self.mapper,
            "seed": self.seed,
            "budget": self.budget,
            "ii": self.ii,
            "cycles": self.cycles,
            "makespan": self.makespan,
            "timings": self.timings,
            "motifs": self.motifs,
            "mappings": self.mappings,
            "spatial": self.spatial,
            "compiled_sim": self.compiled_sim,
            "verified": self.verified,
            "degraded": self.degraded,
            "provenance": self.provenance,
            "route_cache": self.route_cache,
            "pass_stats": self.pass_stats,
        }

    @classmethod
    def from_json(cls, data: Dict[str, object]) -> "CompileResult":
        schema = data.get("schema")
        if schema not in SUPPORTED_SCHEMAS:
            raise ValueError(
                f"unsupported artifact schema {schema!r} "
                f"(supported: {', '.join(SUPPORTED_SCHEMAS)})"
            )
        mappings = [normalize_record(rec) for rec in data.get("mappings", [])]
        return cls(
            arch=data["arch"],
            mapper=data["mapper"],
            seed=int(data["seed"]),
            budget=data.get("budget"),
            workload=data.get("workload") or {},
            ii=data.get("ii"),
            cycles=data.get("cycles"),
            makespan=data.get("makespan"),
            timings=data.get("timings") or {},
            motifs=data.get("motifs"),
            mappings=mappings,
            spatial=data.get("spatial"),
            compiled_sim=data.get("compiled_sim"),
            verified=data.get("verified"),
            degraded=data.get("degraded"),
            provenance=data.get("provenance") or {},
            route_cache=data.get("route_cache"),
            pass_stats=data.get("pass_stats"),
        )

    def save(self, path: str) -> str:
        # temp-file + os.replace: an interrupted save leaves the previous
        # artifact intact, never a truncated file
        return atomic_write_json(path, self.to_json(), indent=1,
                                 sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CompileResult":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- re-verification (no P&R) ------------------------------------------
    def rebuild_mappings(self) -> List[Mapping]:
        """Live, validated :class:`Mapping` objects for every stored record
        (one per spatial segment; exactly one for modulo mappers)."""
        return [mapping_from_record(rec, self.arch) for rec in self.mappings]

    def populate_compiled_sim(self, iterations: int = 3) -> bool:
        """Lower the stored mappings into ``repro.sim/compiled@1`` form and
        attach them as ``compiled_sim`` (segments the lowering cannot
        express are recorded as ``null``).  Returns ``False`` — leaving
        the artifact unchanged — when there is nothing lowerable; never
        raises: the forms are an accelerator, not a requirement."""
        from repro_torch.sim.lower import LoweringUnsupported, lower_mapping

        if not self.mappings:
            return False
        try:
            rebuilt = self.rebuild_mappings()
        except (ValueError, KeyError):
            return False
        forms: List[Optional[Dict[str, object]]] = []
        for m in rebuilt:
            try:
                forms.append(lower_mapping(m, iterations=iterations)
                             .to_json())
            except LoweringUnsupported:
                forms.append(None)
        self.compiled_sim = {
            "iterations": iterations,
            "mappings_sha256": sha256_of_json(self.mappings),
            "forms": forms,
        }
        return True

    def _stored_prepared(self, iterations: int, backend: str, device=None):
        """Rebuild a :class:`~repro_torch.sim.batch.PreparedBatch` for
        ``backend`` on ``device`` from the artifact's ``compiled_sim``
        forms, or ``None``
        when they are absent, lowered for a different trip count,
        malformed, or no longer bound to the mapping content
        (``mappings_sha256`` mismatch) — every ``None`` means "lower
        freshly"."""
        cs = self.compiled_sim
        if not isinstance(cs, dict) or not self.mappings:
            return None
        if cs.get("iterations") != iterations:
            return None
        forms_json = cs.get("forms")
        if not isinstance(forms_json, list) \
                or len(forms_json) != len(self.mappings):
            return None
        if cs.get("mappings_sha256") != sha256_of_json(self.mappings):
            return None
        from repro_torch.sim.batch import (PreparedBatch, bucket_device,
                                           pack_bucket)
        from repro_torch.sim.lower import CompiledSim

        scalar_idx: List[int] = []
        batch_idx: List[int] = []
        forms = []
        try:
            for i, fj in enumerate(forms_json):
                if fj is None:
                    scalar_idx.append(i)
                else:
                    batch_idx.append(i)
                    forms.append(CompiledSim.from_json(fj))
        except (KeyError, TypeError, ValueError):
            return None
        return PreparedBatch(
            iterations=iterations, n_mappings=len(self.mappings),
            scalar_idx=scalar_idx, batch_idx=batch_idx, forms=forms,
            packed=(pack_bucket(forms, bucket_device(backend, device))
                    if forms else None))

    def simulate(self, iterations: int = 3, device=None,
                 backend: Optional[str] = None
                 ) -> List[Dict[Tuple[int, int], float]]:
        """Cycle-accurately execute the stored mapping(s) against the DFG
        reference oracle on ``device`` (default ``cuda``; ``backend`` as
        :func:`~repro_torch.sim.batch.select_backend` takes it); returns
        the per-(node, iteration) value dict of each mapping.  Raises
        :class:`~repro_torch.compiler.errors.MappingInfeasible` (a
        ``ValueError``) if no routed mapping was stored (mapper failure,
        or the spatial analytic fallback).

        The records are rebuilt and validated first (``AssertionError``
        on a structural fault).  Every mapping then goes through the
        batched path (:func:`~repro_torch.sim.batch.verify_mappings`),
        reusing the stored ``compiled_sim`` forms when they bind.  A
        disproven mapping raises ``AssertionError``; a device fault
        propagates — it never degrades to the scalar oracle, which would
        hide the kernel.  Anything else the simulation raises is a
        :class:`~repro_torch.compiler.errors.SimulationFault`, not a
        verdict."""
        from repro_torch.sim.batch import select_backend, verify_mappings

        if not self.mappings:
            raise MappingInfeasible(
                f"artifact {self.key}/{self.mapper} holds no routed mapping "
                "to simulate"
            )
        backend = select_backend(backend, device)
        rebuilt = self.rebuild_mappings()
        try:
            return verify_mappings(rebuilt, iterations=iterations,
                                   device=device, backend=backend,
                                   prepared=self._stored_prepared(
                                       iterations, backend, device))
        except SIM_FAULTS as e:
            raise SimulationFault(
                f"simulating {self.key}/{self.mapper} failed "
                f"({type(e).__name__}: {e})") from e

    # -- display -----------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        out = {
            "key": self.key,
            "arch": self.arch,
            "mapper": self.mapper,
            "seed": self.seed,
            "ii": self.ii,
            "cycles": self.cycles,
            "makespan": self.makespan,
            "segments": len(self.mappings),
            "verified": self.verified,
            "timings": {k: round(v, 3) for k, v in self.timings.items()},
        }
        if self.route_cache:
            out["route_cache"] = self.route_cache
        if self.pass_stats:
            out["passes"] = self.pass_stats
        if self.motifs:
            out["motifs"] = self.motifs
        if self.spatial:
            out["spatial"] = self.spatial
        if self.degraded:
            out["degraded"] = self.degraded
        return out


def new_provenance() -> Dict[str, object]:
    return {
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "repro_version": REPRO_VERSION,
        # whether REPRO_QUICK budget clamping was live at compile time —
        # the store key needs it (a clamped-budget mapping must never be
        # served to a full-budget consumer), and only the artifact itself
        # can carry it into a later `store put`
        "quick": bool(os.environ.get("REPRO_QUICK")),
    }
