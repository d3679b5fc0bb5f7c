"""The compile pipeline: workload -> DFG -> place & route -> artifact (port
of ``repro/compiler/pipeline.py``).

:func:`compile` is the front door of the port's toolchain::

    from repro_torch.compiler.pipeline import compile

    result = compile("atax", unroll=2, arch="plaid2x2", mapper="hierarchical",
                     seed=0, verify=True)          # verifies on the card
    result.ii, result.cycles, result.timings
    result.save("atax_u2.json")

Every mapper and architecture is looked up by its registered name
(:mod:`repro_torch.compiler.registry`); the evaluation grid
(:func:`job_grid`) is assembled from the mappers' registration metadata.
With the same (workload, arch, mapper, seed, budget) inputs the port
constructs and runs the mapper exactly as the JAX package does, so the
mappings, IIs and cycle counts are the JAX package's, bit for bit, and a
store written by either package serves the other.

Verification (``verify=True``) lowers the mapping(s) into their
``compiled_sim`` forms and proves them through
:meth:`CompileResult.simulate` on ``device`` (``cuda`` unless the caller
asks for the CPU): one ``sim_loop`` launch a bucket on a card.  A
disproven mapping records ``verified=False``; a device fault propagates —
nothing degrades to the scalar oracle.  ``compile(remote=...)`` offloads a
cache miss to a compile-farm daemon (:mod:`repro_torch.serve_farm`), which
proves what it serves on its own device.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

# Importing the mapper/spatial modules populates the mapper registry.
import repro_torch.core.spatial  # noqa: F401
import repro_torch.mapping  # noqa: F401
from repro_torch.compiler.artifact import CompileResult, new_provenance
from repro_torch.compiler.errors import VERIFY_FAILURES, CompileTimeout
from repro_torch.compiler.fsio import sha256_of_json
from repro_torch.compiler.registry import ARCHES, MAPPERS
from repro_torch.compiler.store import ArtifactStore, CompileKey, open_store
from repro_torch.core.arch import make_arch
from repro_torch.core.dfg import DFG
from repro_torch.core.workloads import TABLE2, Workload, build_workload
from repro_torch.mapping.mapping import mapping_to_record

DEFAULT_ITERATIONS = 256  # TABLE2 trip count; used for raw-DFG inputs


# -- registry front-ends (registration guaranteed by the imports above) -----


def get_arch(name: str):
    """Registered architecture instance (cached per process)."""
    return make_arch(name)


def get_mapper(name: str):
    """Registered mapper factory."""
    return MAPPERS.get(name)


def list_mappers():
    return MAPPERS.names()


def list_archs():
    return ARCHES.names()


def job_grid() -> Dict[str, Tuple[str, str]]:
    """The evaluation grid, derived from mapper registrations:
    ``{job name: (arch name, mapper name)}``."""
    grid: Dict[str, Tuple[str, str]] = {}
    for mname in MAPPERS.names():
        for job, arch_name in MAPPERS.meta(mname).get("jobs", {}).items():
            grid[job] = (arch_name, mname)
    return grid


# -- frontend ----------------------------------------------------------------


def _resolve_workload(
    workload_or_dfg: Union[str, Tuple[str, int], Workload, DFG],
    unroll: Optional[int],
) -> Tuple[Optional[Workload], DFG]:
    if isinstance(workload_or_dfg, DFG):
        return None, workload_or_dfg
    if isinstance(workload_or_dfg, Workload):
        return workload_or_dfg, build_workload(workload_or_dfg)
    if isinstance(workload_or_dfg, tuple):
        workload_or_dfg, unroll = workload_or_dfg
    if isinstance(workload_or_dfg, str):
        cands = [w for w in TABLE2 if w.name == workload_or_dfg]
        if not cands:
            names = sorted({w.name for w in TABLE2})
            raise KeyError(
                f"unknown workload {workload_or_dfg!r}; TABLE2 workloads: "
                + ", ".join(names)
            )
        if unroll is None:
            w = min(cands, key=lambda w: w.unroll)  # lowest unroll variant
        else:
            match = [w for w in cands if w.unroll == unroll]
            if not match:
                raise KeyError(
                    f"workload {workload_or_dfg!r} has no unroll={unroll}; "
                    f"available: {sorted(w.unroll for w in cands)}"
                )
            w = match[0]
        return w, build_workload(w)
    raise TypeError(
        f"expected workload name / (name, unroll) / Workload / DFG, got "
        f"{type(workload_or_dfg).__name__}"
    )


def _workload_info(w: Optional[Workload], dfg: DFG,
                   iterations: int) -> Dict[str, object]:
    if w is not None:
        return {
            "name": w.name,
            "unroll": w.unroll,
            "iterations": iterations,
            "domain": w.domain,
        }
    # raw-DFG inputs carry a content hash of the INPUT graph: it is both
    # the artifact's provenance and the store key component, so
    # key_for(artifact) and compile-side keys agree even for spatial
    # artifacts whose mapping records hold per-segment sub-DFGs
    return {
        "dfg_name": dfg.name,
        "iterations": iterations,
        "dfg_sha256": sha256_of_json(dfg.to_json()),
    }


def compile_key(
    workload_or_dfg: Union[str, Tuple[str, int], Workload, DFG],
    arch: str = "plaid2x2",
    mapper: str = "hierarchical",
    seed: int = 0,
    budget: Optional[int] = None,
    *,
    unroll: Optional[int] = None,
    iterations: Optional[int] = None,
) -> CompileKey:
    """The :class:`CompileKey` ``compile`` would use for these inputs —
    canonical (aliases resolved) and cheap (no place & route).  Raw DFG
    inputs are content-hashed so two graphs sharing a name cannot collide
    in the store."""
    mapper_name = MAPPERS.resolve(mapper)
    arch_name = ARCHES.resolve(arch)
    w, dfg = _resolve_workload(workload_or_dfg, unroll)
    if iterations is None:
        iterations = w.iterations if w is not None else DEFAULT_ITERATIONS
    info = _workload_info(w, dfg, iterations)
    return CompileKey.make(info, arch_name, mapper_name, seed, budget)


def serve_from_store(store: ArtifactStore, key: CompileKey, *,
                     verify: bool = False,
                     device=None) -> Optional[CompileResult]:
    """The cache-first leg of :func:`compile`: look ``key`` up in
    ``store`` and return the artifact marked ``store_hit``, or ``None`` on
    a miss (including a store read error, which degrades to a cold compile
    with a warning).

    With ``verify=True`` an unverified hit is re-proven on ``device``
    before being served: the index verdict is trusted when present,
    otherwise the mapping is replayed (reusing the artifact's stored
    ``compiled_sim`` forms when they bind) and the verdict persisted; a
    disproven artifact is quarantined and reported as a miss so the caller
    recompiles.  A device fault propagates and leaves the entry alone.
    """
    try:
        cached = store.get(key)
    except OSError as e:  # StoreIOError included — degrade to cold
        print(f"warning: artifact store read failed ({e}); "
              f"compiling without the cache", flush=True)
        return None
    if cached is not None and verify and cached.verified is not True \
            and cached.mappings:
        # store content is untrusted: a digest-consistent but wrong or
        # unsimulatable record raises one of VERIFY_FAILURES — disproven,
        # so quarantine it and fall through to a fresh compile
        if store.is_verified(key):
            cached.verified = True
        else:
            try:
                cached.simulate(iterations=3, device=device)
                cached.verified = True
                store.mark_verified(key)  # persist: nobody re-runs
            except VERIFY_FAILURES:
                store.counters.verify_failures += 1
                store.discard(key)
                cached = None
    if cached is not None:
        cached.store_hit = True
    return cached


def _unit_stats(mapper_obj) -> Optional[Dict[str, int]]:
    """Motif-cover statistics of the unit decomposition the mapper actually
    used (the ``PassContext.units_for`` cache, surfaced by the unit
    mappers' ``_units_cache`` property); ``None`` for mappers without a
    unit decomposition (SA, spatial)."""
    cached = getattr(mapper_obj, "_units_cache", None)
    if not cached:
        return None
    units = cached[1]
    kinds = {"fanout": 0, "fanin": 0, "unicast": 0, "single": 0}
    for u in units:
        kinds[u.kind] = kinds.get(u.kind, 0) + 1
    n_motifs = sum(v for k, v in kinds.items() if k != "single")
    return {
        "n_units": len(units),
        "n_motifs": n_motifs,
        "covered": 3 * n_motifs,
        **kinds,
    }


# -- the pipeline ------------------------------------------------------------


def compile(
    workload_or_dfg: Union[str, Tuple[str, int], Workload, DFG],
    arch: str = "plaid2x2",
    mapper: str = "hierarchical",
    seed: int = 0,
    budget: Optional[int] = None,
    *,
    unroll: Optional[int] = None,
    iterations: Optional[int] = None,
    verify: bool = False,
    store: Optional[Union[str, ArtifactStore]] = None,
    remote: Optional[str] = None,
    deadline_s: Optional[float] = None,
    fallback_mapper: Optional[str] = None,
    fallback_deadline_s: Optional[float] = None,
    device=None,
) -> CompileResult:
    """Run the full pipeline and return a serializable :class:`CompileResult`.

    ``workload_or_dfg``: a TABLE2 workload name (optionally with ``unroll``),
    a ``(name, unroll)`` tuple, a :class:`Workload`, or a raw :class:`DFG`.
    ``arch`` / ``mapper``: registered names (:class:`RegistryError` lists the
    options on a typo).  ``budget`` overrides the mapper's SA/negotiation
    step budget; ``None`` keeps the registered default — required for
    golden-II reproducibility.  ``verify=True`` additionally proves the
    mapping on ``device`` (``cuda`` unless the caller passes ``"cpu"``;
    checked before place & route, so a missing card fails at once) and
    records the outcome.

    ``store`` (an :class:`ArtifactStore` or a path) makes the compile
    **cache-first**: a stored artifact for this exact (workload, arch,
    mapper, seed, budget) key is returned without running place & route
    (``result.store_hit`` is ``True``), and a miss is compiled normally
    and inserted.  Store I/O failures are survivable: an unreadable store
    degrades to a cold compile and an unwritable one to an uncached
    result, each with a warning.

    ``remote`` (a Unix-socket path) offloads a cache miss to a ``python -m
    repro_torch serve`` farm daemon (:mod:`repro_torch.serve_farm`)
    instead of compiling locally: the request is retried with bounded
    exponential backoff, and when the farm stays unreachable (circuit
    breaker open, daemon draining) the compile **falls back to local**
    with a warning.  A farm-side overload shed
    (:class:`~repro_torch.compiler.errors.ServiceOverloaded`) that
    outlasts the retries propagates typed.  Raw ``DFG`` inputs are never
    farmed (the protocol ships workload names, not graphs) and compile
    locally with a warning.  The request carries no device: the farm
    proves what it serves on its own.

    ``deadline_s`` bounds place & route by wall clock: the pass pipelines
    check it cooperatively and raise
    :class:`~repro_torch.compiler.errors.CompileTimeout` carrying the
    partial per-pass stats.  The checks are pure clock reads — a compile
    that finishes inside its deadline is bit-identical to one run without
    it.

    ``fallback_mapper`` turns a timeout or an infeasible primary mapping
    into graceful degradation: the named mapper is re-run on the same
    inputs — with no deadline unless ``fallback_deadline_s`` is given —
    and the artifact is stamped with a ``degraded`` block instead of
    raising.
    Degraded and verify-failed artifacts never enter the store.
    """
    t0 = time.perf_counter()
    if verify:
        # a card that is absent (or a device that is misnamed) is the
        # caller's error: refuse before spending the place & route on it
        from repro_torch.sim.batch import select_backend

        select_backend(None, device)
    mapper_name = MAPPERS.resolve(mapper)
    meta = MAPPERS.meta(mapper_name)
    # the artifact records the REGISTERED name (what load()/simulate()
    # feed back to make_arch), not Arch.name
    arch_name = ARCHES.resolve(arch)
    arch_obj = make_arch(arch_name)

    w, dfg = _resolve_workload(workload_or_dfg, unroll)
    if iterations is None:
        iterations = w.iterations if w is not None else DEFAULT_ITERATIONS
    workload_info = _workload_info(w, dfg, iterations)

    key: Optional[CompileKey] = None
    if store is not None:
        store = open_store(store, device=device)
        key = CompileKey.make(workload_info, arch_name, mapper_name, seed,
                              budget)
        cached = serve_from_store(store, key, verify=verify, device=device)
        if cached is not None:
            return cached
    if remote is not None:
        if w is None:
            print("warning: raw DFG inputs cannot be farmed (the protocol "
                  "ships workload names); compiling locally", flush=True)
        else:
            from repro_torch.compiler.errors import FarmUnavailable
            from repro_torch.serve_farm.client import remote_compile

            try:
                return remote_compile(
                    remote, workload=w.name, unroll=w.unroll,
                    arch=arch_name, mapper=mapper_name, seed=seed,
                    budget=budget, iterations=iterations, verify=verify,
                    deadline_s=deadline_s)
            except FarmUnavailable as e:
                print(f"warning: {e}; compiling locally", flush=True)
    t_frontend = time.perf_counter()

    def _pnr(name: str, dl_s: Optional[float]):
        """Construct the named mapper exactly as the JAX package does
        (determinism contract) and run it, optionally under a cooperative
        wall-clock deadline."""
        f = MAPPERS.get(name)
        if budget is None:
            m = f(arch_obj, seed=seed)
        else:
            m = f(arch_obj, seed=seed, time_budget=budget)
        if dl_s is not None:
            set_dl = getattr(m, "set_deadline", None)
            if set_dl is not None:
                set_dl(time.monotonic() + dl_s)
        return m, m.map(dfg)

    degraded: Optional[Dict[str, object]] = None
    fb_name = (MAPPERS.resolve(fallback_mapper)
               if fallback_mapper is not None else None)
    try:
        mapper_obj, result = _pnr(mapper_name, deadline_s)
        # infeasibility leg: the primary mapper exhausted its II range
        # without a mapping and a fallback exists
        if (result is None and fb_name is not None
                and meta.get("result") != "spatial"):
            degraded = {
                "requested_mapper": mapper_name,
                "fallback": fb_name,
                "reason": "infeasible",
            }
    except CompileTimeout as e:
        e.elapsed_s = e.elapsed_s or (time.perf_counter() - t_frontend)
        if fb_name is None:
            raise
        # timeout leg: re-run with the fallback mapper, unbounded unless
        # the caller set a deadline for it too
        degraded = {
            "requested_mapper": mapper_name,
            "fallback": fb_name,
            "reason": "timeout",
            "deadline_s": deadline_s,
            "elapsed_s": round(e.elapsed_s, 3),
        }
        if e.where:
            degraded["where"] = e.where
    if degraded is not None:
        mapper_name = fb_name
        meta = MAPPERS.meta(fb_name)
        mapper_obj, result = _pnr(fb_name, fallback_deadline_s)
    t_pnr = time.perf_counter()

    # per-stage P&R split + route-cache counters (the spatial mapper
    # exposes no engine_stats)
    est = getattr(mapper_obj, "engine_stats", None)
    est = est() if callable(est) else None

    out = CompileResult(
        arch=arch_name,
        mapper=mapper_name,
        seed=seed,
        budget=budget,
        workload=workload_info,
        motifs=_unit_stats(mapper_obj),
        provenance=new_provenance(),
    )
    out.degraded = degraded

    if meta.get("result") == "spatial":
        sp = result
        out.ii = 1 if sp.segments else None  # spatial = frozen II=1 configs
        out.cycles = sp.cycles(iterations)
        out.makespan = max((m.makespan for m in sp.segments), default=None)
        out.mappings = [mapping_to_record(m) for m in sp.segments]
        out.spatial = {
            "segments": sp.n_segments,
            "extra_mem_ops": sp.extra_mem_ops,
            "analytic": bool(sp.analytic_segments),
        }
    elif result is not None:
        out.ii = result.ii
        out.cycles = result.cycles(iterations)
        out.makespan = result.makespan
        out.mappings = [mapping_to_record(result)]

    t_verify = t_pnr
    if verify:
        if out.mappings:
            # persist the lowered sim forms alongside the mapping: the
            # verification below reuses them (no double lowering), and so
            # does a later verify-on-load consumer
            out.populate_compiled_sim(iterations=3)
            try:
                out.simulate(iterations=3, device=device)
                out.verified = True
            except AssertionError:
                out.verified = False
        else:
            out.verified = False  # verification requested, nothing mapped
        t_verify = time.perf_counter()

    out.timings = {
        "frontend": t_frontend - t0,
        "pnr": t_pnr - t_frontend,
        "verify": t_verify - t_pnr,
        "total": time.perf_counter() - t0,
    }
    if est is not None:
        pnr = out.timings["pnr"]
        route = float(est.get("route_s", 0.0))
        negotiate = float(est.get("negotiate_s", 0.0))
        # "route" carries ALL router wall time (including re-routes issued
        # by negotiation rounds); "negotiate" is only the rounds' non-route
        # share, so the three stages partition P&R
        out.timings["route"] = route
        out.timings["negotiate"] = negotiate
        out.timings["place"] = max(0.0, pnr - route - negotiate)
        out.route_cache = est.get("route_cache")
        out.pass_stats = est.get("passes") or None
    if store is not None and key is not None:
        # a verify-FAILED mapping must never enter the store, and neither
        # may a DEGRADED one: its key names the requested mapper, but its
        # mapping came from the fallback
        if out.verified is not False and out.degraded is None:
            try:
                store.put(out, key=key)
            except OSError as e:  # StoreIOError included — stay uncached
                print(f"warning: artifact store write failed ({e}); "
                      f"result not cached", flush=True)
        out.store_hit = False
    return out


compile_workload = compile  # alias that does not shadow builtins at call sites
