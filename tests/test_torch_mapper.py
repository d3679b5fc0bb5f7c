"""The port's mapper (``repro_torch.mapping``, ``repro_torch.core.{dfg,
workloads,routing,spatial}``) against the JAX package's, layer by layer,
on the same inputs.  Tolerance: exact equality for every record, table,
path, cost and counter.

* ``rec_mii`` and ``recurrence_edges`` on ``random_dag`` seeds 0-4, with
  loop-carried edges drawn by numpy from the seed;
* the TABLE2 DFGs against the corpus files' stored ``dfg`` (edge indices
  included), and the quick / keyed workload lists;
* ``engine_for(arch)``'s distance tables and per-FU caches for every
  registered arch;
* ``route_edge`` (each search core, with and without overuse) and
  ``Router.route_edge_list`` on atax_u2's stored placement;
* ``motif_templates`` and ``hierarchical_units`` / ``node_units``;
* ``pack_segments``, and ``relax_positions`` on one affinity matrix;
* every registered mapper's ``Mapping`` record and ``MapperStats``
  counters on atax_u2, bicg_u2 and two ``random_dag`` graphs at seed 0.
"""
import numpy as np
import pytest

import repro.core.spatial  # noqa: F401  (registers the spatial mapper)
import repro.mapping  # noqa: F401
from repro.compiler.artifact import mapping_to_record as jax_record
from repro.compiler.registry import MAPPERS as JAX_MAPPERS
from repro.core import dfg as jax_dfg
from repro.core import routing as jax_routing
from repro.core import workloads as jax_workloads
from repro.core.arch import make_arch as jax_arch
from repro.mapping import cluster as jax_cluster
from repro.mapping import mrrg as jax_mrrg
from repro.mapping.passes import extract as jax_extract
from repro.mapping.passes import route as jax_route

import repro_torch.core.spatial  # noqa: F401
import repro_torch.mapping  # noqa: F401
from repro_torch.compiler.artifact import CompileResult
from repro_torch.compiler.registry import MAPPERS, ARCHES
from repro_torch.core import dfg as port_dfg
from repro_torch.core import routing as port_routing
from repro_torch.core import workloads as port_workloads
from repro_torch.core.arch import make_arch as port_arch
from repro_torch.mapping import cluster as port_cluster
from repro_torch.mapping import mrrg as port_mrrg
from repro_torch.mapping.mapping import mapping_to_record as port_record
from repro_torch.mapping.passes import extract as port_extract
from repro_torch.mapping.passes import route as port_route

from _torch_artifacts import CORPUS, corpus_json

JAX = dict(dfg=jax_dfg, workloads=jax_workloads, routing=jax_routing,
           arch=jax_arch, cluster=jax_cluster, mrrg=jax_mrrg,
           extract=jax_extract, route=jax_route, mappers=JAX_MAPPERS,
           record=jax_record)
PORT = dict(dfg=port_dfg, workloads=port_workloads, routing=port_routing,
            arch=port_arch, cluster=port_cluster, mrrg=port_mrrg,
            extract=port_extract, route=port_route, mappers=MAPPERS,
            record=port_record)
PKGS = (JAX, PORT)
#: the DFGs each mapper maps: two TABLE2 workloads and two random graphs
MAPPER_DFGS = ("atax_u2", "bicg_u2", "rand0_n12", "rand1_n16")
#: the fields of MapperStats.snapshot that read the clock
CLOCK = ("route_s", "negotiate_s", "wall_s")


def same(a, b) -> bool:
    """Exact structural equality through dicts, sequences and numpy arrays
    (values, shapes and dtypes)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def with_recurrences(pkg, n: int, seed: int):
    """``random_dag(n, seed)`` plus loop-carried edges (consumer earlier in
    the order than the producer, distance 1-3) drawn by numpy from the
    seed, a self-recurrence and one edge closing a two-node cycle: the
    same graph in either package."""
    g = pkg["dfg"].random_dag(n, seed=seed)
    rng = np.random.default_rng(seed)
    ids = sorted(g.nodes)
    for _ in range(int(rng.integers(1, 4))):
        a, b = sorted(int(x) for x in rng.choice(ids, 2, replace=False))
        g.connect(b, a, distance=int(rng.integers(1, 4)))
    g.connect(ids[-1], ids[-1], distance=2)  # a self-recurrence
    e = g.intra_edges()[-1]
    g.connect(e.dst, e.src, distance=1)  # closes a cycle of latency 2
    return g


def build(pkg, key: str):
    """A TABLE2 workload (``name_uU``) or a random graph (``randS_nN``)."""
    if key.startswith("rand"):
        seed, n = key[len("rand"):].split("_n")
        return pkg["dfg"].random_dag(int(n), seed=int(seed))
    name, u = key.rsplit("_u", 1)
    wl = pkg["workloads"]
    return wl.build_workload(wl.workload_by_name(name, int(u)))


@pytest.mark.parametrize("seed", range(5))
def test_rec_mii_and_recurrence_edges_on_random_dags(seed):
    jg, pg = (with_recurrences(p, 10 + 3 * seed, seed) for p in PKGS)
    assert pg.to_json() == jg.to_json()
    assert ([(e.src, e.dst, e.distance) for e in pg.recurrence_edges()]
            == [(e.src, e.dst, e.distance) for e in jg.recurrence_edges()])
    for lat in (1, 2, 3):
        assert pg.rec_mii(lat) == jg.rec_mii(lat)
    assert pg.rec_mii() > 1
    for a in pg.nodes:
        assert pg.succs(a) == jg.succs(a)
        assert pg.succs(a, intra_only=False) == jg.succs(a, intra_only=False)
        for b in pg.nodes:
            assert pg._shortest_path_len(a, b) == jg._shortest_path_len(a, b)
    assert pg.memory_nodes == jg.memory_nodes
    pg.validate()


def test_random_dag_equals_jax_over_sizes_and_fractions():
    for seed in range(10):
        for n, p, mem in ((1, 0.25, 0.3), (8, 0.5, 0.0), (30, 0.1, 0.6)):
            assert (port_dfg.random_dag(n, seed, p, mem).to_json()
                    == jax_dfg.random_dag(n, seed, p, mem).to_json())


def _workload_keys():
    return [f"{w.name}_u{w.unroll}" for w in jax_workloads.TABLE2]


@pytest.mark.parametrize("key", _workload_keys())
def test_workload_dfg_equals_corpus(key):
    """The built DFG equals the JAX package's and the stored ``dfg`` of
    each corpus artifact that maps it whole (node ids, ops, names, edge
    order, distances and operand slots)."""
    pg, jg = build(PORT, key), build(JAX, key)
    assert pg.to_json() == jg.to_json()
    stored = [rec["dfg"] for job in ("plaid", "plaid3x3", "plaid_ml", "st",
                                     "node_on_plaid", "pf_on_plaid")
              for rec in corpus_json(f"{key}__{job}.json")["mappings"]]
    assert stored, key
    for dfg in stored:
        assert dfg == pg.to_json()
    assert pg.rec_mii() == jg.rec_mii()


def test_workload_tables_equal_jax():
    def rows(wl, table):
        return [(w.name, w.unroll, w.domain, w.iterations) for w in table]

    assert rows(port_workloads, port_workloads.TABLE2) == \
        rows(jax_workloads, jax_workloads.TABLE2)
    assert rows(port_workloads, port_workloads.quick_workloads()) == \
        rows(jax_workloads, jax_workloads.quick_workloads())
    keys = ["gemm_u2", "atax_u4", "jacobi_u1"]
    assert rows(port_workloads, port_workloads.workloads_by_keys(
        port_workloads.TABLE2, keys)) == rows(
        jax_workloads, jax_workloads.workloads_by_keys(
            jax_workloads.TABLE2, keys))
    with pytest.raises(KeyError):
        port_workloads.workloads_by_keys(port_workloads.TABLE2, ["nope_u9"])


def _engine_state(pkg, name):
    arch = pkg["arch"](name)
    eng = pkg["routing"].engine_for(arch)
    assert arch.routing_engine() is eng
    for fu in arch.fus:
        eng.starts(fu), eng.h_to_reads(fu), eng.starts_arr(fu)
        eng.h_arr(fu), eng.reads(fu), eng.reads_arr(fu)
        for other in arch.fus[:8]:
            eng.min_route_span(fu, other)
    eng.min_span_mat(), eng.route_span_mat(), eng.fu_aux(), eng.tile_index()
    return {k: v for k, v in vars(eng).items() if k != "arch"}


@pytest.mark.parametrize("name", list(ARCHES.names()))
def test_engine_tables_equal_jax(name):
    pe, je = _engine_state(PORT, name), _engine_state(JAX, name)
    assert list(pe) == list(je)
    for k in pe:
        assert same(pe[k], je[k]), k
    assert port_routing.UNREACH == jax_routing.UNREACH
    # a sentinel in each package, as the JAX package's
    assert type(port_routing.ROUTE_MISS) is type(jax_routing.ROUTE_MISS)
    for args in ((0, 0, 0), (3, 17, 5), (2 ** 20, 99, 2 ** 31)):
        assert port_routing.mix64(*args) == jax_routing.mix64(*args)


def _placed(pkg):
    """atax_u2's stored plaid2x2 placement and schedule on a fresh MRRG."""
    art = CompileResult.load(f"{CORPUS}/atax_u2__plaid.json")
    rec = art.mappings[0]
    arch = pkg["arch"]("plaid2x2")
    dfg = pkg["dfg"].DFG.from_json(rec["dfg"])
    return arch, dfg, rec


@pytest.mark.parametrize("engine", ["auto", "vector", "legacy"])
@pytest.mark.parametrize("overuse", [False, True])
def test_route_edge_on_a_fixed_placement(engine, overuse):
    """Every routable edge of atax_u2, routed one after the other on one
    MRRG per package (each path reserved before the next search), with a
    route cache: the same paths, costs, occupancy, hash and counters."""
    out = []
    for pkg in PKGS:
        arch, dfg, rec = _placed(pkg)
        mrrg = pkg["mrrg"].MRRG(arch, rec["ii"])
        cache = pkg["routing"].RouteCache()
        paths = []
        for idx, e in enumerate(dfg.edges):
            if dfg.nodes[e.src].op in ("const", "input"):
                continue
            t_src = rec["time"][e.src]
            t_dst = rec["time"][e.dst] + e.distance * rec["ii"]
            r = pkg["route"].route_edge(
                mrrg, e.src, arch.fus[rec["place"][e.src]],
                arch.fus[rec["place"][e.dst]], t_src, t_dst,
                allow_overuse=overuse, cache=cache, engine=engine)
            paths.append(r)
            if r is not None:
                mrrg.reserve(e.src, r[0])
        out.append((paths, mrrg.occ_arr.copy(), mrrg.state_hash,
                    mrrg.overuse_count(), cache.counters()))
    assert same(out[1], out[0])
    assert any(p is not None for p in out[1][0])


@pytest.mark.parametrize("mapper", ["hierarchical", "pathfinder"])
def test_router_route_edge_list_on_a_fixed_placement(mapper):
    """``Router.route_edge_list`` of a mapper's context over atax_u2's
    stored placement (all edges, then a rip-up and reroute of one node):
    the same verdict, cost, routes, route_len and MRRG state."""
    out = []
    for pkg in PKGS:
        arch, dfg, rec = _placed(pkg)
        m = pkg["mappers"].get(mapper)(arch, seed=0)
        ctx = m.ctx
        ctx.tables(dfg)
        mapping_cls = pkg["route"].Mapping
        if pkg is PORT:
            mp = mapping_cls(dfg, rec["ii"], arch=arch)
        else:
            mp = mapping_cls(arch, dfg, rec["ii"])
        mp.place, mp.time = dict(rec["place"]), dict(rec["time"])
        mrrg = pkg["mrrg"].MRRG(arch, rec["ii"], stats=ctx.stats.route)
        first = ctx.router.route_edge_list(
            mrrg, dfg, mp, range(len(dfg.edges)))
        node = sorted(mp.place)[len(mp.place) // 2]
        ctx.router.unroute_node(mrrg, dfg, mp, node)
        again = ctx.router.route_node_edges(mrrg, dfg, mp, {node})
        out.append((first, again, _routes_of(mp), mp.route_len,
                    mrrg.occ_arr.copy(), mrrg.state_hash,
                    _stats(m.engine_stats())))
    assert same(out[1], out[0])
    assert out[1][0][0]


def _routes_of(mp):
    return {"place": dict(mp.place), "time": dict(mp.time),
            "routes": {k: list(v) for k, v in mp.routes.items()}}


@pytest.mark.parametrize("kind", ["fanout", "fanin", "unicast", "single"])
def test_motif_templates_equal_jax(kind):
    assert port_extract.motif_templates(kind) == \
        jax_extract.motif_templates(kind)


@pytest.mark.parametrize("key", ["atax_u2", "gemm_u4", "jacobi_u4",
                                 "rand2_n24"])
def test_hierarchical_and_node_units_equal_jax(key):
    got = []
    for pkg in PKGS:
        dfg = build(pkg, key)
        m = pkg["mappers"].get("hierarchical")(pkg["arch"]("plaid2x2"),
                                               seed=0)
        units = [pkg["extract"].hierarchical_units(m.ctx, dfg, s)
                 for s in range(3)]
        units.append(pkg["extract"].node_units(dfg))
        got.append([[(u.kind, u.nodes) for u in us] for us in units])
    assert got[1] == got[0]


@pytest.mark.parametrize("key", ["atax_u2", "gemver_u4", "jacobi_u4",
                                 "rand3_n40"])
@pytest.mark.parametrize("max_nodes", [4, 8, 16])
def test_pack_segments_equals_jax(key, max_nodes):
    segs = [p["cluster"].pack_segments(build(p, key), max_nodes)
            for p in PKGS]
    assert segs[1] == segs[0]


def test_affinity_matrix_and_relax_positions_equal_jax():
    """One affinity matrix (jacobi_u4's units as clusters) and its
    relaxation from numpy-drawn anchors: bit for bit."""
    rng = np.random.default_rng(0)
    got = []
    for pkg in PKGS:
        dfg = build(pkg, "jacobi_u4")
        m = pkg["mappers"].get("hierarchical")(pkg["arch"]("plaid2x2"),
                                               seed=0)
        units = pkg["extract"].hierarchical_units(m.ctx, dfg, 0)
        owner = {n: i for i, u in enumerate(units) for n in u.nodes}
        W = pkg["cluster"].affinity_matrix(dfg, owner, len(units))
        got.append((W, owner))
    assert same(got[1], got[0])
    W = got[0][0]
    pos0 = rng.uniform(0.0, 3.0, size=(W.shape[0], 2))
    for anchor_w, iters in ((0.25, 32), (1.0, 5)):
        assert same(
            port_cluster.relax_positions(W, pos0, (3.0, 3.0), anchor_w, iters),
            jax_cluster.relax_positions(W, pos0, (3.0, 3.0), anchor_w, iters))
    assert W.sum() > 0


def _stats(snap):
    """MapperStats.snapshot minus the fields that read the clock."""
    out = {k: v for k, v in snap.items() if k not in CLOCK}
    out["passes"] = [{k: v for k, v in row.items() if k not in CLOCK}
                     for row in snap["passes"]]
    return out


def _map(pkg, mapper: str, key: str):
    meta = pkg["mappers"].meta(mapper)
    arch = pkg["arch"]("spatial4x4" if meta.get("result") == "spatial"
                       else "plaid2x2")
    m = pkg["mappers"].get(mapper)(arch, seed=0)
    res = m.map(build(pkg, key))
    if meta.get("result") == "spatial":
        return ([pkg["record"](s) for s in res.segments], res.n_segments,
                res.extra_mem_ops, res.analytic_segments,
                res.cycles(256)), None
    rec = None if res is None else pkg["record"](res)
    return rec, _stats(m.engine_stats())


@pytest.mark.parametrize("key", MAPPER_DFGS)
@pytest.mark.parametrize("mapper", list(MAPPERS.names()))
def test_mapper_record_and_stats_equal_jax(mapper, key, monkeypatch):
    """Every registered mapper at seed 0 and its default (full) budget:
    the same mapping record (or none) and the same pass, route and
    route-cache counters."""
    monkeypatch.delenv("REPRO_QUICK", raising=False)
    assert list(MAPPERS.names()) == list(JAX_MAPPERS.names())
    assert MAPPERS.meta(mapper) == JAX_MAPPERS.meta(mapper)
    port, jax = _map(PORT, mapper, key), _map(JAX, mapper, key)
    assert port == jax
    if key.startswith(("atax", "bicg")):
        assert port[0] is not None
