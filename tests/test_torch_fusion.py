"""``repro_torch.core.motifs`` and ``repro_torch.core.fusion`` against the
JAX package's ``repro.core.motifs`` and ``repro.core.fusion``.

* Algorithm 1 is exact: on every DFG of the TABLE2 corpus (each stored
  mapping's, spatial segments included), at seeds 0-2 and both
  feasibility modes, ``generate_motifs`` gives the JAX package's motifs
  and standalone nodes, ``motif_cover_stats`` its statistics, and the
  cover passes ``validate_cover``;
* ``analyze_fn`` over aten graphs (``make_fx``, fake tensors) keeps the
  properties ``tests/test_sharding_fusion.py`` holds for jaxprs: SwiGLU
  yields a fan-in or unicast motif, the motifs of an RMSNorm+SwiGLU block
  cover at least half of its compute nodes; for both functions the
  multiset of compute op classes equals the jaxpr DFG's;
* the aten-to-DFG rules: layout ops are wires, ``mean`` is ``add`` then
  ``mul``, ``silu`` one ``mul``-class node, numbers ``const`` nodes.
"""
import collections
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.core import fusion as jax_fusion
from repro.core import motifs as jax_motifs
from repro.core.dfg import DFG as JaxDFG
from repro_torch.core import fusion, motifs
from repro_torch.core.dfg import DFG

from _torch_artifacts import corpus_files, corpus_json


def _corpus_dfgs():
    seen, out = set(), []
    for fn in corpus_files():
        for rec in corpus_json(fn).get("mappings", []):
            key = json.dumps(rec["dfg"], sort_keys=True)
            if key not in seen:
                seen.add(key)
                out.append(rec["dfg"])
    return out


@pytest.fixture(scope="module")
def corpus_dfgs():
    return _corpus_dfgs()


def _cover(gen, dfg, seed, feasibility):
    ms, standalone = gen.generate_motifs(dfg, seed=seed,
                                         feasibility=feasibility)
    return [(m.kind, m.nodes) for m in ms], standalone, ms


@pytest.mark.parametrize("feasibility", ["none", "strict"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motifs_equal_the_jax_package_on_corpus_dfgs(corpus_dfgs, seed,
                                                     feasibility):
    assert len(corpus_dfgs) > 30
    for data in corpus_dfgs:
        ours, theirs = DFG.from_json(data), JaxDFG.from_json(data)
        got = _cover(motifs, ours, seed, feasibility)
        want = _cover(jax_motifs, theirs, seed, feasibility)
        assert got[:2] == want[:2], data["name"]
        assert motifs.motif_cover_stats(ours, got[2]) == \
            jax_motifs.motif_cover_stats(theirs, want[2])
        motifs.validate_cover(ours, got[2], got[1])


def test_dfg_views_equal_the_jax_package(corpus_dfgs):
    for data in corpus_dfgs:
        ours, theirs = DFG.from_json(data), JaxDFG.from_json(data)
        assert ours.asap() == theirs.asap()
        assert ours.compute_nodes == theirs.compute_nodes
        assert ours.n_nodes == theirs.n_nodes
        for n in ours.nodes:
            assert ours.preds(n) == theirs.preds(n)


# -- analyze_fn over aten graphs ---------------------------------------------


def swiglu(x, w1, w3):
    return F.silu(x @ w1) * (x @ w3)


def block(x, w1, w3, w2, scale):
    h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * scale
    y = F.silu(h @ w1) * (h @ w3)
    return x + y @ w2


def jax_swiglu(x, w1, w3):
    return jax.nn.silu(x @ w1) * (x @ w3)


def jax_block(x, w1, w3, w2, scale):
    h = x * jax.lax.rsqrt(jnp.mean(x * x, -1, keepdims=True) + 1e-6) * scale
    y = jax.nn.silu(h @ w1) * (h @ w3)
    return x + y @ w2


SHAPES = {"swiglu": [(4, 8), (8, 16), (8, 16)],
          "block": [(4, 16), (16, 32), (16, 32), (32, 16), (16,)]}
FNS = {"swiglu": (swiglu, jax_swiglu), "block": (block, jax_block)}


def _classes(dfg):
    return collections.Counter(dfg.nodes[n].op for n in dfg.compute_nodes)


@pytest.mark.parametrize("name", ["swiglu", "block"])
def test_compute_op_classes_equal_the_jaxpr_dfg(name):
    fn, jfn = FNS[name]
    res = fusion.analyze_fn(fn, *[torch.ones(s) for s in SHAPES[name]])
    want = jax_fusion.analyze_fn(jfn, *[jnp.ones(s) for s in SHAPES[name]])
    assert _classes(res["dfg"]) == _classes(want["dfg"])
    assert res["stats"] == want["stats"]


def test_fusion_finds_fanin_or_unicast_in_swiglu():
    res = fusion.analyze_fn(swiglu, *[torch.ones(s)
                                      for s in SHAPES["swiglu"]])
    kinds = {m.kind for m in res["motifs"]}
    assert res["stats"]["n_motifs"] >= 1
    assert "fanin" in kinds or "unicast" in kinds


def test_fusion_transformer_block_coverage():
    res = fusion.analyze_fn(block, *[torch.ones(s) for s in SHAPES["block"]])
    s = res["stats"]
    assert s["covered"] >= 0.5 * s["n_compute"]
    assert ("unicast", ("mul", "mean:sum", "mean:div")) in res["named_motifs"]


def test_fx_to_dfg_rules():
    def fn(x, y):
        z = torch.cat([x.t().reshape(4, 2), y], 0).transpose(0, 1)
        return F.silu(z.mean(-1)) * 2.0

    res = fusion.analyze_fn(fn, torch.ones(2, 4), torch.ones(3, 2))
    g = res["dfg"]
    ops = [g.nodes[n].op for n in sorted(g.nodes)]
    # inputs, then mean (add, const, mul), silu, the const 2.0 and mul
    assert ops == ["input", "input", "add", "const", "mul", "mul", "const",
                   "mul"]
    # the transposes, reshape and cat are wires from x, the first input
    assert [(e.src, e.dst) for e in g.edges] == [(0, 2), (2, 4), (3, 4),
                                                 (4, 5), (5, 7), (6, 7)]


def test_analyze_fn_traces_meta_tensors_at_full_width():
    """llama3_2_3b's widths (3072 -> 8192) on meta tensors: shapes only,
    nothing allocated."""
    args = [torch.empty(s, device="meta") for s in
            [(4, 3072), (3072, 8192), (3072, 8192), (8192, 3072), (3072,)]]
    report = fusion.fusion_report(block, *args)
    assert report.splitlines()[:2] == [
        "aten DFG: 20 nodes, 13 compute",
        "motifs: 4 (fan-in 0, fan-out 1, unicast 3), covered 12/13"]
    assert fusion.KERNEL_OF_MOTIF == jax_fusion.KERNEL_OF_MOTIF
