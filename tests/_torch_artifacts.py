"""Corpus artifacts for the port's tests, tampered copies of them that
``Mapping.validate()`` rejects and a simulation cannot see, and
:func:`fields`, an artifact less what reads the clock.

Each tampered copy starts from ``atax_u2__plaid.json`` of the TABLE2
corpus (``src/repro_torch/corpus/table2/``), drops its ``compiled_sim``
forms and breaks one structural invariant of its mapping:

* ``op``: node 5, a ``load``, moved from FU 3 (an ALSU) onto FU 0, an
  ALU, at a time congruent mod II 3 with node 2 on that FU;
* ``conflict``: a compute node moved onto the ALU of another compute node
  that issues in the same modulo slot;
* ``read_port``: the last step of a route moved to a resource the
  consumer's FU cannot read, at the same cycle;
* ``overuse``: one more net on a capacity-1 resource in a modulo slot
  that already holds one.
"""
from __future__ import annotations

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "src", "repro_torch", "corpus", "table2")
TAMPER_KINDS = ("op", "conflict", "read_port", "overuse")


def fields(art) -> dict:
    """An artifact's JSON minus what reads the clock: ``timings``,
    ``provenance`` and each pass's ``wall_s``."""
    out = {k: v for k, v in art.to_json().items()
           if k not in ("timings", "provenance")}
    out["pass_stats"] = [{k: v for k, v in row.items() if k != "wall_s"}
                         for row in out["pass_stats"] or []]
    return out


def corpus_json(name: str) -> dict:
    with open(os.path.join(CORPUS, name)) as f:
        return json.load(f)


def corpus_files():
    return sorted(fn for fn in os.listdir(CORPUS)
                  if fn.endswith(".json") and fn != "MANIFEST.json")


def _fabric(arch_name: str):
    from repro_torch.core.arch import make_arch

    return make_arch(arch_name)


def tampered(kind: str) -> dict:
    """The ``kind`` copy of ``atax_u2__plaid.json`` (see module
    docstring), as artifact JSON."""
    art = copy.deepcopy(corpus_json("atax_u2__plaid.json"))
    art.pop("compiled_sim")
    rec = art["mappings"][0]
    arch = _fabric(art["arch"])
    ii = rec["ii"]
    place = {int(n): fu for n, fu in rec["place"].items()}
    time = {int(n): t for n, t in rec["time"].items()}
    ops = {nid: op for nid, op, _ in rec["dfg"]["nodes"]}
    edges = rec["dfg"]["edges"]
    if kind == "op":
        rec["place"]["5"] = 0
    elif kind == "conflict":
        a, b = next((a, b) for a in place for b in place
                    if a != b and place[a] != place[b]
                    and time[a] % ii == time[b] % ii
                    and ops[a] in arch.fus[place[b]].ops
                    and ops[a] not in ("const", "input", "output"))
        rec["place"][str(a)] = place[b]
    elif kind == "read_port":
        idx, path = next((int(i), p) for i, p in rec["routes"].items()
                         if ops[edges[int(i)][0]] not in ("const", "input"))
        reads = arch.fus[place[edges[idx][1]]].reads
        bad = next(r.id for r in arch.rnodes if r.id not in reads)
        path[-1] = [bad, path[-1][1]]
    elif kind == "overuse":
        steps = [(int(i), rid, t) for i, p in rec["routes"].items()
                 for rid, t in p]
        i, rid, t = next(s for s in steps if arch.rnodes[s[1]].cap == 1)
        j = next(int(k) for k in rec["routes"]
                 if edges[int(k)][0] != edges[i][0]
                 and ops[edges[int(k)][0]] not in ("const", "input"))
        rec["routes"][str(j)].insert(0, [rid, t])
    else:
        raise ValueError(kind)
    return art


def write_json(path: str, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path
