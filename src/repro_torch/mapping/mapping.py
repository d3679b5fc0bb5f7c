"""A stored mapping rebuilt for verification (port of the record side of
``repro/mapping/mapping.py`` and ``repro/compiler/artifact.py``).

:class:`Mapping` carries placement, schedule and routes over one DFG at
one II — everything the simulators read.  It has no architecture and no
structural ``validate()``: those need the arch/MRRG port, so a mapping is
proven here by simulation alone.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.dfg import DFG


def normalize_record(rec: Dict[str, object]) -> Dict[str, object]:
    """Coerce a JSON-decoded mapping record back to canonical in-memory
    form (string keys -> ints, route steps as 2-lists), so that a
    load -> dump round-trip is value-identical to :func:`mapping_to_record`
    output and ``mappings_sha256`` digests bind.

    ``ii``/``makespan`` may be ``null`` (the mapper found no mapping or an
    analytic spatial segment): the record still loads — only
    :meth:`Mapping.from_record` refuses it."""
    ii = rec.get("ii")
    makespan = rec.get("makespan")
    return {
        "dfg": rec["dfg"],
        "ii": None if ii is None else int(ii),
        "makespan": None if makespan is None else int(makespan),
        "place": {int(n): int(fu) for n, fu in rec["place"].items()},
        "time": {int(n): int(t) for n, t in rec["time"].items()},
        "routes": {
            int(idx): [[int(rid), int(t)] for rid, t in path]
            for idx, path in rec["routes"].items()
        },
    }


@dataclass
class Mapping:
    dfg: DFG
    ii: int
    place: Dict[int, int] = field(default_factory=dict)  # node -> fu
    time: Dict[int, int] = field(default_factory=dict)  # node -> abs cycle
    routes: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)  # edge idx

    @property
    def makespan(self) -> int:
        return (max(self.time.values()) + 1) if self.time else 0

    @classmethod
    def from_record(cls, rec: Dict[str, object]) -> "Mapping":
        """Rebuild from an artifact's mapping record (no place & route)."""
        rec = normalize_record(rec)
        if rec["ii"] is None:
            raise ValueError(
                "mapping record has ii=null (no mapping found); nothing to "
                "rebuild"
            )
        return cls(
            dfg=DFG.from_json(rec["dfg"]),
            ii=rec["ii"],
            place=dict(rec["place"]),
            time=dict(rec["time"]),
            routes={idx: [(rid, t) for rid, t in path]
                    for idx, path in rec["routes"].items()},
        )


def mapping_to_record(mapping: Mapping) -> Dict[str, object]:
    """Serialize a :class:`Mapping` (with its DFG)."""
    return {
        "dfg": mapping.dfg.to_json(),
        "ii": mapping.ii,
        "makespan": mapping.makespan,
        "place": {int(n): int(fu) for n, fu in mapping.place.items()},
        "time": {int(n): int(t) for n, t in mapping.time.items()},
        "routes": {
            int(idx): [[int(rid), int(t)] for rid, t in path]
            for idx, path in mapping.routes.items()
        },
    }
