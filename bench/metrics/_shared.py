"""Arithmetic the per-layer readers share: a group's device seconds in a
trace, and a share of the bf16 peak.  A reader that finds nothing to read
returns ``None`` and the metric is left out of the line."""
from __future__ import annotations

from typing import Optional

from bench.yardstick import groups, peaks


def group_seconds(trace, group: str) -> float:
    return sum(sec for name, (sec, _) in trace.ops.items()
               if groups.group_of(name) == group
               and not name.startswith(("Memcpy", "Memset")))


def peak_share(flops: float, seconds: float) -> Optional[float]:
    """``flops`` over ``seconds`` as a percentage of the dense bf16 peak;
    ``None`` where no time was read."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / peaks.BF16_OPS_PER_S
