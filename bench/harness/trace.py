"""What a ``torch.profiler`` trace of a fixed number of steps says: the
device's busy seconds (the union of every device operation's interval),
each device operation's seconds and count, and the longest idle gaps by
what the host was doing in them."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

#: gaps attributed to a host operation, longest first
GAPS_LOOKED_AT = 400


@dataclasses.dataclass
class Trace:
    #: seconds in which some operation ran on the device
    busy_s: float
    #: host seconds of the traced steps (ended by a device sync)
    window_s: float
    #: device operation name -> (seconds, count)
    ops: Dict[str, Tuple[float, int]]
    #: (what the host was doing, idle seconds), most first
    idle_gaps: List[Tuple[str, float]]
    #: the number of device kernels (memcpy and memset left out)
    kernels: int


def summarize(prof, window_s: float) -> Trace:
    """Raises ``RuntimeError`` where the trace holds no device time."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CPU and not e.is_async:
            cpu.append((r.start, r.end, e.name))
    if not dev:
        raise RuntimeError("the profiler's trace holds no device operation")
    ops: Dict[str, Tuple[float, int]] = {}
    kernels = 0
    for s, t, name in dev:
        sec, n = ops.get(name, (0.0, 0))
        ops[name] = (sec + (t - s) * 1e-6, n + 1)
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    # the union of the device intervals, and the gaps between them
    dev.sort()
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:GAPS_LOOKED_AT]
    starts = np.array([c[0] for c in cpu]) if cpu else np.zeros(0)
    ends = np.array([c[1] for c in cpu]) if cpu else np.zeros(0)
    by_host: Dict[str, float] = {}
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(inside):
            k = inside[np.argmin(ends[inside] - starts[inside])]
            label = cpu[k][2]
        else:
            label = "host outside any traced op"
        by_host[label] = by_host.get(label, 0.0) + length * 1e-6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])
    return Trace(busy_s=busy, window_s=window_s, ops=ops, idle_gaps=idle,
                 kernels=kernels)


def breakdown(trace: Trace, top: int = 10) -> Dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps by host operation, ten each."""
    ops = sorted(trace.ops.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[name[:200], sec] for name, (sec, _) in ops],
            "idle_gaps": [[name[:200], sec]
                          for name, sec in trace.idle_gaps[:top]]}


def by_group(trace: Trace) -> Dict[str, float]:
    """Device seconds of the traced steps by kernel group
    (``bench.yardstick.groups``), most first."""
    from bench.yardstick import groups

    out: Dict[str, float] = {}
    for name, (sec, _) in trace.ops.items():
        g = "copies" if name.startswith(("Memcpy", "Memset")) else \
            groups.group_of(name)
        out[g] = out.get(g, 0.0) + sec
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
