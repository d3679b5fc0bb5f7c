"""What the per-layer readers of the program's spans share: a span's
device milliseconds per step or batch, from ``repro_torch.tracing``'s
totals.  A span's device time is the time between the two CUDA events it
records on the stream: the kernels launched inside it, and also any time
the device sat idle inside it waiting for the host.  It is not kernel time
alone, and a span whose kernels are short (``model.rope``) reads more where
the host is slow to launch.  The program keeps spans only while a profiler
records, so in a benchmark run the totals cover the traced steps or
batches alone.  A reader returns ``None`` (the metric is left out of the
line) where the program has no spans, where their count is not what the
context says ran, or where they took no device time (on the CPU)."""
from __future__ import annotations

from typing import Optional


def span_ms(name: str, count: int, per: int) -> Optional[float]:
    """The device milliseconds of the spans ``name`` over ``per`` (steps
    or batches), where ``count`` of them ran."""
    try:
        from repro_torch import tracing
    except ImportError:  # a program without spans
        return None
    t = tracing.totals().get(name)
    if t is None or t.count != count or not t.device_s or per <= 0:
        return None
    return 1e3 * t.device_s / per

