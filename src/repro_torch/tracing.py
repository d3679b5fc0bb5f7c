"""Spans of the port's phases, read from the program itself.

``with span("train.forward"): ...`` marks a phase at the call site that
starts it.  Tracing is on exactly while a PyTorch profiler records
(``torch.profiler.profile``, ``torch.autograd.profiler.profile``); there is
no other switch.

* Off, :func:`span` returns one shared no-op context: no object made,
  nothing recorded, no CUDA event, no synchronise.
* On, a span opens a profiler range of its name, so it sits in the
  profiler's own trace on the device kernels' clock and names the idle gaps
  inside it.  A span named in :data:`TIMED` also records a pair of timing
  CUDA events on the current stream once CUDA is in use, and is counted.
  Nothing in a span synchronises the device or allocates on it.

The range is ``_RecordFunctionFast``'s, at the scope of an aten operation,
and not ``torch.profiler.record_function``'s: a user annotation is also
drawn on the device's timeline, as a device event around the kernels it
launched, which a trace's kernel count, busy time and kernel groups would
take for a kernel.

A timed span's device time is the time between its two events: the
kernels it launched and any time the device sat idle inside it waiting
for the host.  :func:`totals` gives each timed name's count and device
seconds; :func:`reset` forgets them.  The counts are the process's, as the
profiler is: one recorder serves every caller.

The names the program opens, each at the call site of its phase:

* ``train.step`` (``train.steps``' step functions), with ``train.forward``
  (``zoo.loss_fn``: the model's forward and the chunked loss),
  ``train.backward`` (``loss.backward()``, the remat recompute with it)
  and ``train.optimizer`` (``train.optimizer.apply_updates``);
* ``serve.generate`` (``serve.loop.generate``), with ``serve.prefill``
  (the interval ``prefill_s`` times), ``serve.grow_cache`` and
  ``serve.decode`` (the interval ``decode_s`` times);
* ``model.rope`` (``models.layers``: RoPE of q and k, inside whichever
  span is open).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

try:  # private names of torch: without them spans stay off
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None

#: whether this torch has what spans need; ``False`` keeps them off
AVAILABLE = (_RecordFunctionFast is not None
             and hasattr(_profiler, "_is_profiler_enabled"))

#: the spans whose device time a reader takes (``bench/metrics``); the
#: others are profiler ranges alone, which name the idle gaps inside them
TIMED = frozenset(("train.forward", "train.backward", "train.optimizer",
                   "model.rope"))

#: what :func:`span` returns while no profiler records
_OFF = contextlib.nullcontext()

#: timed name -> a (start, end) event pair a closed span, or ``None`` for a
#: span that ran with CUDA not in use
_SPANS: Dict[str, List[Optional[Tuple[torch.cuda.Event,
                                      torch.cuda.Event]]]] = {}


class Total(NamedTuple):
    count: int
    #: ``None`` where no span of the name took device time
    device_s: Optional[float]


class _Timed:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        pair = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pair = (self.start, end)
        _SPANS.setdefault(self.name, []).append(pair)
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that marks the phase ``name`` while a profiler records,
    and the shared no-op context otherwise."""
    if not AVAILABLE or not _profiler._is_profiler_enabled:
        return _OFF
    return _Timed(name) if name in TIMED else _RecordFunctionFast(name)


def totals() -> Dict[str, Total]:
    """Each timed name's count and device seconds over the spans closed
    since the last :func:`reset`.  The events are resolved here: call it
    after the spans' device work has been synchronised (it waits on each
    end event)."""
    out: Dict[str, Total] = {}
    for name, pairs in list(_SPANS.items()):
        pairs = list(pairs)
        device = None
        for pair in pairs:
            if pair is not None:
                start, end = pair
                end.synchronize()
                device = (device or 0.0) + 1e-3 * start.elapsed_time(end)
        out[name] = Total(len(pairs), device)
    return out


def reset() -> None:
    """Forget every timed span kept."""
    _SPANS.clear()
