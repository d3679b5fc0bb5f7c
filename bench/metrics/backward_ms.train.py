"""backward_ms.train: the device milliseconds a training step of the
program's ``train.backward`` span (``loss.backward()``: every gradient
kernel, the remat recompute and the chunked loss's recompute), between
the span's CUDA events: its kernels and any device idle inside it."""
from bench.metrics._spans import span_ms


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return span_ms("train.backward", ctx["steps"], ctx["steps"])
