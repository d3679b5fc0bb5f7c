"""optimizer_ms.train: the device milliseconds a training step of the
program's ``train.optimizer`` span (``repro_torch.train.optimizer.
apply_updates``: the global norm and AdamW, slice by slice), between the
span's CUDA events: its kernels and any device idle inside it."""
from bench.metrics._spans import span_ms


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return span_ms("train.optimizer", ctx["steps"], ctx["steps"])
