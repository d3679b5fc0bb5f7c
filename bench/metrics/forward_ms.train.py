"""forward_ms.train: the device milliseconds a training step of the
program's ``train.forward`` span (``repro_torch.train.steps.value_and_grad``
around ``zoo.loss_fn``: the model's forward and the chunked loss), between the
span's CUDA events: its kernels and any device idle inside it."""
from bench.metrics._spans import span_ms


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return span_ms("train.forward", ctx["steps"], ctx["steps"])
