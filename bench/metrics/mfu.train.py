"""mfu.train: the model FLOPs of the traced training steps
(``bench.yardstick.flops.train_step_flops``) over their wall time, as a
share of the dense bf16 peak."""
from bench.metrics._shared import peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "train":
        return None
    f = flops.train_step_flops(ctx["conf"], ctx["batch"], ctx["seq"])
    return peak_share(f["total"] * ctx["steps"], ctx["trace"].window_s)
