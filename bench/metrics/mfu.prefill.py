"""mfu.prefill: the model FLOPs of the traced prefills
(``bench.yardstick.flops.prefill_flops``) over their wall time, as a share
of the dense bf16 peak."""
from bench.metrics._shared import peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "prefill":
        return None
    total = sum(flops.prefill_flops(ctx["conf"], B, L)["total"]
                for B, L in ctx["batches"])
    return peak_share(total, ctx["trace"].window_s)
