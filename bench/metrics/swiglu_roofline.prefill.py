"""swiglu_roofline.prefill: the SwiGLU gate and up products once a layer
(4 x tokens x d_model x d_ff) of the traced prefills at the bf16 peak,
over the device time of the ``fused_swiglu`` kernels."""
from bench.metrics._shared import group_seconds, peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "prefill" or ctx["conf"].get("num_local_experts"):
        return None
    work = sum(flops.swiglu_flops(ctx["conf"], B * L)
               for B, L in ctx["batches"])
    return peak_share(work, group_seconds(ctx["trace"], "swiglu"))
