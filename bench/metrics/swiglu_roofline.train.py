"""swiglu_roofline.train: the SwiGLU gate and up products once a layer (4
x tokens x d_model x d_ff) of the traced training steps at the bf16 peak,
over the device time of the ``fused_swiglu`` kernels (the forward and its
recompute)."""
from bench.metrics._shared import group_seconds, peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "train" or ctx["conf"].get("num_local_experts"):
        return None
    work = flops.swiglu_flops(ctx["conf"], ctx["batch"] * ctx["seq"]) * \
        ctx["steps"]
    return peak_share(work, group_seconds(ctx["trace"], "swiglu"))
