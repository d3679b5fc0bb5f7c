"""attention_roofline.train: attention's two products, forward and
backward (12 x head dim x heads x causal pairs x batch a layer), of the
traced training steps at the bf16 peak, over the device time of the
``flash_attention`` kernels (forward, its recompute, backward)."""
from bench.metrics._shared import group_seconds, peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "train":
        return None
    work = flops.attention_flops(ctx["conf"], ctx["batch"], ctx["seq"],
                                 train=True) * ctx["steps"]
    return peak_share(work, group_seconds(ctx["trace"], "attention"))
