"""attention_roofline.prefill: attention's two products (4 x head dim x
heads x causal pairs x batch a layer) of the traced prefills at the bf16
peak, over the device time of the ``flash_attention`` kernels."""
from bench.metrics._shared import group_seconds, peak_share
from bench.yardstick import flops


def read(ctx):
    if ctx["entry"] != "prefill":
        return None
    work = sum(flops.attention_flops(ctx["conf"], B, L, train=False)
               for B, L in ctx["batches"])
    return peak_share(work, group_seconds(ctx["trace"], "attention"))
