"""other_kernels_ms.train: the device milliseconds a training step of
every kernel in no named group of ``bench.yardstick.groups`` (aten
elementwise, reduction and copy kernels, the MoE dispatch, AdamW, RoPE,
the loss)."""
from bench.metrics._shared import group_seconds


def read(ctx):
    if ctx["entry"] != "train":
        return None
    sec = group_seconds(ctx["trace"], "other")
    return 1e3 * sec / ctx["steps"] if sec > 0 else None
