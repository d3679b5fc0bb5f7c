"""rope_ms.prefill: the device milliseconds a batch of the program's
``model.rope`` spans (RoPE of q and k in ``repro_torch.models.layers.
attention_qkv``, a layer once a prefill) over the traced batches, between
each span's CUDA events: RoPE's kernels and any device idle inside the
span, which the host's launch pace moves; left out where more ran than one
a layer and batch (decode steps)."""
from bench.metrics._spans import span_ms


def read(ctx):
    if ctx["entry"] != "prefill":
        return None
    n = len(ctx["batches"])
    return span_ms("model.rope", n * ctx["conf"]["num_hidden_layers"], n)
