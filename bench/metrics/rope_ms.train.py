"""rope_ms.train: the device milliseconds a training step of the program's
``model.rope`` spans (RoPE of q and k in ``repro_torch.models.layers.
attention_qkv``), a layer once in the forward and once more in the remat
recompute under the backward, between each span's CUDA events (RoPE's
kernels and any device idle inside the span); RoPE's own backward is in
``backward_ms.train``, not here."""
from bench.metrics._spans import span_ms

#: the ``remat`` policies under which the backward runs a layer's forward
#: again (``repro_torch.models.layers.remat_policy``: ``"dots"`` saves
#: only the products, ``"nothing"`` saves nothing)
RECOMPUTED = ("dots", "nothing")


def read(ctx):
    if ctx["entry"] != "train":
        return None
    conf = ctx["conf"]
    passes = 2 if conf.get("remat") in RECOMPUTED else 1
    n = ctx["steps"] * conf["num_hidden_layers"] * passes
    return span_ms("model.rope", n, ctx["steps"])
