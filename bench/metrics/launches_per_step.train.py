"""launches_per_step.train: the device kernels of a traced training step
(memcpy and memset left out): what the host dispatches, through aten
under autograd and the port's ``kernels._launch``."""


def read(ctx):
    if ctx["entry"] != "train" or not ctx["trace"].kernels:
        return None
    return ctx["trace"].kernels / ctx["steps"]
