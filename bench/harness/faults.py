"""Faults planted in the program underneath a run, to see ``correct``
come out false: what the comparison has to catch.  Each patches one
function of the program for the block; the benchmark's own runs plant
none."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(fault: str):
    """``state_unchanged``: the optimizer leaves parameters and state as
    they were; ``half_batch``: the loss is taken over the first half of
    the batch's rows; ``token_altered``: each served token is replaced by
    the next id."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.serve import loop as serve_loop
    from repro_torch.train import optimizer as opt_lib

    if fault == "state_unchanged":
        module, name = opt_lib, "apply_updates"

        def broken(params, grads, opt_state, cfg):
            z = torch.zeros(())
            return params, opt_state, {"grad_norm": z, "lr": z}
    elif fault == "half_batch":
        module, name = zoo, "loss_fn"
        orig = zoo.loss_fn

        def broken(cfg, model, batch):
            return orig(cfg, model, {k: v[:v.shape[0] // 2]
                                     for k, v in batch.items()})
    elif fault == "token_altered":
        module, name = serve_loop, "generate"
        orig = serve_loop.generate

        def broken(cfg, model, prompts, max_new_tokens=16, **kw):
            toks, info = orig(cfg, model, prompts, max_new_tokens, **kw)
            return (toks + 1) % cfg.vocab_size, info
    else:
        raise ValueError(fault)
    saved = getattr(module, name)
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, saved)
