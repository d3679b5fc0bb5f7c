"""The system under test, as the benchmark takes it from the program
(``repro_torch``): its model config for a configuration file, checked
against the file, and the CUDA set-up every entry shares."""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

#: configuration-file keys and the program's ``ModelConfig`` fields
FIELDS = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "num_hidden_layers": "n_layers", "num_local_experts": "n_experts",
          "num_experts_per_tok": "top_k", "rope_theta": "rope_theta",
          "moe_capacity_factor": "capacity_factor", "remat": "remat",
          "torch_dtype": "dtype", "optimizer_state_dtype": "opt_state_dtype"}


def model_config(conf: Dict, test: bool = False):
    """The program's config of ``conf`` (a configuration as run): its
    registered config at the regime's depth.  Raises ``RuntimeError``
    where the program's config departs from the file in anything but the
    depth (and, with ``test``, the small widths), or runs a mechanism the
    file does not state."""
    from repro_torch.configs import get_config

    base = get_config(conf["arch_id"])
    want = {FIELDS[k]: v for k, v in conf.items() if k in FIELDS}
    loose = {"n_layers"} | ({FIELDS[k] for k in conf["test_widths_keys"]
                             if k in FIELDS}
                            if test else set())
    bad = {f: (getattr(base, f), v) for f, v in want.items()
           if f not in loose and getattr(base, f) != v}
    if base.qk_norm != conf.get("qk_layernorm", False):
        bad["qk_norm"] = (base.qk_norm, conf.get("qk_layernorm"))
    if base.sliding_window or base.m_rope or base.moe_dense_ff:
        bad["mechanism"] = (base.sliding_window, base.m_rope,
                            base.moe_dense_ff)
    if bad:
        raise RuntimeError(f"{conf['arch_id']}: the program's config departs "
                           f"from the configuration file: {bad}")
    return base.replace(**{f: v for f, v in want.items() if f in loose})


_last = [time.perf_counter()]


def phase(name: str, device) -> None:
    """Print on standard error the seconds since the last phase ended
    (the first: since this module was imported), after a device sync."""
    now = sync(device)
    print(f"bench: set-up {name} {now - _last[0]:.3f} s", file=sys.stderr)
    _last[0] = now


def sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0
