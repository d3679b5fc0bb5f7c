"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention
block, the port of ``repro/models/hybrid.py``.

The shared transformer block (attention + SwiGLU, one set of weights) is
applied again after every ``attn_every`` Mamba-2 blocks; the layers past
the last full group (the tail) have none after them.  Per-site LoRA deltas
are omitted, as in the JAX package.  Each application site keeps its own
KV cache beside the Mamba-2 layers' constant-size conv windows and
states.  ``lax.scan`` over groups and layers becomes one Python loop over
the layers, with the shared block after each layer that closes a group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import Spec


def n_groups(cfg) -> Tuple[int, int]:
    g = cfg.n_layers // cfg.attn_every
    rem = cfg.n_layers - g * cfg.attn_every
    return g, rem


def shared_block_spec(cfg) -> Dict[str, Spec]:
    return {
        "attn": L.attention_param_spec(cfg),
        "mlp": L.mlp_param_spec(cfg),
        "ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def param_spec(cfg) -> Dict[str, Spec]:
    return {
        **L.embed_param_spec(cfg),
        "mamba": D._stack(S.mamba2_param_spec(cfg), cfg.n_layers),
        "shared": shared_block_spec(cfg),
        "ln_f": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def cache_spec(cfg, batch: int, seq_len: int) -> Dict[str, Spec]:
    Di, N, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    H, P = cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads
    g, _ = n_groups(cfg)
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    seq_axis = "cache_seq" if batch == 1 else None
    return {
        "conv": Spec((cfg.n_layers, batch, K - 1, Di),
                     ("layers", "batch", None, "mlp")),
        "h": Spec((cfg.n_layers, batch, H, P, N),
                  ("layers", "batch", None, "mlp", "state"), torch.float32),
        # one KV cache per shared-attention application site
        "k": Spec((g, batch, seq_len, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        "v": Spec((g, batch, seq_len, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        "pos": Spec((batch, seq_len), ("batch", seq_axis), torch.int32),
        "length": Spec((batch,), ("batch",), torch.int32),
    }


def _shared_attn(cfg, shared, x, positions):
    """The shared block over a full sequence: (x, (k, v))."""
    h, kv = L.attention_layer(cfg, shared["attn"],
                              L.rms_norm(x, shared["ln1"]), positions,
                              attn_impl=cfg.attn_impl)
    x = x + h
    x = x + L.swiglu(shared["mlp"], L.rms_norm(x, shared["ln2"]))
    return x, kv


class HybridLM(nn.Module):
    """The hybrid family's model.  ``params`` is a tree shaped like
    :func:`param_spec` (``mamba`` stacked over the layers, ``shared``
    not).  The cache is ``{"conv", "h", "k", "v", "pos", "length"}``:
    ``grow_cache`` grows the sites' k/v and ``pos``, and ``decode_step``
    writes the conv windows, states and k/v into it in place."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        #: the tree the parameters view (``mamba`` stacked; ``shared``
        #: whole, one parameter a leaf for every site)
        self.params = params
        self.emb = nn.Parameter(params["emb"], requires_grad=False)
        self.ln_f = nn.Parameter(params["ln_f"], requires_grad=False)
        self.mamba = nn.ModuleList(
            D.ParamTree(D._layer_slice(params["mamba"], i))
            for i in range(cfg.n_layers))
        self.shared = D.ParamTree(params["shared"])

    def _closes_group(self, i: int) -> bool:
        """Whether the shared block follows Mamba-2 layer ``i``."""
        return (i + 1) % self.cfg.attn_every == 0

    def _mamba_step(self, w, x):
        return x + S.mamba2_block(self.cfg, w, L.rms_norm(x, w["ln"]))[0]

    def _run(self, tokens, cache=None):
        """The full-sequence pass; with a ``cache`` dict, each layer's conv
        window and state and each site's k/v are appended to its lists.
        Returns the final hidden states (B, T, D).  Where a gradient is
        recorded (no cache) each Mamba-2 layer runs under the config's
        ``remat`` policy and the shared block does not, as in
        ``repro/models/hybrid.py:72-88``; the shared block's parameters
        gather the gradient of every site."""
        cfg = self.cfg
        B, T = tokens.shape
        x = L.embed_lookup(self.emb, tokens)
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, T)
        policy = L.remat_policy(cfg.remat)
        for i, w in enumerate(self.mamba):
            if cache is None:
                x = L.remat(self._mamba_step, policy, w, x)
            else:
                zero = {
                    "conv": x.new_zeros((B, cfg.d_conv - 1, cfg.d_inner)),
                    "h": torch.zeros(
                        (B, cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads,
                         cfg.ssm_state), dtype=torch.float32,
                        device=x.device),
                }
                h, c = S.mamba2_block(cfg, w, L.rms_norm(x, w["ln"]), zero)
                x = x + h
                cache["conv"].append(c["conv"])
                cache["h"].append(c["h"])
            if self._closes_group(i):
                x, (k, v) = _shared_attn(cfg, self.shared, x, positions)
                if cache is not None:
                    cache["k"].append(k.reshape(B, T, -1))
                    cache["v"].append(v.reshape(B, T, -1))
        return L.rms_norm(x, self.ln_f)

    def forward(self, batch) -> torch.Tensor:
        """Final hidden states (B, T, D)."""
        return self._run(batch["tokens"])

    def grad_views(self) -> Dict:
        """Turn training on (:func:`repro_torch.models.dense.grad_views`
        over the stacked ``mamba``; ``shared`` is one gradient tree)."""
        return D.grad_views(self, ("mamba",))

    def prefill(self, batch) -> Tuple[Dict, torch.Tensor]:
        """Run the full prompt; return (cache, last-token logits (B, 1, V)
        in float32)."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        lists = {"conv": [], "h": [], "k": [], "v": []}
        x = self._run(tokens, lists)
        logits = (x[:, -1:] @ self.emb.T).float()
        cache = {key: torch.stack(val) for key, val in lists.items()}
        cache["pos"] = torch.arange(T, dtype=torch.int32,
                                    device=x.device)[None].repeat(B, 1)
        cache["length"] = torch.full((B,), T, dtype=torch.int32,
                                     device=x.device)
        return cache, logits

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """One decode step: tokens (B, 1) -> (cache, logits (B, 1, V) in
        float32).  Writes each layer's conv window and state and each
        site's k/v into ``cache`` in place (the JAX package returns a new
        cache) and returns the same dict with ``length`` advanced."""
        cfg, shared = self.cfg, self.shared
        step = D.decode_slots(cfg, cache)
        x = L.embed_lookup(self.emb, tokens)  # (B, 1, D)
        site = 0
        for i, w in enumerate(self.mamba):
            out, nc = S.mamba2_block(
                cfg, w, L.rms_norm(x, w["ln"]),
                {"conv": cache["conv"][i], "h": cache["h"][i]})
            cache["conv"][i].copy_(nc["conv"])
            cache["h"][i].copy_(nc["h"])
            x = x + out
            if self._closes_group(i):
                x = x + D.decode_self_attention(
                    cfg, shared["attn"], L.rms_norm(x, shared["ln1"]),
                    cache["k"][site], cache["v"][site], step)
                x = x + L.swiglu(shared["mlp"], L.rms_norm(x, shared["ln2"]))
                site += 1
        x = L.rms_norm(x, self.ln_f)
        logits = (x @ self.emb.T).float()
        cache["length"] = cache["length"] + 1
        return cache, logits


def loss_fn(cfg, model: HybridLM, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy (``repro/models/hybrid.py:91-94``):
    (loss, {"loss": loss})."""
    nll = L.chunked_xent(model(batch), model.emb, batch["labels"],
                         cfg.logits_chunk)
    return nll, {"loss": nll}


#: the family's model class, as :mod:`repro_torch.models.zoo` builds it
Model = HybridLM
