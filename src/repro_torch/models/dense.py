"""Dense decoder-only LM (llama-style pre-norm GQA + SwiGLU), the port of
``repro/models/dense.py``.

Covers the dense archs (stablelm-12b, qwen3-14b, llama3.2-3b,
h2o-danube-3-4b with SWA) and the VLM backbone (qwen2-vl-72b: token
*embeddings* come in pre-computed, positions are 3-axis M-RoPE ids).

:class:`DenseLM` holds the leaves of :func:`param_spec` as parameters, with
the ``layers`` axis unstacked into a ``ModuleList`` (each layer's tensors
are views of the stacked ones, so nothing is copied); ``lax.scan`` over
layers becomes a Python loop.  It serves (``prefill``, ``decode_step``)
and trains (``forward`` under the config's ``remat`` policy, and
:func:`loss_fn`).  Its parameters want no gradient until
:meth:`DenseLM.grad_views` turns training on (:func:`grad_views`, which
every family's model calls over its own stacked trees): then each layer's
parameters are leaves whose ``.grad`` is a view of one stacked gradient
tree, so the optimizer and the checkpoint see one gradient per stacked
leaf (``params/layers/mlp/w1``) and the forward never indexes a stacked
leaf (each ``select``'s backward would write a full-size zero tensor).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.layers import Spec


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _stack(spec_tree, n: int):
    return L.spec_map(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, s.dtype, s.init),
        spec_tree)


def layer_param_spec(cfg) -> Dict[str, Spec]:
    return {
        "attn": L.attention_param_spec(cfg),
        "mlp": L.mlp_param_spec(cfg),
        "ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def param_spec(cfg) -> Dict[str, Spec]:
    return {
        **L.embed_param_spec(cfg),
        "layers": _stack(layer_param_spec(cfg), cfg.n_layers),
        "ln_f": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each tensor a parameter
    (without gradient), each sub-dict a sub-module; ``tree["key"]`` reads
    either."""

    def __init__(self, tree: Dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)


def _layer_slice(tree: Dict, i: int) -> Dict:
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def grad_views(model: nn.Module, stacked: Tuple[str, ...]) -> Dict:
    """Turn training on for a model that views a params tree
    (``model.params``): every parameter wants a gradient, and its
    ``.grad`` is a view of a gradient tree shaped like the params (zeros,
    each leaf in its parameter's dtype), which is returned.  Each key of
    ``stacked`` names a tree stacked over layers and the ``ModuleList`` of
    the same name whose entry ``i`` holds layer ``i``'s slices: each
    slice's ``.grad`` is its slice of the stacked gradient.  Every other
    key names a tensor or a tree held whole by the attribute of the same
    name (a parameter, or a :class:`ParamTree` such as the hybrid's shared
    block, whose gradient autograd sums over every site that uses it).
    Autograd adds into an existing ``.grad`` in place, so a backward fills
    each stacked leaf layer by layer; zero the tree (``zero_``) between
    steps, and keep the views attached."""
    grads: Dict = {}

    def attach(p, g):
        p.requires_grad_(True)
        p.grad = g

    def walk(tree, out, modules, whole):
        for key, val in tree.items():
            subs = [getattr(m, key) for m in modules]
            if isinstance(val, dict):
                walk(val, out.setdefault(key, {}), subs, whole)
                continue
            out[key] = torch.zeros_like(val)
            for i, p in enumerate(subs):
                attach(p, out[key] if whole else out[key][i])

    for key, tree in model.params.items():
        if key in stacked:
            walk(tree, grads.setdefault(key, {}), list(getattr(model, key)),
                 False)
        else:
            walk({key: tree}, grads, [model], True)
    return grads


# ---------------------------------------------------------------------------
# Serving: cache layout
# ---------------------------------------------------------------------------


def cache_len(cfg, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len


def cache_spec(cfg, batch: int, seq_len: int) -> Dict[str, Spec]:
    S = cache_len(cfg, seq_len)
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    # long-context decode has global_batch=1: shard the cache sequence dim
    seq_axis = "cache_seq" if batch == 1 else None
    return {
        "k": Spec((cfg.n_layers, batch, S, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        "v": Spec((cfg.n_layers, batch, S, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        # absolute position held by each slot; -1 empty
        "pos": Spec((batch, S), ("batch", seq_axis), torch.int32),
        "length": Spec((batch,), ("batch",), torch.int32),
    }


class DenseLM(nn.Module):
    """The dense / vlm family's model.  ``params`` is a tree shaped like
    :func:`param_spec` (stacked ``layers``), e.g. from
    :func:`repro_torch.models.layers.init_params` or
    :func:`repro_torch.models.convert.params_from_numpy`."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        #: the stacked tree the parameters view (training updates it in
        #: place; ``Module.to`` moves the per-layer copies only, so build a
        #: new model to move a trainable one)
        self.params = params
        self.emb = nn.Parameter(params["emb"], requires_grad=False)
        self.ln_f = nn.Parameter(params["ln_f"], requires_grad=False)
        self.layers = nn.ModuleList(
            ParamTree(_layer_slice(params["layers"], i))
            for i in range(cfg.n_layers))

    # -- full-sequence passes -------------------------------------------

    def _inputs(self, batch):
        """(x, positions) of a full-sequence batch."""
        if self.cfg.family == "vlm":
            return batch["embeds"], batch["positions"]  # (B, 3, T)
        tokens = batch["tokens"]
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, T)
        return L.embed_lookup(self.emb, tokens), positions

    def _ffn(self, w, x) -> Tuple[torch.Tensor, None]:
        """The feed-forward half of a block on the normed ``x``: (out, aux),
        where only the MoE family has an ``aux``."""
        return L.swiglu(w["mlp"], x), None

    def _block(self, w, x, positions):
        h, kv = L.attention_layer(self.cfg, w["attn"], L.rms_norm(x, w["ln1"]),
                                  positions, attn_impl=self.cfg.attn_impl)
        x = x + h
        m, aux = self._ffn(w, L.rms_norm(x, w["ln2"]))
        return x + m, kv, aux

    def _block_out(self, w, x, positions) -> torch.Tensor:
        return self._block(w, x, positions)[0]

    def forward(self, batch) -> torch.Tensor:
        """Final hidden states (B, T, D).  Where a gradient is recorded each
        block runs under the config's ``remat`` policy
        (:func:`repro_torch.models.layers.remat_policy`)."""
        x, positions = self._inputs(batch)
        policy = L.remat_policy(self.cfg.remat)
        for w in self.layers:
            x = L.remat(self._block_out, policy, w, x, positions)
        return L.rms_norm(x, self.ln_f)

    def grad_views(self) -> Dict:
        """Turn training on (:func:`grad_views` over the stacked
        ``layers``)."""
        return grad_views(self, ("layers",))

    def prefill(self, batch) -> Tuple[Dict, torch.Tensor]:
        """Run the full prompt; return (cache, last-token logits (B, 1, V)
        in float32)."""
        cfg = self.cfg
        B, T = batch["tokens"].shape
        S = cache_len(cfg, T)
        ring = bool(cfg.sliding_window) and S == cfg.sliding_window
        x, positions = self._inputs(batch)
        ks, vs = [], []
        for w in self.layers:
            x, (k, v), _ = self._block(w, x, positions)
            # keep the last S positions (ring-buffer layout: slot = pos % S)
            kk = k.reshape(B, T, -1)[:, T - S:]
            vv = v.reshape(B, T, -1)[:, T - S:]
            if ring:
                # roll so that slot index == abs_position % S
                shift = (T - S) % S
                kk = torch.roll(kk, shift, dims=1)
                vv = torch.roll(vv, shift, dims=1)
            ks.append(kk)
            vs.append(vv)
        x = L.rms_norm(x, self.ln_f)
        logits = (x[:, -1:] @ self.emb.T).float()

        slot_pos = torch.arange(S, dtype=torch.int32, device=x.device)
        if ring:
            pos = (T - S) + ((slot_pos - (T % S)) % S)  # abs pos per slot
        else:
            pos = slot_pos
        cache = {
            "k": torch.stack(ks),
            "v": torch.stack(vs),
            "pos": pos[None].expand(B, S).contiguous(),
            "length": torch.full((B,), T, dtype=torch.int32,
                                 device=x.device),
        }
        return cache, logits

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """One decode step: tokens (B, 1) -> (cache, logits (B, 1, V) in
        float32).  Unlike the JAX package, which returns a new cache
        (``.at[].set`` plus buffer donation), the step writes the new k/v
        and slot position into ``cache`` in place and returns the same
        dict with ``length`` advanced: ``grow_cache`` preallocated the
        room."""
        step = decode_slots(self.cfg, cache)
        x = L.embed_lookup(self.emb, tokens)
        for i, w in enumerate(self.layers):
            x = x + decode_self_attention(
                self.cfg, w["attn"], L.rms_norm(x, w["ln1"]), cache["k"][i],
                cache["v"][i], step)
            x = x + self._ffn(w, L.rms_norm(x, w["ln2"]))[0]
        x = L.rms_norm(x, self.ln_f)
        logits = (x @ self.emb.T).float()
        cache["length"] = cache["length"] + 1
        return cache, logits


def loss_fn(cfg, model: DenseLM, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy of ``batch`` (``repro/models/
    dense.py:83``): the final hidden states against ``labels`` through the
    tied embedding, :func:`repro_torch.models.layers.chunked_xent` in
    chunks of ``cfg.logits_chunk`` tokens.  Returns (loss, {"loss":
    loss})."""
    h = model(batch)
    nll = L.chunked_xent(h, model.emb, batch["labels"], cfg.logits_chunk)
    return nll, {"loss": nll}


def decode_slots(cfg, cache: Dict) -> Dict:
    """The bookkeeping of one decode step over a KV cache, shared by every
    family that keeps one: writes each sequence's position into its slot
    (``length % S``, a ring under a sliding window) and returns the step's
    ``positions`` (B, 1) (B, 3, 1 under M-RoPE), ``slot``, ``barange``
    and ``valid`` (B, S), the live slots."""
    length = cache["length"]  # (B,)
    B, S = cache["pos"].shape
    positions = length[:, None]  # (B, 1)
    if cfg.m_rope:
        positions = positions[:, None, :].expand(B, 3, 1)
    slot = length % S
    barange = torch.arange(B, device=length.device)
    cache["pos"][barange, slot] = length
    new_pos = cache["pos"]
    if cfg.sliding_window:
        valid = (new_pos >= 0) & ((length[:, None] - new_pos)
                                  < cfg.sliding_window)
    else:
        valid = new_pos >= 0
    valid &= new_pos <= length[:, None]
    return {"positions": positions, "slot": slot, "barange": barange,
            "valid": valid}


def decode_self_attention(cfg, w, h: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, step: Dict) -> torch.Tensor:
    """One token's self-attention on the normed ``h`` (B, 1, D) against
    one layer's cache ``kc``/``vc`` (B, S, kvd): writes the token's k and
    v at ``step["slot"]`` in place, returns the projected output (B, 1,
    D)."""
    B, S = kc.shape[:2]
    hd = cfg.resolved_head_dim
    q, k, v = L.attention_qkv(cfg, w, h, step["positions"])
    kc[step["barange"], step["slot"]] = k.reshape(B, -1)
    vc[step["barange"], step["slot"]] = v.reshape(B, -1)
    o = L.decode_attention(q, kc.view(B, S, cfg.n_kv_heads, hd),
                           vc.view(B, S, cfg.n_kv_heads, hd), step["valid"])
    return o.reshape(B, 1, -1) @ w["wo"]


#: the family's model class, as :mod:`repro_torch.models.zoo` builds it
Model = DenseLM
