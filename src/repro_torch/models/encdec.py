"""Whisper-style encoder-decoder backbone (audio frontend stubbed), the
port of ``repro/models/encdec.py``.

Encoder: bidirectional self-attention over precomputed audio-frame
embeddings (B, enc_seq, d_model); the mel-spectrogram conv frontend is a
stub, as in the JAX package.  Decoder: causal self-attention (the
``flash_attention`` kernel in the prefill) and cross-attention to the
encoder output.  RoPE replaces Whisper's learned absolute positions, as in
the JAX package.  The cache holds the decoder's self-attention k/v, which
grow, and the encoder's projected k/v per decoder layer (``xk``, ``xv``),
which the prefill computes once and decode only reads.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec


def enc_layer_spec(cfg) -> Dict[str, Spec]:
    return {
        "attn": L.attention_param_spec(cfg),
        "mlp": L.mlp_param_spec(cfg),
        "ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def dec_layer_spec(cfg) -> Dict[str, Spec]:
    return {
        "self_attn": L.attention_param_spec(cfg),
        "cross_attn": L.attention_param_spec(cfg),
        "mlp": L.mlp_param_spec(cfg),
        "ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln_x": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def param_spec(cfg) -> Dict[str, Spec]:
    return {
        **L.embed_param_spec(cfg),
        "encoder": D._stack(enc_layer_spec(cfg), cfg.n_enc_layers),
        "decoder": D._stack(dec_layer_spec(cfg), cfg.n_layers),
        "ln_enc": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln_f": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def cache_spec(cfg, batch: int, seq_len: int) -> Dict[str, Spec]:
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    Ld = cfg.n_layers
    seq_axis = "cache_seq" if batch == 1 else None
    return {
        "k": Spec((Ld, batch, seq_len, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        "v": Spec((Ld, batch, seq_len, kvd),
                  ("layers", "batch", seq_axis, "kv_heads")),
        "xk": Spec((Ld, batch, cfg.enc_seq, kvd),
                   ("layers", "batch", None, "kv_heads")),
        "xv": Spec((Ld, batch, cfg.enc_seq, kvd),
                   ("layers", "batch", None, "kv_heads")),
        "pos": Spec((batch, seq_len), ("batch", seq_axis), torch.int32),
        "length": Spec((batch,), ("batch",), torch.int32),
    }


def _arange_positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(
        B, T)


class EncDecLM(nn.Module):
    """The encdec family's model.  ``params`` is a tree shaped like
    :func:`param_spec` (``encoder`` and ``decoder`` stacked).  A
    full-sequence batch holds ``tokens`` (B, T) and ``audio_embeds`` (B,
    enc_seq, D)."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        #: the tree the parameters view (``encoder`` and ``decoder``
        #: stacked)
        self.params = params
        for key in ("emb", "ln_enc", "ln_f"):
            self.register_parameter(
                key, nn.Parameter(params[key], requires_grad=False))
        self.encoder = nn.ModuleList(
            D.ParamTree(D._layer_slice(params["encoder"], i))
            for i in range(cfg.n_enc_layers))
        self.decoder = nn.ModuleList(
            D.ParamTree(D._layer_slice(params["decoder"], i))
            for i in range(cfg.n_layers))

    def _enc_block(self, w, x, positions):
        h, _ = L.attention_layer(self.cfg, w["attn"], L.rms_norm(x, w["ln1"]),
                                 positions, causal=False)
        x = x + h
        return x + L.swiglu(w["mlp"], L.rms_norm(x, w["ln2"]))

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, enc_seq, D), after ``ln_enc``; where a
        gradient is recorded each block runs under the config's ``remat``
        policy (``repro/models/encdec.py:56-68``)."""
        B, Se, _ = audio_embeds.shape
        positions = _arange_positions(B, Se, audio_embeds.device)
        policy = L.remat_policy(self.cfg.remat)
        x = audio_embeds
        for w in self.encoder:
            x = L.remat(self._enc_block, policy, w, x, positions)
        return L.rms_norm(x, self.ln_enc)

    def _dec_block(self, w, x, positions, enc_out):
        """A decoder block: (x, ((k, v), (xk, xv))), its self-attention's
        and cross-attention's k and v."""
        cfg = self.cfg
        h, kv = L.attention_layer(cfg, w["self_attn"],
                                  L.rms_norm(x, w["ln1"]), positions,
                                  attn_impl=cfg.attn_impl)
        x = x + h
        h, xkv = L.attention_layer(cfg, w["cross_attn"],
                                   L.rms_norm(x, w["ln_x"]), positions,
                                   cross_x=enc_out)
        x = x + h
        x = x + L.swiglu(w["mlp"], L.rms_norm(x, w["ln2"]))
        return x, (kv, xkv)

    def _dec_out(self, w, x, positions, enc_out):
        return self._dec_block(w, x, positions, enc_out)[0]

    def _decode_all(self, batch, kv=None):
        """The decoder over the full sequence; with a ``kv`` dict, each
        layer's self k/v and cross k/v are appended to its lists.  Returns
        the final hidden states (B, T, D).  Without ``kv``, where a
        gradient is recorded, each block runs under the config's
        ``remat`` policy (``repro/models/encdec.py:93-99``)."""
        enc_out = self.encode(batch["audio_embeds"])
        tokens = batch["tokens"]
        B, T = tokens.shape
        x = L.embed_lookup(self.emb, tokens)
        positions = _arange_positions(B, T, tokens.device)
        policy = L.remat_policy(self.cfg.remat)
        for w in self.decoder:
            if kv is None:
                x = L.remat(self._dec_out, policy, w, x, positions, enc_out)
                continue
            x, ((k, v), (xk, xv)) = self._dec_block(w, x, positions, enc_out)
            for key, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                kv[key].append(t.reshape(B, t.shape[1], -1))
        return L.rms_norm(x, self.ln_f)

    def forward(self, batch) -> torch.Tensor:
        """Final hidden states (B, T, D)."""
        return self._decode_all(batch)

    def grad_views(self) -> Dict:
        """Turn training on (:func:`repro_torch.models.dense.grad_views`
        over the stacked ``encoder`` and ``decoder``)."""
        return D.grad_views(self, ("encoder", "decoder"))

    def prefill(self, batch) -> Tuple[Dict, torch.Tensor]:
        """Encode the audio and run the full prompt; return (cache,
        last-token logits (B, 1, V) in float32)."""
        B, T = batch["tokens"].shape
        lists = {"k": [], "v": [], "xk": [], "xv": []}
        x = self._decode_all(batch, lists)
        logits = (x[:, -1:] @ self.emb.T).float()
        cache = {key: torch.stack(val) for key, val in lists.items()}
        cache["pos"] = _arange_positions(B, T, x.device).contiguous()
        cache["length"] = torch.full((B,), T, dtype=torch.int32,
                                     device=x.device)
        return cache, logits

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """One decode step: tokens (B, 1) -> (cache, logits (B, 1, V) in
        float32).  Self-attention writes its k/v at the slot in place;
        cross-attention reads the static encoder k/v, with RoPE on q at the
        decoder position (``encdec.py:186-195`` of the JAX package).
        Returns the same dict with ``length`` advanced."""
        cfg = self.cfg
        B = tokens.shape[0]
        hd, Se = cfg.resolved_head_dim, cfg.enc_seq
        step = D.decode_slots(cfg, cache)
        xvalid = torch.ones((B, Se), dtype=torch.bool, device=tokens.device)
        x = L.embed_lookup(self.emb, tokens)
        for i, w in enumerate(self.decoder):
            x = x + D.decode_self_attention(
                cfg, w["self_attn"], L.rms_norm(x, w["ln1"]), cache["k"][i],
                cache["v"][i], step)
            hh = L.rms_norm(x, w["ln_x"])
            q = (hh @ w["cross_attn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
            q = L.apply_rope(q, step["positions"], cfg.rope_theta)
            o = L.decode_attention(
                q, cache["xk"][i].view(B, Se, cfg.n_kv_heads, hd),
                cache["xv"][i].view(B, Se, cfg.n_kv_heads, hd), xvalid)
            x = x + o.reshape(B, 1, -1) @ w["cross_attn"]["wo"]
            x = x + L.swiglu(w["mlp"], L.rms_norm(x, w["ln2"]))
        x = L.rms_norm(x, self.ln_f)
        logits = (x @ self.emb.T).float()
        cache["length"] = cache["length"] + 1
        return cache, logits


def loss_fn(cfg, model: EncDecLM, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy of the decoder
    (``repro/models/encdec.py:103-106``): (loss, {"loss": loss})."""
    nll = L.chunked_xent(model(batch), model.emb, batch["labels"],
                         cfg.logits_chunk)
    return nll, {"loss": nll}


#: the family's model class, as :mod:`repro_torch.models.zoo` builds it
Model = EncDecLM
