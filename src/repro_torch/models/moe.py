"""Mixture-of-Experts decoder LM (Arctic-style: MoE + dense residual
branch), the port of ``repro/models/moe.py``.

Dispatch is capacity-based (first come, first served across the whole
batch) with a scatter into an (E, C, D) buffer, so the expert products are
batched matrix products over E.  :func:`route` is the dispatch alone, so
that tests can hold it against the JAX package on identical gates: the
expert of each route, its position in that expert (a masked cumsum, no
sort) and whether it was dropped must match exactly, not within a
tolerance.  The JAX package's ``constrain`` calls place the buffer on a
mesh; on one device they do nothing and are left out.

:class:`MoELM` is :class:`repro_torch.models.dense.DenseLM` with the MoE
block in place of the SwiGLU MLP; ``forward`` returns ``(h, aux)`` as the
JAX ``moe.forward`` does, and trains (:func:`loss_fn`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec


def moe_capacity(cfg, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_param_spec(cfg) -> Dict[str, Spec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": Spec((d, e), ("embed", None), torch.float32),
        "w1": Spec((e, d, f), ("expert", "embed", "mlp")),
        "w3": Spec((e, d, f), ("expert", "embed", "mlp")),
        "w2": Spec((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.moe_dense_ff:
        p["dense"] = L.mlp_param_spec(cfg, cfg.moe_dense_ff)
    return p


def layer_param_spec(cfg) -> Dict[str, Spec]:
    return {
        "attn": L.attention_param_spec(cfg),
        "moe": moe_param_spec(cfg),
        "ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def param_spec(cfg) -> Dict[str, Spec]:
    return {
        **L.embed_param_spec(cfg),
        "layers": D._stack(layer_param_spec(cfg), cfg.n_layers),
        "ln_f": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


cache_spec = D.cache_spec
cache_len = D.cache_len


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def route(gates: torch.Tensor, top_k: int, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The capacity dispatch of ``moe.py:73-85`` on float32 gates (n, E).

    Returns ``top_w`` (n, K) float32, normalised over the K; ``top_e`` (n,
    K) int64, each token's experts best first, ties to the lower index as
    ``lax.top_k`` gives them (a stable descending sort; ``torch.topk`` does
    not keep that order); ``keep`` (n * K,) bool and ``slot`` (n * K,)
    int64 over the routes flattened token-major, then by rank: a route's
    position in its expert is the number of earlier routes to the same
    expert, it is kept below ``capacity`` and its slot is ``capacity``
    where it was dropped.  Nothing here waits for the device."""
    E = gates.shape[-1]
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    # the one-hot (E, n*K), so that the cumsum runs along the contiguous
    # axis: along the outer one an H100 took 2.9 ms to scan 16000 x 32
    onehot = (torch.arange(E, device=gates.device)[:, None] == flat_e).to(
        torch.int32)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(0)
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    return top_w, top_e, keep, slot


def moe_block(cfg, w, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss)."""
    B, T, Dm = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n = B * T
    C = moe_capacity(cfg, n)
    xt = x.reshape(n, Dm)

    gates = torch.softmax(xt.float() @ w["router"], dim=-1)  # (n, E)
    top_w, top_e, keep, slot = route(gates, K, C)

    # load-balance auxiliary loss (Switch-style)
    experts = torch.arange(E, device=x.device)
    density = (top_e[:, :1] == experts).float().mean(0)
    aux = E * torch.sum(density * gates.mean(0))

    # the kept routes into the (E, C, D) buffer; the dropped ones into one
    # dump row past it.  Kept (expert, slot) pairs are unique, so the
    # scatter is a copy.
    flat_e = top_e.reshape(-1)
    row = flat_e * C + slot
    row = torch.where(keep, row, torch.full_like(row, E * C))
    buf = x.new_zeros((E * C + 1, Dm))
    buf[row] = xt.repeat_interleave(K, dim=0)
    buf = buf[:E * C].view(E, C, Dm)

    h = F.silu(torch.bmm(buf, w["w1"]))  # silu of the rounded product
    h = h * torch.bmm(buf, w["w3"])
    out_buf = torch.bmm(h, w["w2"]).view(E * C, Dm)

    y = out_buf[flat_e * C + torch.where(keep, slot, torch.zeros_like(slot))]
    y = y * (keep * top_w.reshape(-1)).to(y.dtype)[:, None]
    y = y.view(n, K, Dm).sum(1)

    if cfg.moe_dense_ff:  # Arctic: dense MLP in parallel ("bypass path")
        y = y + L.swiglu(w["dense"], xt)
    return y.view(B, T, Dm), aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class MoELM(D.DenseLM):
    """The moe family's model: :class:`DenseLM` with :func:`moe_block` as
    each block's feed-forward half.  Prefill and the in-place decode step
    are dense's."""

    def _ffn(self, w, x):
        return moe_block(self.cfg, w["moe"], x)

    def _block_aux(self, w, x, positions):
        x, _, aux = self._block(w, x, positions)
        return x, aux

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final hidden states (B, T, D), the mean of the layers' aux
        losses).  Where a gradient is recorded each block runs under the
        config's ``remat`` policy, as ``repro/models/moe.py:114-127``
        does; a recomputed block routes as it did in the forward
        (:func:`route` is a stable sort and an integer cumsum of its
        input)."""
        x, positions = self._inputs(batch)
        policy = L.remat_policy(self.cfg.remat)
        auxes = []
        for w in self.layers:
            x, aux = L.remat(self._block_aux, policy, w, x, positions)
            auxes.append(aux)
        return L.rms_norm(x, self.ln_f), torch.stack(auxes).mean()


def loss_fn(cfg, model: MoELM, batch) -> Tuple[torch.Tensor, Dict]:
    """The next-token cross-entropy plus 0.01 x the mean aux loss
    (``repro/models/moe.py:130-134``); metrics ``loss``, ``nll`` and
    ``aux``.  The gradient reaches the router through the kept routes'
    gate values and the aux loss's mean gate, not through the one-hot
    density, as with ``lax.top_k`` in the JAX package."""
    h, aux = model(batch)
    nll = L.chunked_xent(h, model.emb, batch["labels"], cfg.logits_chunk)
    loss = nll + 0.01 * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


#: the family's model class, as :mod:`repro_torch.models.zoo` builds it
Model = MoELM
