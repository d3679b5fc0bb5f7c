"""State-space models: Mamba-1 (falcon-mamba-7b) and Mamba-2 (SSD, the
backbone of zamba2's hybrid), the port of ``repro/models/ssm.py``.

The recurrence h_t = dA_t * h_{t-1} + dB_t x_t has a per-(channel, state)
decay.  The JAX package runs it as a nested ``lax.scan`` (chunks outside,
checkpointed for the backward pass; steps inside).  Here it is one loop
over T in order: the chunks bound memory, so each chunk's ``dA`` and
``dB x`` (which do not depend on h) are computed in one operation each,
and the state update per step is the JAX one, in place.  Where a
gradient is recorded the same forward runs inside
:class:`_Mamba1Scan`, which keeps each chunk's starting state and
recomputes the chunk in its backward, as the JAX package's checkpointed
chunks do.  There is no TPU kernel for the scan
(``repro/models/ssm.py:10`` names a ``selective_scan`` that the JAX
package does not have), so the scan is plain PyTorch; the layer norms go
through the ``rmsnorm`` kernel.  Both families train (``loss_fn`` here
for falcon_mamba_7b, ``hybrid.loss_fn`` for zamba2).

Mamba-2 has one scalar decay a head, so the scan becomes the chunked SSD:
within a chunk an attention-like causal product, across chunks a carried
(B, H, P, N) state.  The JAX package computes it as einsums outside any
kernel; here it is plain PyTorch as well, written as explicit batched
products (:func:`_ssd`, whose decays subtract float64 prefix sums where
the JAX package subtracts float32 ones).  Its only user is ``hybrid.py``
(zamba2).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec


def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def _chunk_len(chunk: int, T: int) -> int:
    """Largest divisor of T not exceeding the configured chunk."""
    q = min(chunk, T)
    while T % q:
        q -= 1
    return q


def mamba1_param_spec(cfg) -> Dict[str, Spec]:
    Dm, Di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    R = dt_rank(cfg)
    return {
        "in_proj": Spec((Dm, 2 * Di), ("embed", "mlp")),
        "conv_w": Spec((Di, cfg.d_conv), ("mlp", "conv")),
        "conv_b": Spec((Di,), ("mlp",), init="zeros"),
        "x_proj": Spec((Di, R + 2 * N), ("mlp", None)),
        "dt_proj": Spec((R, Di), (None, "mlp")),
        "dt_bias": Spec((Di,), ("mlp",), torch.float32, init="ssm_dt"),
        "A_log": Spec((Di, N), ("mlp", "state"), torch.float32, init="ssm_a"),
        "Dskip": Spec((Di,), ("mlp",), torch.float32, init="ones"),
        "out_proj": Spec((Di, Dm), ("mlp", "embed")),
        "ln": Spec((Dm,), ("embed",), init="ones"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T. x: (B, T, C); w: (C, K).

    ``state``: (B, K-1, C) left context for decode or a continued prefill.
    The K taps are summed in float32 in tap order, then the bias, then one
    cast, as in the JAX package.  Returns (y, new_state)."""
    B, T, C = x.shape
    K = w.shape[1]
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    xp = torch.cat([state, x], dim=1)  # (B, T+K-1, C)
    y = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + T].float() * w[:, k].float()
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return (y + b.float()).to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) at every x (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _scan_chunk(dt, Bm, Cm, xs, A, h):
    """One chunk of the selective scan from the state ``h`` (B,Di,N) fp32:
    dt (B,Q,Di) fp32, Bm/Cm (B,Q,N) fp32, xs (B,Q,Di).  Returns (y
    (B,Q,Di) fp32, hs (B,Q,Di,N) the state after each step, dA
    (B,Q,Di,N)).  The chunk's ``dB x`` buffer takes each step's state in
    place, so a step is one launch and the chunk's outputs one batched
    product."""
    B, Q, Di = dt.shape
    dA = torch.exp(dt[..., None] * A)  # (B,Q,Di,N)
    hs = (dt * xs.float())[..., None] * Bm[:, :, None, :]  # dB x, then h_t
    for t in range(Q):
        h = hs[:, t].addcmul_(dA[:, t], h)
    N = hs.shape[-1]
    y = torch.bmm(hs.reshape(-1, Di, N), Cm.reshape(-1, N, 1)).view(B, Q, Di)
    return y, hs, dA


def _scan_chunks(dt, Bm, Cm, xs, A, h, Q: int, starts=None):
    """The scan over T, ``Q`` steps a chunk (:func:`_scan_chunk`): (y, a
    copy of h_T).  With a list ``starts``, each chunk's starting state is
    appended to it, copied."""
    ys = []
    for t0 in range(0, dt.shape[1], Q):
        if starts is not None:
            starts.append(h.clone())
        y, hs, _ = _scan_chunk(dt[:, t0:t0 + Q], Bm[:, t0:t0 + Q],
                               Cm[:, t0:t0 + Q], xs[:, t0:t0 + Q], A, h)
        h = hs[:, -1]
        ys.append(y)
    return torch.cat(ys, dim=1), h.clone()


class _Mamba1Scan(torch.autograd.Function):
    """The selective scan with a gradient, in chunks of ``Q`` steps.  The
    forward is the serving scan's, op for op (the same bits), and keeps
    only each chunk's starting state (nC, B, Di, N) besides its inputs,
    as ``jax.checkpoint`` of the JAX package's chunk body keeps only the
    carry (``repro/models/ssm.py:132-140``).  The backward recomputes a
    chunk's states from its starting state, last chunk first, then runs
    the reverse recurrence G_t = dy_t C_t + G_{t+1} dA_{t+1} one in-place
    step at a time (the gradient of h_t), from which every input's
    gradient is a batched product or a sum.  Written out rather than left
    to autograd (``torch.utils.checkpoint`` around an out-of-place chunk
    body) so that a step costs one launch each way and the forward keeps
    the serving form's in-place steps."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, xs, A, h, Q):
        starts = []
        y, hT = _scan_chunks(dt, Bm, Cm, xs, A, h, Q, starts)
        ctx.Q = Q
        ctx.save_for_backward(dt, Bm, Cm, xs, A, torch.stack(starts))
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, Bm, Cm, xs, A, starts = ctx.saved_tensors
        Q = ctx.Q
        B, _, Di = dt.shape
        N = A.shape[-1]
        carry = dhT  # autograd gives zeros for an unused output
        ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
        dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
        dAmat = torch.zeros_like(A)
        for c in reversed(range(len(starts))):
            sl = slice(c * Q, (c + 1) * Q)
            dtc, bc, cc, xc = dt[:, sl], Bm[:, sl], Cm[:, sl], xs[:, sl]
            _, hs, dA = _scan_chunk(dtc, bc, cc, xc, A, starts[c])
            q = dtc.shape[1]  # the last chunk may be shorter
            dyc = dy[:, sl].float()
            # dC_t = sum_d dy_t h_t; then G_t, the gradient of h_t
            dC[:, sl] = torch.bmm(dyc.reshape(-1, 1, Di),
                                  hs.reshape(-1, Di, N)).view(B, q, N)
            G = dyc[..., None] * cc[:, :, None, :]
            G[:, -1].add_(carry)
            for t in range(q - 2, -1, -1):
                G[:, t].addcmul_(G[:, t + 1], dA[:, t + 1])
            carry = G[:, 0] * dA[:, 0]  # the gradient of the chunk's start
            # E = G h_{t-1} dA, the gradient of dt A (dA = exp(dt A))
            E = dA.mul_(G)
            E[:, 1:].mul_(hs[:, :-1])
            E[:, 0].mul_(starts[c])
            u = dtc * xc.float()  # dB x = u B
            du = torch.bmm(G.reshape(-1, Di, N), bc.reshape(-1, N, 1)).view(
                B, q, Di)
            dB[:, sl] = torch.bmm(u.reshape(-1, 1, Di),
                                  G.reshape(-1, Di, N)).view(B, q, N)
            ddt[:, sl] = du * xc.float() + (E * A).sum(-1)
            dx[:, sl] = du * dtc
            dAmat += torch.einsum("bqdn,bqd->dn", E, dtc)
        return ddt, dB, dC, dx.to(xs.dtype), dAmat, carry, None


def _mamba1_scan(dt, Bm, Cm, xs, A, h, Q: int):
    """The selective scan over T in order, ``Q`` steps a chunk.

    dt: (B,T,Di) fp32; Bm/Cm: (B,T,N) fp32; xs: (B,T,Di); A: (Di,N) fp32;
    h: (B,Di,N) fp32.  Returns (y (B,T,Di) fp32, h_T).  Where a gradient
    is being recorded this is :class:`_Mamba1Scan` (the same forward
    values); otherwise :func:`_scan_chunks`, each step in place."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, Bm, Cm, xs, A, h)):
        return _Mamba1Scan.apply(dt, Bm, Cm, xs, A, h, Q)
    return _scan_chunks(dt, Bm, Cm, xs, A, h, Q)


def mamba1_block(cfg, w, x: torch.Tensor, cache: Optional[Dict] = None):
    """x: (B, T, D) -> (out, new_cache). cache: {'conv', 'h'} or None."""
    B, T, _ = x.shape
    Di, N = cfg.d_inner, cfg.ssm_state
    R = dt_rank(cfg)
    xz = x @ w["in_proj"]
    xs, z = xz[..., :Di], xz[..., Di:]
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, w["conv_w"], w["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = xs @ w["x_proj"]  # (B,T,R+2N)
    dt = _softplus(proj[..., :R].float() @ w["dt_proj"].float()
                   + w["dt_bias"])  # (B,T,Di)
    Bm = proj[..., R:R + N].float()
    Cm = proj[..., R + N:].float()
    A = -torch.exp(w["A_log"])  # (Di,N)

    h0 = cache["h"] if cache is not None else torch.zeros(
        (B, Di, N), dtype=torch.float32, device=x.device)
    y, hT = _mamba1_scan(dt, Bm, Cm, xs, A, h0, _chunk_len(cfg.ssm_chunk, T))
    y = y + xs.float() * w["Dskip"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ w["out_proj"]
    new_cache = {"conv": new_conv, "h": hT} if cache is not None else None
    return out, new_cache


def mamba1_decode(cfg, w, x: torch.Tensor, cache: Dict):
    """Single-token step. x: (B, 1, D)."""
    return mamba1_block(cfg, w, x, cache)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_param_spec(cfg) -> Dict[str, Spec]:
    Dm, Di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    return {
        "wz": Spec((Dm, Di), ("embed", "mlp")),
        "wx": Spec((Dm, Di), ("embed", "mlp")),
        "wB": Spec((Dm, N), ("embed", None)),
        "wC": Spec((Dm, N), ("embed", None)),
        "wdt": Spec((Dm, H), ("embed", None)),
        "conv_w": Spec((Di, cfg.d_conv), ("mlp", "conv")),
        "conv_b": Spec((Di,), ("mlp",), init="zeros"),
        "dt_bias": Spec((H,), (None,), torch.float32, init="ssm_dt"),
        "A_log": Spec((H,), (None,), torch.float32, init="ssm_a"),
        "Dskip": Spec((H,), (None,), torch.float32, init="ones"),
        "norm": Spec((Di,), ("mlp",), init="ones"),
        "out_proj": Spec((Di, Dm), ("mlp", "embed")),
        "ln": Spec((Dm,), ("embed",), init="ones"),
    }


def _ssd(la, Bm, Cm, xh, h, Q: int):
    """The chunked SSD scan, ``Q`` steps a chunk, heads first.

    la: (B,H,T) fp32 log-decay per step; Bm/Cm: (B,T,N) fp32; xh:
    (B,H,T,P) fp32; h: (B,H,P,N) fp32.  Returns (y (B,H,T,P) fp32, h_T).
    Per chunk, with seg(t, s) = la_{s+1} + ... + la_t and cum_t the
    in-chunk prefix sum: the causal term ``(C_t . B_s) exp(seg(t, s)) x_s``
    for s <= t, the carry-in ``exp(cum_t) C_t . h``, and the update
    ``h' = exp(cum_Q) h + sum_s exp(seg(Q, s)) x_s B_s``.

    The JAX package takes seg(t, s) as ``cum_t - cum_s`` in float32.  At
    zamba2's width a chunk's prefix sums reach about -9e3, where a float32
    ulp is 1e-3, so a decay that matters (seg near 0) is off by that much
    relative.  Here the prefix sums are float64 (a float64 ulp at 9e3 is
    2e-12) and seg is their difference, rounded once to float32
    (``scripts/ssd_parity_conditioning.py`` holds the forms against a
    float64 run).  The prefix sums are a product with a triangular matrix
    of ones, not ``cumsum``: CUDA's floating-point cumsum has no
    deterministic form, and training runs under
    ``torch.use_deterministic_algorithms``.  The (Q, Q) terms are kept
    transposed, [s, t]."""
    T = la.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=la.device)
    causal = ones.triu()  # [s, t]: t >= s
    upper = causal.double()  # [u, t]: 1 where u <= t
    ys = []
    for t0 in range(0, T, Q):
        cum64 = la[..., t0:t0 + Q].double() @ upper  # (B,H,Q)
        seg = (cum64[..., None, :] - cum64[..., :, None]).float()  # [s, t]
        cum = cum64.float()
        bc, cc = Bm[:, None, t0:t0 + Q], Cm[:, None, t0:t0 + Q]  # (B,1,Q,N)
        xc = xh[:, :, t0:t0 + Q]  # (B,H,Q,P)
        dec_from = seg[..., -1].exp()  # (B,H,Q) decay s -> end
        # t < s: -inf before the exp, so 0 (the JAX form's exp overflows
        # there, and a product with a 0/1 mask gives NaN)
        decay = seg.masked_fill_(~causal, float("-inf")).exp_()
        scores = (bc @ cc.transpose(-1, -2)) * decay  # [s, t]
        y = scores.transpose(-1, -2) @ xc \
            + (cc @ h.transpose(-1, -2)) * cum.exp()[..., None]
        h = cum[..., -1].exp()[..., None, None] * h \
            + (xc * dec_from[..., None]).transpose(-1, -2) @ bc
        ys.append(y)
    return torch.cat(ys, dim=2), h


def mamba2_block(cfg, w, x: torch.Tensor, cache: Optional[Dict] = None):
    """Chunked SSD. x: (B, T, D) -> (out, new_cache). cache: {'conv', 'h'}
    or None.  The gated norm keeps the JAX order: y cast to the
    activation dtype, times ``silu(z)`` in that dtype, then the
    ``rmsnorm`` kernel over rows of d_inner."""
    B, T, _ = x.shape
    Di, H = cfg.d_inner, cfg.n_ssm_heads
    P = Di // H
    z = x @ w["wz"]
    xs = x @ w["wx"]
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, w["conv_w"], w["conv_b"], conv_state)
    xs = F.silu(xs)
    Bm = (x @ w["wB"]).float()  # (B,T,N)
    Cm = (x @ w["wC"]).float()
    dt = _softplus((x @ w["wdt"]).float() + w["dt_bias"])  # (B,T,H)
    la = (dt * -torch.exp(w["A_log"])).transpose(1, 2)  # (B,H,T)
    xh = xs.view(B, T, H, P).float()
    h0 = cache["h"].float() if cache is not None else torch.zeros(
        (B, H, P, cfg.ssm_state), dtype=torch.float32, device=x.device)
    y, hT = _ssd(la, Bm, Cm, xh.transpose(1, 2), h0,
                 _chunk_len(cfg.ssm_chunk, T))
    y = y.transpose(1, 2) + xh * w["Dskip"][:, None]  # (B,T,H,P)
    y = y.reshape(B, T, Di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), w["norm"])
    out = y @ w["out_proj"]
    new_cache = {"conv": new_conv, "h": hT} if cache is not None else None
    return out, new_cache


# ---------------------------------------------------------------------------
# Falcon-Mamba LM (pure Mamba-1 stack)
# ---------------------------------------------------------------------------


def param_spec(cfg) -> Dict[str, Spec]:
    return {
        **L.embed_param_spec(cfg),
        "layers": D._stack(mamba1_param_spec(cfg), cfg.n_layers),
        "ln_f": Spec((cfg.d_model,), ("embed",), init="ones"),
    }


def cache_spec(cfg, batch: int, seq_len: int) -> Dict[str, Spec]:
    Di, N, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    return {
        "conv": Spec((cfg.n_layers, batch, K - 1, Di),
                     ("layers", "batch", None, "mlp")),
        "h": Spec((cfg.n_layers, batch, Di, N),
                  ("layers", "batch", "mlp", "state"), torch.float32),
        "length": Spec((batch,), ("batch",), torch.int32),
    }


class SSMLM(nn.Module):
    """The ssm family's model (Mamba-1 blocks, pre-norm residual).
    ``params`` is a tree shaped like :func:`param_spec` (stacked
    ``layers``).  The cache is ``{"conv", "h", "length"}``, of a constant
    size: ``grow_cache`` leaves it as it is, and ``decode_step`` writes
    each layer's new conv window and state into it in place."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        #: the stacked tree the parameters view (as ``DenseLM.params``)
        self.params = params
        self.emb = nn.Parameter(params["emb"], requires_grad=False)
        self.ln_f = nn.Parameter(params["ln_f"], requires_grad=False)
        self.layers = nn.ModuleList(
            D.ParamTree(D._layer_slice(params["layers"], i))
            for i in range(cfg.n_layers))

    def _block(self, w, x):
        return x + mamba1_block(self.cfg, w, L.rms_norm(x, w["ln"]))[0]

    def forward(self, batch) -> torch.Tensor:
        """Final hidden states (B, T, D).  Where a gradient is recorded
        each block runs under the config's ``remat`` policy
        (``repro/models/ssm.py:260-271``), and the scan inside it is
        :class:`_Mamba1Scan`."""
        x = L.embed_lookup(self.emb, batch["tokens"])
        policy = L.remat_policy(self.cfg.remat)
        for w in self.layers:
            x = L.remat(self._block, policy, w, x)
        return L.rms_norm(x, self.ln_f)

    def grad_views(self) -> Dict:
        """Turn training on (:func:`repro_torch.models.dense.grad_views`
        over the stacked ``layers``)."""
        return D.grad_views(self, ("layers",))

    def prefill(self, batch) -> Tuple[Dict, torch.Tensor]:
        """Run the full prompt; return (cache, last-token logits (B, 1, V)
        in float32)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, T = tokens.shape
        x = L.embed_lookup(self.emb, tokens)
        convs, hs = [], []
        for w in self.layers:
            zero = {
                "conv": x.new_zeros((B, cfg.d_conv - 1, cfg.d_inner)),
                "h": torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=x.device),
            }
            h, c = mamba1_block(cfg, w, L.rms_norm(x, w["ln"]), zero)
            x = x + h
            convs.append(c["conv"])
            hs.append(c["h"])
        x = L.rms_norm(x, self.ln_f)
        logits = (x[:, -1:] @ self.emb.T).float()
        cache = {"conv": torch.stack(convs), "h": torch.stack(hs),
                 "length": torch.full((B,), T, dtype=torch.int32,
                                      device=x.device)}
        return cache, logits

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """One decode step: tokens (B, 1) -> (cache, logits (B, 1, V) in
        float32).  Writes each layer's conv window and state into
        ``cache`` in place (the JAX package returns a new cache) and
        returns the same dict with ``length`` advanced."""
        x = L.embed_lookup(self.emb, tokens)  # (B, 1, D)
        for i, w in enumerate(self.layers):
            out, nc = mamba1_decode(
                self.cfg, w, L.rms_norm(x, w["ln"]),
                {"conv": cache["conv"][i], "h": cache["h"][i]})
            cache["conv"][i].copy_(nc["conv"])
            cache["h"][i].copy_(nc["h"])
            x = x + out
        x = L.rms_norm(x, self.ln_f)
        logits = (x @ self.emb.T).float()
        cache["length"] = cache["length"] + 1
        return cache, logits


def loss_fn(cfg, model: SSMLM, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy (``repro/models/ssm.py:274-277``):
    (loss, {"loss": loss})."""
    nll = L.chunked_xent(model(batch), model.emb, batch["labels"],
                         cfg.logits_chunk)
    return nll, {"loss": nll}


#: the family's model class, as :mod:`repro_torch.models.zoo` builds it
Model = SSMLM
