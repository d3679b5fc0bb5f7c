"""The model as the configuration file states it (``bench/configs``), in
plain float32 PyTorch: a pre-norm decoder of RMSNorm, grouped-query
attention with RoPE over the whole head (halves rotated), a SwiGLU MLP or
a capacity-dispatched top-k mixture of SwiGLU experts, and the tied
embedding as the output head.

``quant="fp8"`` is the control: every product takes its operands rounded
to float8 e4m3 (one scale a tensor, its largest magnitude at 448), and in
the backward the incoming gradient rounded to e5m2: the same model one
precision below the configuration's bfloat16."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fake(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fake(g, torch.float8_e5m2, 57344.0)


def q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return _Fp8.apply(x) if quant == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, quant: Optional[str]):
    return q(a, quant) @ q(b, quant)


class Arch:
    """The widths and rules of a configuration as run (a dict of
    ``bench/configs`` keys, the regime's layer count applied)."""

    def __init__(self, conf: Dict):
        self.d = conf["hidden_size"]
        self.H = conf["num_attention_heads"]
        self.Hkv = conf["num_key_value_heads"]
        self.hd = conf.get("head_dim") or self.d // self.H
        self.ff = conf["intermediate_size"]
        self.V = conf["vocab_size"]
        self.L = conf["num_hidden_layers"]
        self.E = conf.get("num_local_experts", 0)
        self.K = conf.get("num_experts_per_tok", 0)
        self.eps = conf.get("rms_norm_eps", conf.get("layer_norm_eps"))
        self.theta = float(conf["rope_theta"])
        self.capacity_factor = conf.get("moe_capacity_factor", 0.0)
        self.aux_coef = conf.get("router_aux_loss_coef", 0.0)
        assert conf.get("norm") == "rmsnorm"
        assert conf.get("partial_rotary_factor", 1.0) == 1.0
        assert not conf.get("qk_layernorm", False)
        assert not conf.get("use_parallel_residual", False)
        assert conf.get("tie_word_embeddings", True)
        for key in ("attention_multiplier",):
            if key in conf:
                assert conf[key] == 1.0 / math.sqrt(self.hd), key
        for key in ("embedding_multiplier", "residual_multiplier",
                    "logits_scaling"):
            assert conf.get(key, 1.0) == 1.0, key


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd) at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = (theta ** (-torch.arange(0, half, dtype=torch.float64,
                                   device=x.device) / half)).float()
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


#: query rows a causal block of :func:`attention` takes at a time
QUERY_BLOCK = 512


def attention(qx, k, v, quant):
    """Causal grouped-query attention, one sequence at a time with every
    head, each block of queries against the keys up to its last (the
    tiles past the diagonal block are never computed)."""
    B, T, H, hd = qx.shape
    G = H // k.shape[2]
    out = []
    for b in range(B):
        qb = q(qx[b].transpose(0, 1), quant)  # (H, T, hd)
        kb = q(k[b].transpose(0, 1).repeat_interleave(G, 0), quant)
        vb = q(v[b].transpose(0, 1).repeat_interleave(G, 0), quant)
        rows = []
        for a in range(0, T, QUERY_BLOCK):
            e = min(a + QUERY_BLOCK, T)
            s = (qb[:, a:e] @ kb[:, :e].transpose(1, 2)) / math.sqrt(hd)
            mask = torch.ones(e - a, e, dtype=torch.bool,
                              device=k.device).tril(a)
            s = s.masked_fill(~mask, NEG)
            rows.append(q(torch.softmax(s, dim=-1), quant) @ vb[:, :e])
        out.append(torch.cat(rows, dim=1).transpose(0, 1))
    return torch.stack(out)


def attention_half(a: Arch, w, x, quant):
    """(x after the attention residual, k after RoPE, v)."""
    B, T, _ = x.shape
    h = rms_norm(x, w["ln1"], a.eps)
    w = w["attn"]
    qx = rope(mm(h, w["wq"], quant).view(B, T, a.H, a.hd), a.theta)
    k = rope(mm(h, w["wk"], quant).view(B, T, a.Hkv, a.hd), a.theta)
    v = mm(h, w["wv"], quant).view(B, T, a.Hkv, a.hd)
    o = attention(qx, k, v, quant)
    return x + mm(o.reshape(B, T, -1), w["wo"], quant), k, v


def swiglu(h, w1, w3, w2, quant):
    return mm(F.silu(mm(h, w1, quant)) * mm(h, w3, quant), w2, quant)


def capacity(a: Arch, n: int) -> int:
    c = int(math.ceil(n * a.K * a.capacity_factor / a.E))
    return max(8, -(-c // 8) * 8)


def route(a: Arch, gates: torch.Tensor):
    """Top-k experts of each token (best first, ties to the lower index),
    and which routes fit their expert's capacity: a route's place is the
    number of earlier routes (token-major, then by rank) to its expert."""
    n = gates.shape[0]
    top_e = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :a.K]
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, a.E).to(torch.int64)
    place = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    return top_e, place < capacity(a, n)


def moe(a: Arch, w, h, quant, routes: Dict, layer: int):
    """The mixture over the whole batch's tokens h (n, d): (out, aux).
    The routing is kept in ``routes`` so that a recomputed block routes as
    its forward did."""
    gates = torch.softmax(h @ w["router"], dim=-1)
    if layer not in routes:
        routes[layer] = route(a, gates.detach())
    top_e, keep = routes[layer]
    top_w = gates.gather(1, top_e)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e, flat_w = top_e.reshape(-1), top_w.reshape(-1)
    tok = torch.arange(h.shape[0], device=h.device).repeat_interleave(a.K)
    out = torch.zeros_like(h)
    for e in range(a.E):
        idx = torch.nonzero((flat_e == e) & keep).squeeze(1)
        if idx.numel() == 0:
            continue
        xe = h[tok[idx]]
        ye = swiglu(xe, w["w1"][e], w["w3"][e], w["w2"][e], quant)
        out.index_add_(0, tok[idx], ye * flat_w[idx, None])
    density = F.one_hot(top_e[:, 0], a.E).float().mean(0)
    aux = a.E * torch.sum(density * gates.mean(0))
    return out, aux


def block(a: Arch, w, x, quant, routes, layer):
    """One decoder layer on x (B, T, d): (x, aux, k, v)."""
    x, k, v = attention_half(a, w, x, quant)
    h = rms_norm(x, w["ln2"], a.eps)
    if a.E:
        B, T, d = h.shape
        m, aux = moe(a, w["moe"], h.reshape(B * T, d), quant, routes, layer)
        m = m.view(B, T, d)
    else:
        m = swiglu(h, w["mlp"]["w1"], w["mlp"]["w3"], w["mlp"]["w2"], quant)
        aux = torch.zeros((), device=x.device)
    return x + m, aux, k, v


def layer_weights(layers: Dict, i: int, cast=None) -> Dict:
    """Layer ``i``'s weights from a tree whose leaves are stacked over
    layers (tensors) or per layer (lists)."""
    out = {}
    for k, v in layers.items():
        if isinstance(v, dict):
            out[k] = layer_weights(v, i, cast)
        else:
            t = v[i]
            out[k] = cast(t) if cast else t
    return out


def xent_sum(h, emb, labels, quant, chunk: int = 4096):
    """Sum over tokens of the next-token cross-entropy through the tied
    head, ``chunk`` tokens at a time (each under ``checkpoint``)."""
    def part(hh, yy, e):
        logits = mm(hh, e.T, quant)
        return F.cross_entropy(logits, yy, reduction="sum")

    total = torch.zeros((), device=h.device)
    for a in range(0, h.shape[0], chunk):
        args = (h[a:a + chunk], labels[a:a + chunk], emb)
        total = total + checkpoint(part, *args, use_reentrant=False)
    return total


def loss(a: Arch, params: Dict, tokens, labels, quant=None):
    """The training loss of one batch (B, T): mean next-token
    cross-entropy, plus the configuration's aux coefficient x the layers'
    mean load-balance loss; each layer under ``checkpoint``."""
    x = params["emb"][tokens.long()]
    routes: Dict = {}
    auxes: List[torch.Tensor] = []

    def run_block(i, x):
        x, aux, _, _ = block(a, layer_weights(params["layers"], i), x, quant,
                             routes, i)
        return x, aux

    for i in range(a.L):
        x, aux = checkpoint(run_block, i, x, use_reentrant=False)
        auxes.append(aux)
    h = rms_norm(x, params["ln_f"], a.eps)
    n = tokens.numel()
    nll = xent_sum(h.reshape(n, -1), params["emb"], labels.reshape(n).long(),
                   quant) / n
    total = nll + a.aux_coef * torch.stack(auxes).mean() if a.E else nll
    return total
