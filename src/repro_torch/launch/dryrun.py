"""Dry run of a distribution plan: every (architecture x input shape x
mesh) cell's per-device step, traced on fake tensors against the H100
production mesh, with its memory, FLOPs, bytes and collectives; the port of
``repro/launch/dryrun.py``.

Single cell (in-process):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_3b \\
        --shape train_4k [--multi-pod] [--json out.json] [--device cuda]

Sweep (one subprocess a cell; ``--out`` has no default):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --out DIR

The JAX package lowers and compiles each cell with XLA on 512 fake host
devices and reads XLA's analyses.  PyTorch has no such compile, so a cell
here is the step one device runs, traced under ``FakeTensorMode`` (shapes,
no data, nothing allocated):

* **The plan.**  :mod:`repro_torch.parallel.sharding`'s rules on the
  production mesh (:mod:`repro_torch.launch.mesh`, a fake process group)
  give every parameter, optimizer-state, batch and cache leaf its
  placements; a device holds the local shard.  The step is traced on the
  *local view*: the batch over ``data`` (and ``pod``), and heads,
  kv_heads, mlp, vocab and expert over ``model`` where the rules shard
  them, i.e. the model of a config whose widths are the local ones
  (:func:`local_config`).  FSDP-sharded dims (``embed`` over ``data``) are
  gathered for compute, so the traced parameters hold them whole.  A
  heads dim that the rules shard to a width of no whole number of heads
  (whisper_tiny's 6 x 64 columns over ``model=8``: 48 a device) is
  gathered for compute the same way: the placements, and so the
  arguments, stay the rules' shards, and attention runs on whole heads on
  every rank of the model group (they hold the same tokens), from the
  weights (and in a decode step the cache) gathered over ``model`` a
  layer at a time.  Expert parallelism keeps the router and the dispatch
  of the whole config and computes the device's experts only
  (:class:`ExpertParallelLM`).  Where the local view cannot express a
  plan (heads sharded while kv_heads are replicated, which would change
  ``kv_group``), the cell is ``status: "error"`` with the reason.
* **The depth.**  A cell is traced at full depth, except where
  :func:`depth_points` finds that too slow (the eager Mamba-1 scan is
  traced a position at a time: falcon_mamba_7b's ``prefill_32k``); it is
  then traced at two depths and every field combined linearly to the
  full one (:func:`combine_records`), and ``traced_depths`` names the
  depths.
* **The program.**  ``--device cuda`` (the default; no card is needed,
  nothing runs) models the card's program: the kernels' fake rule
  (:mod:`repro_torch.kernels.fake`) stands in for each launch and counts
  it.  ``--device cpu`` models the plain versions.  The trace runs on fake
  ``cuda`` tensors where PyTorch is built with CUDA, else on fake CPU
  tensors that stand for them (autograd aborts on a fake ``cuda`` tensor
  without CUDA).
* **The step.**  ``train``: ``train.steps.make_train_step``'s two parts,
  the loss's forward and backward under the config's remat policy
  (``steps.value_and_grad``) on the local view, then AdamW
  (``optimizer.apply_updates``) on the shards; ``prefill`` and
  ``decode``: ``serve.loop.make_prefill_step`` / ``make_serve_step`` under
  ``inference_mode``.

Fields of a record (the JAX package's where they mean the same):

* ``argument_size_in_bytes``: the local shards of params, optimizer state
  and batch (decode: params, cache and tokens), exactly.
* ``output_size_in_bytes``: the local shards of what the step returns
  (train: params, optimizer state and metrics; prefill and decode: the
  cache as its shard).
* ``temp_size_in_bytes``: the peak of live storage the step allocates,
  less what the plan shards that the trace holds whole: in the forward
  and backward the gradient tree counts as its shard, and FSDP's gathers
  are added as the plan makes them (each stacked layer's FSDP leaves
  gathered just before the layer and freed after it: two layers' worth,
  the one computing and the one prefetched, plus in training one layer's
  unreduced gradient; the unstacked FSDP leaves gathered for the whole
  step; whole heads' gathered weights alike, and in a decode step the
  layer's gathered cache); AdamW's peak is its own, on the shards.  With
  no FSDP at world size 1 it is the trace's peak exactly.
  ``peak_bytes`` is arguments plus temp.
* ``flops_per_device``: ``FlopCounterMode``'s count of the traced aten ops
  plus the kernels' own operations (:mod:`repro_torch.kernels.cost`).
* ``bytes_per_device``: every traced op's tensor inputs read once and
  outputs written once (views, allocations and metadata queries move
  nothing), plus the kernels' own bytes; no fusion is assumed, and no
  cache: an op whose operands stay in L2 counts in full.
* ``kernels``: each kernel's fake calls, ``kernel_routes`` their routes.
* ``collectives``: per kind, the op count and the bytes of each op's
  output a device (the JAX package's ``parse_collectives`` convention),
  and ``by_axis``, the bytes by the mesh axes the op spans (``"model"``
  rides NVLink, anything with ``data`` or ``pod`` InfiniBand).  There is no
  HLO to read, so they come from the plan (:func:`plan_collectives`):

  - FSDP: each leaf sharded over ``data`` is all-gathered once a use
    (training: in the forward and again in the backward) and its gradient
    reduce-scattered; a leaf stacked over layers counts once a layer;
  - whole heads: each leaf gathered over ``model`` for compute is
    all-gathered once a use (training: twice), and a decode step's cache
    once a layer; its gradient is whole and the same on every rank of the
    model group (they hold the same tokens), so each keeps its own shard
    and nothing is reduce-scattered;
  - gradients: an all-reduce of each leaf's local gradient over the batch
    axes that do not shard it (``pod`` for an FSDP leaf);
  - tensor parallelism: a product whose contracted dim is sharded over
    ``model`` leaves partial sums, all-reduced once a use in the forward
    (again when ``remat`` recomputes it); a product whose output dim is
    sharded has its input gradient all-reduced in the backward, once for
    the products that share an input (q, k, v; w1, w3); a norm over a
    sharded width (Mamba-2's gated norm) all-reduces its row statistics;
    a vocab-sharded embedding all-reduces its lookup and the head its
    softmax statistics (max and sum, float32) and, in training, its input
    gradient;
  - expert parallelism: the MoE dispatch and combine, one all-to-all each
    a use (their transposes in the backward), of the device's experts'
    buffer (local experts x capacity x d_model);
  - decode over a cache sharded along its sequence (``long_500k``): each
    attention layer combines its partial softmax with an all-reduce of
    (local batch x local heads x (head dim + 2)) float32 values.

  A collective over an axis of extent 1 moves nothing and is not counted.
* ``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` have no
  counterpart (nothing is compiled, and buffer donation is PyTorch's
  in-place update) and are left out: ``not_reported`` names them.
* ``trace_s``, ``total_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (ARCH_IDS, SHAPES, RunConfig, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels import fake
from repro_torch.launch.mesh import production_mesh, validate_mesh
from repro_torch.models import hybrid, moe, zoo
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as shard_lib
from repro_torch.serve import loop as serve_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib
from repro_torch.train.tree import tree_map

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: reference fields with no counterpart here
NOT_REPORTED = ("alias_size_in_bytes", "generated_code_size_in_bytes")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the leaves that are products ``x @ w`` with ``w`` (in, out) (after any
#: leading layers / expert dims)
PRODUCTS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "in_proj", "x_proj",
            "dt_proj", "out_proj", "wz", "wx", "wB", "wC", "wdt", "router")


class PlanError(ValueError):
    """The local view cannot express the plan."""


# ---------------------------------------------------------------------------
# The local view
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """A config at one device's widths: ``inner`` is its share of the SSM
    width (``d_inner``, otherwise ``expand * d_model``)."""

    inner: int = 0

    @property
    def d_inner(self) -> int:
        return self.inner or self.expand * self.d_model


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += _leaves(tree[key], prefix + (key,))
    return out


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _model_only(pspec):
    """``pspec`` with every axis but ``model`` dropped: the compute view of
    a parameter, whose FSDP dims are gathered."""
    def keep(part):
        axes = shard_lib._axes(part)
        return "model" if "model" in axes else None
    return tuple(keep(p) for p in pspec)


def _whole_heads(s, pspec, sizes, head_dim: int):
    """``pspec`` with a heads dim of ``s`` whose ``model`` shard is not a
    whole number of ``head_dim``-wide heads left whole: gathered for
    compute."""
    m = sizes.get("model", 1)
    return tuple(
        None if name in ("heads", "kv_heads") and "model" in
        shard_lib._axes(part) and (dim // m) % head_dim else part
        for dim, name, part in zip(s.shape, s.axes, pspec))


def _model_gathered(s, pspec, compute_shape) -> bool:
    """Whether the plan shards ``s`` over ``model`` where its compute view
    holds it whole (:func:`_whole_heads`)."""
    return any("model" in shard_lib._axes(part) and c == d
               for part, c, d in zip(pspec, compute_shape, s.shape))


def _find(view, *suffix):
    """The shape of the first leaf whose path ends with ``suffix``."""
    for path, shape in view.items():
        if path[-len(suffix):] == suffix:
            return path, shape
    return None, None


def local_config(cfg: ModelConfig, view: Dict[Tuple[str, ...], tuple],
                 extent: int) -> Tuple[LocalConfig, Optional[int]]:
    """The config of one device's view (``view``: each parameter leaf's
    compute shape, FSDP dims gathered) and its experts where expert
    parallelism shards them (else ``None``).  Raises :class:`PlanError`
    where no config has these widths (``extent``: the ``model`` axis's)."""
    hd = cfg.resolved_head_dim
    kw = dict(head_dim=hd, vocab_size=view[("emb",)][0])
    _, wq = _find(view, "wq")
    if wq is not None:  # whole heads (_whole_heads)
        _, wk = _find(view, "wk")
        kw.update(n_heads=wq[-1] // hd, n_kv_heads=wk[-1] // hd)
        group = cfg.n_heads // cfg.n_kv_heads
        if kw["n_heads"] != group * kw["n_kv_heads"]:
            raise PlanError(
                f"heads and kv_heads shard differently over model={extent} "
                f"({cfg.n_heads} -> {kw['n_heads']}, {cfg.n_kv_heads} -> "
                f"{kw['n_kv_heads']}): kv_group would change from {group}")
    experts = None
    if cfg.family == "moe":
        _, w1 = _find(view, "moe", "w1")
        kw["d_ff"] = w1[-1]
        if w1[-3] != cfg.n_experts:
            experts = w1[-3]
        _, dense = _find(view, "moe", "dense", "w1")
        if dense is not None:
            kw["moe_dense_ff"] = dense[-1]
    else:
        _, w1 = _find(view, "mlp", "w1")
        if w1 is not None:
            kw["d_ff"] = w1[-1]
    _, in_proj = _find(view, "in_proj")
    _, wz = _find(view, "wz")
    if in_proj is not None:
        kw["inner"] = in_proj[-1] // 2
    if wz is not None:
        kw.update(inner=wz[-1], ssm_heads=cfg.n_ssm_heads)
        if wz[-1] % cfg.n_ssm_heads:
            raise PlanError(
                f"d_inner {cfg.d_inner} shards to {wz[-1]} over "
                f"model={extent}, not a whole width for each of "
                f"{cfg.n_ssm_heads} SSM heads")
    local = LocalConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    local = local.replace(**kw)
    want = dict(_leaves(zoo.param_spec(local)))
    for path, shape in view.items():
        exp = tuple(want[path].shape)
        if experts is not None and path[-2:-1] == ("moe",) and \
                path[-1] in ("w1", "w2", "w3"):
            exp = exp[:-3] + (experts,) + exp[-2:]
        if exp != tuple(shape):
            raise PlanError(
                f"{'/'.join(path)}: the plan's local shard {tuple(shape)} "
                f"is not the local model's {exp}")
    return local, experts


def _ep_moe_block(cfg, w, x: torch.Tensor):
    """:func:`repro_torch.models.moe.moe_block` under expert parallelism:
    the router and the dispatch of all ``cfg.n_experts`` experts (the
    model group holds the same tokens), then the products of the device's
    experts only (the first ``w["w1"].shape[0]``, standing for its share);
    the combine reads their outputs and the rest of the buffer as the
    all-to-all delivers it."""
    B, T, Dm = x.shape
    E, K = cfg.n_experts, cfg.top_k
    El = w["w1"].shape[0]
    n = B * T
    C = moe.moe_capacity(cfg, n)
    xt = x.reshape(n, Dm)
    gates = torch.softmax(xt.float() @ w["router"], dim=-1)
    top_w, top_e, keep, slot = moe.route(gates, K, C)
    experts = torch.arange(E, device=x.device)
    density = (top_e[:, :1] == experts).float().mean(0)
    aux = E * torch.sum(density * gates.mean(0))
    flat_e = top_e.reshape(-1)
    row = flat_e * C + slot
    row = torch.where(keep, row, torch.full_like(row, E * C))
    buf = x.new_zeros((E * C + 1, Dm))
    buf[row] = xt.repeat_interleave(K, dim=0)
    mine = buf[:El * C].view(El, C, Dm)
    h = F.silu(torch.bmm(mine, w["w1"])) * torch.bmm(mine, w["w3"])
    out = torch.bmm(h, w["w2"]).view(El * C, Dm)
    out_buf = torch.cat([out, out.new_empty(((E - El) * C, Dm))])
    y = out_buf[flat_e * C + torch.where(keep, slot, torch.zeros_like(slot))]
    y = y * (keep * top_w.reshape(-1)).to(y.dtype)[:, None]
    y = y.view(n, K, Dm).sum(1)
    if cfg.moe_dense_ff:
        y = y + L.swiglu(w["dense"], xt)
    return y.view(B, T, Dm), aux


class ExpertParallelLM(moe.MoELM):
    """The MoE model of one device under expert parallelism."""

    def _ffn(self, w, x):
        return _ep_moe_block(self.cfg, w["moe"], x)


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One cell's plan: the configs, the mesh and every leaf's specs."""

    cfg: ModelConfig
    shape: ShapeSpec
    multi_pod: bool
    sizes: Dict[str, int]
    local: LocalConfig
    experts: Optional[int]
    #: group name -> {path: (global Spec, pspec, local shape, traced shape)}
    groups: Dict[str, Dict[Tuple[str, ...], tuple]]
    #: the bytes a prefill's or decode step's cache holds past its shard
    #: where its heads are gathered for compute
    cache_gathered: int = 0


def _placed(spec_tree, rules, sizes, head_dim: int = 0, params=False):
    """{path: (Spec, pspec, local shape, traced shape)}: the traced shape
    is the local one, with ``head_dim`` its heads dims whole
    (:func:`_whole_heads`), and for ``params`` its FSDP dims gathered."""
    out = {}
    for path, s in _leaves(spec_tree):
        ps = shard_lib._pspec_for(s.axes, rules, s.shape, sizes)
        compute = _whole_heads(s, ps, sizes, head_dim) if head_dim else ps
        traced = shard_lib.local_shape(
            s.shape, _model_only(compute) if params else compute, sizes)
        out[path] = (s, ps, shard_lib.local_shape(s.shape, ps, sizes),
                     traced)
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool, *, mesh,
               cfg_overrides=None, shape: Optional[ShapeSpec] = None):
    """``(cell, meta)``: the plan of one cell on ``mesh``, or ``(None,
    {"skipped": why})``.  ``shape`` replaces ``SHAPES[shape_name]``."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    sizes = shard_lib.mesh_sizes(mesh)
    multi_pod = multi_pod and "pod" in sizes
    rules = shard_lib.logical_rules(cfg, multi_pod=multi_pod)
    pspec = zoo.param_spec(cfg)
    hd = cfg.resolved_head_dim
    groups = {"params": _placed(pspec, rules, sizes, hd, params=True),
              "batch": _placed(zoo.input_spec(cfg, shape), rules, sizes)}
    view = {p: v[3] for p, v in groups["params"].items()}
    local, experts = local_config(cfg, view, sizes.get("model", 1))
    if shape.kind == "train":
        ocfg = opt_lib.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        groups["opt"] = _placed(opt_lib.opt_state_spec(pspec, ocfg), rules,
                                sizes)
    cache_gathered = 0
    if shape.kind != "train":  # the cache the step returns (decode: takes)
        cache = _placed(zoo.cache_spec(cfg, shape.global_batch,
                                       shape.seq_len), rules, sizes, hd)
        cache_gathered = _group_bytes(cache, 3) - _group_bytes(cache, 2)
        if shape.kind == "decode":
            groups["cache"] = cache
    meta = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "mesh": validate_mesh(mesh),
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    return Cell(cfg, shape, multi_pod, sizes, local, experts, groups,
                cache_gathered), meta


# ---------------------------------------------------------------------------
# Collectives from the plan
# ---------------------------------------------------------------------------


class _Collectives:
    def __init__(self, sizes):
        self.sizes = sizes
        self.out = {k: {"count": 0, "bytes": 0.0, "by_axis": {}}
                    for k in COLLECTIVES}

    def add(self, kind, axes, count, nbytes):
        axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
        if not axes or not count:
            return
        rec = self.out[kind]
        rec["count"] += count
        rec["bytes"] += count * nbytes
        key = "+".join(axes)
        rec["by_axis"][key] = rec["by_axis"].get(key, 0.0) + count * nbytes


def _uses(cell: Cell, path) -> int:
    """How often one pass uses a leaf (a slice of it where it is stacked)."""
    s = cell.groups["params"][path][0]
    if s.axes[:1] == ("layers",):
        return s.shape[0]
    if path[0] == "shared":
        return hybrid.n_groups(cell.cfg)[0]
    return 1


def plan_collectives(cell: Cell) -> Dict:
    """The collectives of one step under the plan (the module note)."""
    cfg, shape, sizes = cell.cfg, cell.shape, cell.sizes
    kind = shape.kind
    train = kind == "train"
    c = _Collectives(sizes)
    act = _DTYPES[cfg.dtype]
    a_e = torch.empty((), dtype=act).element_size()
    batch_axes = ("pod", "data") if cell.multi_pod else ("data",)
    b_path = ("labels",) if train else ("tokens",)
    Bl = cell.groups["batch"][b_path][2][0]
    T = 1 if kind == "decode" else shape.seq_len
    tokens = Bl * T
    fwd = 2 if train and cfg.remat in ("dots", "nothing") else 1
    local = cell.local
    # parameters: FSDP gathers, reduce-scatters, gradient all-reduces
    for path, (s, ps, lshape, cshape) in cell.groups["params"].items():
        n = s.shape[0] if s.axes[:1] == ("layers",) else 1
        used = {a for part in ps for a in shard_lib._axes(part)}
        full = _nbytes(cshape, s.dtype) / n
        shard = _nbytes(lshape, s.dtype) / n
        fsdp = "data" in used
        if fsdp:
            c.add("all-gather", ("data",), n * (2 if train else 1), full)
            if train:
                c.add("reduce-scatter", ("data",), n, shard)
        if train:
            rest = tuple(a for a in batch_axes if a not in used)
            c.add("all-reduce", rest, n, shard)
    m = sizes.get("model", 1)
    if m > 1:
        groups = {}
        for path, (s, ps, lshape, cshape) in cell.groups["params"].items():
            name, parent = path[-1], path[-2] if len(path) > 1 else ""
            n_use = _uses(cell, path)
            rows = tokens
            if path[0] == "encoder" or (parent == "cross_attn"
                                        and name in ("wk", "wv")):
                if kind == "decode":
                    continue  # the encoder and cross k/v run in the prefill
                rows = Bl * cfg.enc_seq
            if _model_gathered(s, ps, cshape):  # whole heads, gathered
                n_stack = s.shape[0] if s.axes[:1] == ("layers",) else 1
                c.add("all-gather", ("model",), n_use * (1 + train),
                      _nbytes(cshape, s.dtype) / n_stack)
                continue
            if cell.experts is not None and parent == "moe" and \
                    name in ("w1", "w2", "w3"):
                continue  # expert parallel: the all-to-alls below
            if parent == "moe" and name in ("w1", "w2", "w3"):
                rows = cfg.n_experts * moe.moe_capacity(cfg, tokens)
            if name == "norm" and "model" in shard_lib._axes(ps[-1]):
                c.add("all-reduce", ("model",), n_use * (fwd + train),
                      rows * 4)
                continue
            if name not in PRODUCTS or len(cshape) < 2:
                continue
            in_m = "model" in shard_lib._axes(ps[-2])
            out_m = "model" in shard_lib._axes(ps[-1])
            if in_m:
                c.add("all-reduce", ("model",), n_use * fwd,
                      rows * cshape[-1] * a_e)
            elif out_m and train:
                groups[(path[:-1], rows)] = (n_use, rows * cshape[-2] * a_e)
        for n_use, nbytes in groups.values():
            c.add("all-reduce", ("model",), n_use, nbytes)
        emb = cell.groups["params"][("emb",)]
        if "model" in shard_lib._axes(emb[1][0]):
            looked = tokens if (cfg.family != "vlm" or kind == "decode") \
                else 0
            c.add("all-reduce", ("model",), 1 if looked else 0,
                  looked * cfg.d_model * a_e)
            head_rows = tokens if train else Bl  # prefill: the last token
            c.add("all-reduce", ("model",), 2, head_rows * 4)
            if train:
                c.add("all-reduce", ("model",), 1,
                      tokens * cfg.d_model * a_e)
        if cell.experts is not None:
            cap = moe.moe_capacity(cfg, tokens)
            nbytes = cell.experts * cap * cfg.d_model * a_e
            c.add("all-to-all", ("model",),
                  cfg.n_layers * 2 * (fwd + train), nbytes)
    cache = cell.groups.get("cache", {})
    for s, ps, _, cshape in cache.values():
        if _model_gathered(s, ps, cshape):  # a layer's, each decode step
            c.add("all-gather", ("model",), s.shape[0],
                  _nbytes(cshape, s.dtype) / s.shape[0])
    kc = cache.get(("k",))
    seq = [shard_lib._axes(p) for p, a in zip(kc[1], kc[0].axes)
           if a == "cache_seq"] if kc is not None else []
    if seq and seq[0]:
        layers = hybrid.n_groups(cfg)[0] if cfg.family == "hybrid" \
            else cfg.n_layers
        c.add("all-reduce", seq[0], layers,
              Bl * local.n_heads * (local.resolved_head_dim + 2) * 4)
    return c.out


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh")


class _Tracer(TorchDispatchMode):
    """Live storage bytes (their peak) of the storages the traced ops
    allocate, and the bytes each op reads and writes."""

    def __init__(self, known):
        super().__init__()
        #: the arguments' storages (held, so that their ids stay theirs)
        self.known = {id(st): st for st in known}
        self.seen = set()
        self.live = self.peak = 0
        self.bytes = 0.0

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known or key in self.seen:
            return
        self.seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        name = func.overloadpacket.__name__
        # an op that returns no tensor (``prim.device``, sizes, strides)
        # reads metadata, not memory
        if outs and not func.is_view and name not in _FREE:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out


def _trace_device(device: str) -> str:
    return "cuda" if device == "cuda" and torch.backends.cuda.is_built() \
        else "cpu"


def _fakes(group, dev: str, traced: bool = True):
    """A tree of fake tensors, one a leaf of ``group`` (its traced or its
    local shape)."""
    tree = {}
    for path, (s, _, lshape, tshape) in group.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(tshape if traced else lshape,
                                     dtype=s.dtype, device=dev)
    return tree


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in _leaves(tree) if isinstance(t, torch.Tensor))


def _group_bytes(group, which: int = 2) -> int:
    return sum(_nbytes(v[which], v[0].dtype) for v in group.values())


def _gather_bytes(cell: Cell) -> int:
    """The gather buffers at the step's peak, FSDP's and whole heads' (the
    module note)."""
    per_layer: Dict[str, float] = {}
    whole = 0
    for path, (s, _, lshape, cshape) in cell.groups["params"].items():
        extra = _nbytes(cshape, s.dtype) - _nbytes(lshape, s.dtype)
        if s.axes[:1] == ("layers",):
            per_layer[path[0]] = per_layer.get(path[0], 0) + \
                extra / s.shape[0]
        else:
            whole += extra
    # a decode step's layer reads its cache, gathered where heads are
    cache = sum((_nbytes(v[3], v[0].dtype) - _nbytes(v[2], v[0].dtype))
                / v[0].shape[0] for v in cell.groups.get("cache", {}).values()
                if v[0].axes[:1] == ("layers",))
    layers = 2 + (cell.shape.kind == "train")
    return int(whole + layers * (max(per_layer.values(), default=0) + cache))


def _release_grads(model) -> None:
    """Drop the model's gradient tree and the views its parameters hold."""
    for p in model.parameters():
        p.grad = None
    model.grads = None


def trace_cell(cell: Cell, device: str = "cuda") -> Dict:
    """Trace the cell's step on fake tensors; the record's measured
    fields.  A train step is ``make_train_step``'s two parts: the loss's
    forward and backward (``steps.value_and_grad``) on the compute view,
    then AdamW (``optimizer.apply_updates``) on the parameters, gradients
    and state as the plan shards them (where FSDP shards a parameter, its
    gathered view and unreduced gradient are gone by then)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    dev = _trace_device(device)
    local, kind = cell.local, cell.shape.kind
    p = cell.groups["params"]
    sharded = any(v[2] != v[3] for v in p.values())  # FSDP shards a leaf
    rec = {"device": device, "traced_on": f"fake {dev} tensors" + (
        f" standing for {device}" if dev != device else "")}
    with FakeTensorMode():
        params = _fakes(p, dev)
        model = (ExpertParallelLM(local, params) if cell.experts is not None
                 else zoo.build(local, params))
        batch = _fakes(cell.groups["batch"], dev)
        args = [params, batch]
        if kind == "train":
            ocfg = steps_lib.adamw_config(local, RunConfig(model=local,
                                                           shape=cell.shape))
            shards = _fakes(p, dev, traced=False) if sharded else params
            opt_state = opt_lib.init_opt_state(shards, ocfg)
            args += [shards, opt_state] if sharded else [opt_state]
        elif kind == "decode":
            cache = _fakes(cell.groups["cache"], dev)
            args.append(cache)
        known = [t.untyped_storage() for tree in args
                 for _, t in _leaves(tree)]
        traced_args = _tree_bytes({i: a for i, a in enumerate(args)})
        t0 = time.time()
        with fake.tally(device) as kt, FlopCounterMode(
                display=False) as fc, _Tracer(known) as tr:
            if kind == "train":
                _, metrics, grads = steps_lib.value_and_grad(local, model,
                                                             batch)
                peak_fwd_bwd, full_grads = tr.peak, _tree_bytes(grads)
                if sharded:  # reduce-scattered: the shards remain
                    _release_grads(model)
                    del grads
                    grads = tree_map(torch.zeros_like, shards)
                tr.peak = tr.live
                _, _, om = opt_lib.apply_updates(shards, grads, opt_state,
                                                 ocfg)
                out = {"metrics": metrics, "opt": om}
            else:
                with torch.inference_mode():
                    out = (serve_lib.make_prefill_step(local)(model, batch)
                           if kind == "prefill" else
                           serve_lib.make_serve_step(local)(
                               model, cache, batch["tokens"]))
        rec["trace_s"] = round(time.time() - t0, 2)
        output = _tree_bytes(out if isinstance(out, dict) else
                             {i: o for i, o in enumerate(out)})
        peak_new = tr.peak
    args_local = sum(_group_bytes(g) for g in cell.groups.values())
    gather = _gather_bytes(cell)
    if kind == "train":  # the gradient tree as the plan shards it
        temp = max(peak_fwd_bwd - full_grads + _group_bytes(p) + gather,
                   peak_new)
        peak_new = max(peak_fwd_bwd, peak_new)
        output += _group_bytes(p) + _group_bytes(cell.groups["opt"])
    else:
        temp = peak_new + gather
        output -= cell.cache_gathered  # the cache comes back as its shard
    rec.update(
        argument_size_in_bytes=int(args_local),
        output_size_in_bytes=int(output),
        temp_size_in_bytes=int(temp),
        peak_bytes=int(args_local + temp),
        traced_argument_bytes=int(traced_args),
        traced_peak_bytes=int(traced_args + peak_new),
        flops_per_device=float(fc.get_total_flops() + kt.ops),
        bytes_per_device=float(tr.bytes + kt.bytes),
        kernel_flops=float(kt.ops),
        kernels=dict(sorted(kt.calls.items())),
        kernel_routes=kt.routes,
    )
    return rec


# ---------------------------------------------------------------------------
# Cell execution
# ---------------------------------------------------------------------------

#: the most Mamba-1 scan steps (sequence positions x layers) a cell is
#: traced at full depth with: the eager scan is traced a position at a
#: time (train_4k's 4096 x 64 take 20 to 30 minutes on a CPU), so a cell
#: past it is traced at two depths and combined
FULL_DEPTH_SCAN_STEPS = 2 ** 19


def depth_points(cfg: ModelConfig, shape: ShapeSpec):
    """The (tag, overrides, coefficient) points a cell is traced at where
    its full-depth trace would be too slow: a Mamba-1 model (``ssm``)
    whose prefill or train step scans more than
    :data:`FULL_DEPTH_SCAN_STEPS` positions x layers, at 2 and 3 layers,
    total(L) = (3 - L) C(2) + (L - 2) C(3).  These are
    ``roofline.points_for``'s 1 and 2 layers a layer deeper: a prefill's
    temp peak is linear in depth from 2 layers on, but the 1-layer peak
    lies one (tokens, d_model) activation below that line (falcon at 256
    and 1024 tokens, 1 to 5 layers), which 1 and 2 layers would add to
    every further layer.  None: traced at full depth."""
    if cfg.family == "ssm" and shape.kind != "decode" and \
            shape.seq_len * cfg.n_layers > FULL_DEPTH_SCAN_STEPS:
        L = cfg.n_layers
        return [("B", {"unroll_layers": True, "n_layers": 2}, 3 - L),
                ("C", {"unroll_layers": True, "n_layers": 3}, L - 2)]
    return None


def combine_records(points) -> Dict:
    """The point records ``[(record, coefficient)]`` combined field by
    field to full depth, as ``roofline.combine`` combines FLOPs: each
    number linearly, each dict (kernel calls, routes, collectives) key by
    key, a key a point lacks as 0; ``trace_s`` the points' sum; any other
    field the first point's."""
    out = {}
    for key in dict.fromkeys(k for rec, _ in points for k in rec):
        vals = [(rec.get(key), coef) for rec, coef in points]
        first = next((v for v, _ in vals if v is not None), None)
        if key == "trace_s":
            out[key] = round(sum(v for v, _ in vals), 2)
        elif isinstance(first, dict):
            out[key] = combine_records([(v or {}, c) for v, c in vals])
        elif isinstance(first, (int, float)) and not isinstance(first, bool):
            out[key] = sum(c * (v or 0) for v, c in vals)
        else:
            out[key] = first
    return out


def _measure(cell: Cell, device: str) -> Dict:
    """The trace's fields and the plan's collectives of one cell."""
    rec = trace_cell(cell, device)
    rec["collectives"] = plan_collectives(cell)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             cfg_overrides=None, shape: Optional[ShapeSpec] = None,
             mesh=None, device: str = "cuda") -> Dict:
    """The record of one cell (the module note): on ``mesh`` where given,
    else on the production mesh, made and destroyed here.  A plan the
    local view cannot express gives ``status: "error"`` and the reason;
    an inapplicable shape the JAX package's skip record."""
    t0 = time.time()
    if mesh is None:
        with production_mesh(multi_pod=multi_pod) as prod:
            return run_cell(arch, shape_name, multi_pod,
                            cfg_overrides=cfg_overrides, shape=shape,
                            mesh=prod, device=device)
    try:
        cell, meta = build_cell(arch, shape_name, multi_pod, mesh=mesh,
                                cfg_overrides=cfg_overrides, shape=shape)
    except PlanError as e:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "error", "reason": str(e)}
    if cell is None:
        return meta  # skipped
    rec = dict(meta)
    rec["local_config"] = {k: getattr(cell.local, k) for k in (
        "n_heads", "n_kv_heads", "d_ff", "vocab_size", "moe_dense_ff",
        "d_inner")}
    rec["local_experts"] = cell.experts
    points = depth_points(cell.cfg, cell.shape)
    if points is None:
        rec.update(_measure(cell, device))
    else:  # traced at the points' depths, combined to the full one
        recs, depths = [], []
        for _, ov, coef in points:
            point, _ = build_cell(arch, shape_name, multi_pod, mesh=mesh,
                                  cfg_overrides=dict(cfg_overrides or {},
                                                     **ov), shape=shape)
            recs.append((_measure(point, device), coef))
            depths.append(point.cfg.n_layers)
        rec.update(combine_records(recs))
        rec["traced_depths"] = depths
    rec["not_reported"] = list(NOT_REPORTED)
    rec["total_s"] = round(time.time() - t0, 2)
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------


def all_cells():
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for multi_pod in (False, True):
                yield arch, shape_name, multi_pod


def cell_tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'mp' if multi_pod else 'sp'}"


def _src_path() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def cell_command(arch, shape_name, multi_pod, path, device="cuda",
                 overrides=None) -> List[str]:
    """The subprocess that runs one cell into ``path``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape_name, "--json", path, "--device", device]
    if multi_pod:
        cmd.append("--multi-pod")
    for k, v in (overrides or {}).items():
        cmd += ["--set", f"{k}={json.dumps(v)}"]
    return cmd


def subprocess_env() -> Dict[str, str]:
    env = dict(os.environ)
    src = _src_path()
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def sweep(out_dir: str, skip_existing: bool = True,
          only_arch: Optional[str] = None, device: str = "cuda",
          timeout: float = 3600):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape_name, multi_pod in all_cells():
        if only_arch and arch != only_arch:
            continue
        tag = cell_tag(arch, shape_name, multi_pod)
        path = os.path.join(out_dir, tag + ".json")
        if skip_existing and os.path.exists(path):
            print(f"[skip existing] {tag}")
            continue
        cfg = get_config(arch)
        ok, why = shape_applicable(cfg, SHAPES[shape_name])
        if not ok:
            rec = {
                "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "skipped": why,
            }
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[skip rule] {tag}: {why}")
            continue
        print(f"[cell] {tag} ...", flush=True)
        t0 = time.time()
        try:
            p = subprocess.run(cell_command(arch, shape_name, multi_pod,
                                            path, device),
                               capture_output=True, text=True,
                               env=subprocess_env(), timeout=timeout)
        except subprocess.TimeoutExpired:
            p = subprocess.CompletedProcess([], -1, "", f"timed out after "
                                            f"{timeout} s")
        dt = time.time() - t0
        if p.returncode != 0:
            why = p.stderr[-1500:]
            if os.path.exists(path):  # the cell's own error record
                with open(path) as f:
                    why = json.load(f).get("reason") or why
            else:
                rec = {
                    "arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "status": "error",
                    "stderr": p.stderr[-4000:], "wall_s": round(dt, 1),
                }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            print(f"[FAIL] {tag} ({dt:.0f}s)\n{why}")
        else:
            print(f"[ok] {tag} ({dt:.0f}s)")
        results.append(tag)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", help="the sweep's directory (required with "
                    "--sweep)")
    ap.add_argument("--no-skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the program modelled: the kernels (cuda) or the "
                    "plain versions (cpu); nothing runs on a card")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override k=v")
    args = ap.parse_args(argv)

    if args.sweep:
        if not args.out:
            ap.error("--sweep needs --out")
        sweep(args.out, skip_existing=not args.no_skip_existing,
              only_arch=args.arch, device=args.device)
        return 0
    if not (args.arch and args.shape):
        ap.error("a cell needs --arch and --shape")

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        overrides[k] = v
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       cfg_overrides=overrides or None, device=args.device)
    except Exception:
        rec = {
            "arch": args.arch, "shape": args.shape,
            "multi_pod": args.multi_pod, "status": "error",
            "traceback": traceback.format_exc(),
        }
        print(rec["traceback"], file=sys.stderr)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rec, f, indent=1)
        return 1
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if rec.get("status", "skipped") != "error" else 1


if __name__ == "__main__":
    sys.exit(main())
