#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc/`` with ``nvcc``;
2. kernel phase: sim_alu against its plain PyTorch version on the
   card, on every opcode, at (1,1), (7,129), the corpus bucket's (B,N) and
   (4096,4096) — results must be bitwise equal; kernel and plain times;
3. path phase: ``python -m repro_torch verify`` over the whole TABLE2
   corpus on ``cuda`` (the main path, with the launch counters read just
   around it): it launches ``sim_loop`` once per bucket in each of its cold
   and warm runs and nothing else.  Every artifact's verdict must equal the
   corpus manifest's (the JAX package's own verdict); the fused loop's
   ``val``/``done``/``fail`` (one launch a run) must equal a CPU run of the
   port, a second fused run and the eager loop on the card (the yardstick,
   ``run_bucket_eager``, whose sim_alu launches, hmax, are read around it),
   bit for bit; then each warm run's wall time and ``torch.profiler`` busy
   share, fused and eager in turns, and sim_loop's own time, device time
   per launch, byte bound and latency floor (the per-cycle time of one
   node's dependent chain, timed on a one-node bucket, times hmax);
4. fail phase: a corrupted mapping (dropped route) must FAIL through
   ``sim_loop`` on the card with the same reason as on the CPU;
4b. store phase (the verify front door at full size: all 210 TABLE2
   artifacts, 177 with mappings, 203 mappings): ``python -m repro_torch
   store put`` into a temporary store, then ``verify --dir STORE --device
   cuda --bench-out`` (the launch counters read just around it): exactly 2
   ``sim_loop`` launches, the manifest's verdicts, cold and warm
   mappings/s; every key through ``ArtifactStore(verify="always",
   device="cuda").get``: ``sim_loop`` launches = ``verify_runs`` and no
   other kernel, the counters and each get's values equal to a CPU store's,
   ms a get at p50 and p99, the device's busy share of a traced pass and a
   ``cProfile`` of the gets by part; ``verify="first"`` twice over entries
   stored unverified (the second pass launches nothing); the step-0
   tampered artifact (a load placed on an ALU) FAILs with the JAX
   package's row and exit 1, and a store quarantines it; ``verify --dir``
   under ``REPRO_FAULTS`` = a ``sim.batch`` ``oserror`` exits non-zero
   and leaves the index, journal and entries unchanged; ``energy_sweep``
   over the corpus mappings on the card (one launch) equals the ``cpu``
   and ``numpy`` backends' rows; one ``fusion_report`` of the
   RMSNorm+SwiGLU block of ``tests/test_torch_fusion.py`` at llama3_2_3b's
   widths (3072 -> 8192), traced on meta tensors, whose first two lines
   must equal those the test holds;
4c. compile phase (the compiler, a main path of its own: all 210 TABLE2
   cells): ``python -m repro_torch compile W -u U --all-jobs --verify
   --device cuda --store STORE --out-dir D`` for each of the 30 workloads,
   8 processes at a time into one store (seed 0, full budgets,
   ``REPRO_QUICK`` unset; each process runs the CLI's ``main`` with the
   launch counters set to 0 just before it and written out just after):
   every artifact equal to the corpus file of its name (the JAX package's
   compile) but for wall time, verdicts the manifest's, ``sim_loop``
   launched once a compile that holds a mapping (177) and nothing else;
   ``diff --golden tests/golden_ii_quick.json D`` 0 regressed; ``store
   get`` of every key: the 177 proven cells hit without place & route and
   serve the compiled artifact, the rest miss; ``store warm --quick``
   twice (the first compiles the quick cells the verifying compiles did
   not store, the second nothing); atax_u2's spatial cell compiled on the
   CPU equals its compile on the card (one launch); a traced compile's
   busy share and sim_loop's device time; compile seconds a cell p50 /
   p99 / sum, the slowest cell and verify's share;
4d. collect phase (the paper's sweep, supervised: all 240 TABLE2 cells):
   ``python -m repro_torch.core.collect --out T/results.json --bench-out
   T/bench.json --store T/store --jobs 8 --batch-verify --device cuda
   --strict`` (seed 0, full budgets, ``REPRO_QUICK`` unset; each cell a
   worker process started from the runner's forkserver, never forked from
   a process that holds a CUDA context), in a process of its own that
   counts its launches and each worker's (``count_worker``): every record
   equal to ``experiments/cgra/results.json`` but for wall time and the
   store's counts, ``diff --golden tests/golden_ii_quick.json`` 0
   regressed, the bench entry's store 0 hits / 210 misses and its batch
   verify 203 mappings, 0 failed; ``sim_loop`` 60 in the verifying cells
   plus 1 in the batch verify, nothing else; a second run on the same
   ``--out`` runs nothing; a chaos run of atax_u2 under ``REPRO_FAULTS``
   (plaid crashed twice, st hung past ``--cell-timeout``) records a
   ``WorkerCrashed`` and a ``CompileTimeout`` and exits 1 under
   ``--strict``, and a clean re-run heals the record; the sweep's wall,
   cells/s, the cells' seconds (p50, p99, sum, slowest) and verify's share;
4e. farm phase: ``python -m repro_torch serve --device cuda --workers 4``
   over the collect phase's store: ``collect --remote`` (no store) equals
   the cold sweep with 210 hits and no compile, ``farm.served_per_s``;
   ``compile --remote --verify`` of a cell the store holds unverified,
   proven by one ``sim_loop`` launch inside the daemon; then a cold
   verifying remote compile (atax_u2 plaid, seed 1) that a worker compiles
   on the card, equal to the same compile on the CPU; a warm remote
   compile's ms at p50 and p99; SIGTERM drains (exit 0, the journal
   compacted) and a restart over a stale socket serves the seed-1 artifact
   warm; ``sim_loop`` 2 in all (daemon 1, its worker 1);
5. LM kernel phase: ``rmsnorm``, ``fused_swiglu`` and ``flash_attention``
   against their plain versions on the card, in float32 and bfloat16 on
   the shapes of ``tests/test_kernels.py`` (under its ``TOL``), flash also
   at head dims 160 and 256; the bf16 tensor-core flash kernel on every
   head dim in (32, 64, 80, 128, 160, 192, 256), S in (1, 17, 64, 65, 500),
   kv_group 1 and 3, causal, window 64 and full (under ``TOL``);
   ``fused_swiglu`` on each of its three routes (stream, tensor cores,
   SIMT) at 168 ragged shapes, M in (1, 4, 16, 17, 100, 129, 300), D in
   (72, 256, 1000), F in (130, 136, 320, 520), both dtypes (under
   ``TOL``), and on bf16 views 2 bytes past a 16-byte boundary at the
   prefill shape (SIMT, under ``TOL``, timed beside the aligned tensor-core
   call); and in bfloat16 at the serve
   path's shapes of llama3_2_3b and stablelm_12b (under ``PATH_TOL``, with
   rmsnorm's rows drawn at RMS from 0.1 to 10), with kernel, plain, bound
   and library times there (kernel and library timed in turns: kernel,
   library, kernel, library), fused_swiglu's route and two cuBLAS
   yardsticks (``x @ w1``, and ``x @ [w1 | w3]``, the same product work in
   one call); flash and SDPA at a 2000-token prefill; then the host time
   of one ``rmsnorm_cuda`` call at (4, 3072), part by part;
6. serve phase: ``python -m repro_torch.launch.serve --arch A --batch 4
   --prompt-len P --new-tokens 32`` on ``cuda`` at full width for A =
   llama3_2_3b, stablelm_12b, qwen3_14b (dense; qwen3's qk-norm through
   rmsnorm on rows of head dim 128), granite_moe_1b_a400m (moe),
   falcon_mamba_7b (ssm, Mamba-1), zamba2_1_2b (hybrid, Mamba-2 and a
   shared attention block) and qwen2_vl_72b (vlm, M-RoPE and the
   ``embeds`` / ``positions`` inputs; ``--layers 8``, a depth cut), P =
   500; whisper_tiny (encdec, with 1500 audio frames a sequence), P = 224;
   and h2o_danube_3_4b at batch 1, P = 4600, past its 4096-token window
   (the windowed flash tiles, the ring cache's roll and each decode
   step's wrap) (``SERVE_SHAPES``; the second main path, with the launch
   counters read just around each run): tokens (B, 32), cache length P +
   31, finite logits, exactly the launches of ``serve_launches``
   (rmsnorm / fused_swiglu / flash_attention: llama 1824 / 896 / 28,
   stablelm 2592 / 1280 / 40, granite 1568 / 0 / 24, falcon 2080 / 0 / 0,
   zamba2 2848 / 192 / 6, whisper 425 / 132 / 4, qwen3 5152 / 1280 / 40,
   qwen2_vl 544 / 256 / 8, danube 1568 / 768 / 24); for granite the
   routes dropped in the prefill per layer; a ``torch.profiler`` trace of
   the prefill (run again) and of one decode step, and the peak device
   memory; for llama, in float32 at full width and depth, 4
   teacher-forced decode steps against a full forward (``DECODE_TOL``);
   then for each model the card against the CPU at full width in float32
   (``PARITY_TOL``): 2 layers (the moe and ssm models' sliced from the
   full draw, qwen3's, qwen2_vl's and danube's their depth cut), zamba2
   at 7 layers sliced so (one shared site and one tail layer,
   ``ssm_chunk`` 64 so that the prompt spans two chunks) and whisper_tiny
   at its full depth, each on 2 x 128 prompt tokens (danube on 1 x 4600)
   and 4 teacher-forced steps, with granite's dispatch of each layer
   equal route for route to the CPU's on the same input;
7. motif phase: ``motif_pcu`` against its plain version on the card, bit
   for bit in float32 on FANIN, FANOUT and UNICAST (inputs mixing NaN,
   +-inf and +-0 in their first columns) and on three seeded random
   64-step schedules, at N from 1 to 2**24, and at the largest table; in
   bfloat16 at (3, 2048) under ``PATH_TOL``; kernel, device, plain and
   bound times at (3, 1024) and (3, 2**24);
8. Track-A tie: the card's table of each canonical schedule over 64
   iterations equals ``DFG.eval``'s history of its DFG, built with
   ``DFG.add``;
9. ops path: ``repro_torch.kernels.ops`` on ``cuda`` at the shapes of the
   kernel rows of ``benchmarks/run.py`` (the third main path, with the
   launch counters read just around it): each row equal to its plain
   version, each kernel launched exactly as often as its row was called;
10. train kernels: the backward kernels ``rmsnorm_bwd``,
   ``swiglu_gate_bwd`` and ``flash_attention_bwd`` (and flash's training
   forward: row log-sum-exp and float32 output) against autograd of the
   plain versions on the card, on ``tests/test_kernels.py``'s shapes in
   both dtypes under ``TOL`` (flash at d 32-256, kv_group 1 and 3, every
   mask), flash's backward at d 160 and 256 with a window under
   ``PATH_TOL``; at the train path's bf16 shapes ((16384, 3072),
   (16384, 8192), (96, 4096, 128) kv_group 3: ``rmsnorm_bwd`` a warp a
   row, flash's backward on ``wgmma`` + TMA) under ``PATH_TOL``, twice
   bitwise (no atomics), each kernel by name in a trace, timed beside its
   plain version, its bound (flash's also beside its design's floor) and
   its yardstick (the backward of ``F.rms_norm`` and of SDPA, in turns,
   device times from traces that name their kernels);
11. train path: ``python -m repro_torch.launch.train --arch A --batch 4
   --seq 4096 --steps 4`` on ``cuda`` at full width (the fourth main
   path, the launch counters read just around each run) for A =
   llama3_2_3b (dense), granite_moe_1b_a400m (moe, ``remat="nothing"``),
   zamba2_1_2b (hybrid: the SSD's backward, the gated norm's
   rmsnorm_bwd, the shared block's summed gradient), whisper_tiny
   (encdec: the plain encoder and cross-attention backward, 1500 audio
   frames), falcon_mamba_7b (ssm: the Mamba-1 scan's backward; ``--layers
   8``) and qwen2_vl_72b (vlm: M-RoPE and ``embeds`` in training;
   ``--layers 2``) (``TRAIN_RUNS``): finite losses, the first (moe: its
   nll) within 0.1 of ln V, finite gradient norms, exactly the launches
   of ``train_launches`` (llama 4 x 113 / 57 / 56 / 28 / 56 / 28:
   rmsnorm, its backward, fused_swiglu, the gate's backward,
   flash_attention, its backward; one formula a family, written out
   there), its ``time:`` line, and one more step traced, with every
   kernel of ``train_kernel_names`` by name and its device time by kind;
   then the card against the CPU in float32 at full width, batch 2 x 256
   (2 layers, the first of the full draw or the depth cut; zamba2 7,
   whisper 4 + 4; qwen2_vl_72b 1 layer at batch 1 x 256; ``ssm_chunk``
   64): loss and params after one AdamW step
   under ``PARITY_TOL``, each gradient leaf under ``GRAD_REL_TOL``, and
   for granite the card's dispatch of each layer equal to its recompute's
   in the backward, replayed on the CPU (``replayed_moe``); at smoke width
   on the card (llama3_2_3b): the loss falls on a repeated batch, a
   resumed run is bit-identical to a straight one, the injected failure
   is retried, a refused launch propagates, and 2 x 2 gradient
   accumulation equals one step of 4.

Then one JSON line per kernel (``{"kernels": [...]}``) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
#: H100 SXM HBM3 rate (NVIDIA data sheet), for the memory bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12
#: sim_alu moves one int32 opcode + four float32 operands in and one
#: float32 result out per element
SIM_ALU_BYTES_PER_ELEM = 24
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
SIM_ALU_SOURCE = "src/repro_torch/kernels/csrc/sim_alu.cu"
SIM_LOOP_SOURCE = "src/repro_torch/kernels/csrc/sim_loop.cu"
SIM_ALU_REPLACES = "src/repro/kernels/sim_alu.py:53"
#: the serve path's kernels: the TPU kernel each replaces
LM_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:24",
               "fused_swiglu": "src/repro/kernels/fused_swiglu.py:39",
               "flash_attention": "src/repro/kernels/flash_attention.py:70"}
MOTIF_SOURCE = "src/repro_torch/kernels/csrc/motif_pcu.cu"
MOTIF_REPLACES = "src/repro/kernels/motif_pcu.py:38"
KERNELS = ["sim_alu", "sim_loop", *LM_REPLACES, "motif_pcu"]
#: the head dims the bf16 tensor-core flash kernel is held at: each padded
#: width (32, 64, 128, 160, 256) and two that pad (80, 192)
FLASH_TC_DIMS = (32, 64, 80, 128, 160, 192, 256)
#: the iteration counts the motif kernel is held at
MOTIF_NS = (1, 256, 1000, 1024, 2048, 2 ** 24)
#: timed calls of each ops-path row (after one checked and one warm call)
OPS_REPS = 20
#: tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=2e-4, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-1)}
#: the LM kernels against their plain versions at the serve path's bf16
#: shapes.  Both compute in float32 and cast once, so they may differ by one
#: bf16 ulp (at most 2**-7 of the value, under rtol) plus float32 sum-order
#: noise near zero (under atol, a tenth of a typical flash output).
PATH_TOL = dict(rtol=1e-2, atol=5e-3)
#: teacher-forced decode against the full forward, float32 logits at full
#: width and depth: measured 2.5e-4 at most on an H100; logits reach ~0.8
#: and a typical one is ~0.12, which a wrong cache slot or mask moves
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
#: the card (kernels) against the CPU (plain versions), float32 logits
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)
#: the served models at full width and depth: the fields of each config
#: that are checked before the counts (attention widths for the families
#: with attention, experts and top_k for moe; d_inner, state and conv for
#: ssm; d_inner, state, SSM heads and the shared block's period for
#: hybrid; the encoder's depth and frames for encdec); each runs the
#: traffic of ``SERVE_SHAPES`` in bf16 from seed 0
_LM = ("n_layers", "d_model", "vocab_size")
_ATTN = ("n_heads", "n_kv_heads", "resolved_head_dim", "d_ff")
SERVED = {
    "llama3_2_3b": dict(zip(_LM + _ATTN, (28, 3072, 128256, 24, 8, 128,
                                          8192))),
    "stablelm_12b": dict(zip(_LM + _ATTN, (40, 5120, 100352, 32, 8, 160,
                                           13824))),
    "granite_moe_1b_a400m": dict(zip(
        _LM + _ATTN + ("n_experts", "top_k", "moe_dense_ff"),
        (24, 1024, 49155, 16, 8, 64, 512, 32, 8, 0))),
    "falcon_mamba_7b": dict(zip(_LM + ("d_inner", "ssm_state", "d_conv"),
                                (64, 4096, 65024, 8192, 16, 4))),
    "zamba2_1_2b": dict(zip(
        _LM + ("d_inner", "ssm_state", "n_ssm_heads", "attn_every") + _ATTN,
        (38, 2048, 32000, 4096, 64, 64, 6, 32, 32, 64, 8192))),
    "whisper_tiny": dict(zip(_LM + ("n_enc_layers", "enc_seq") + _ATTN,
                             (4, 384, 51865, 4, 1500, 6, 6, 64, 1536))),
    "qwen3_14b": dict(zip(_LM + _ATTN + ("qk_norm",),
                          (40, 5120, 151936, 40, 8, 128, 17408, True))),
    "qwen2_vl_72b": dict(zip(_LM + _ATTN + ("m_rope_sections",),
                             (80, 8192, 152064, 64, 8, 128, 29568,
                              (16, 24, 24)))),
    "h2o_danube_3_4b": dict(zip(_LM + _ATTN + ("sliding_window",),
                                (24, 3840, 32000, 32, 8, 120, 10240, 4096))),
}
#: the served models cut in depth (``--layers``): qwen2_vl_72b's 80 layers
#: are 145 GB in bf16; its first 8 and the embedding, 8.3 B parameters,
#: are 16.5 GB
SERVE_LAYERS = {"qwen2_vl_72b": 8}
#: each served model's traffic: (batch, prompt length, new tokens).  Whisper
#: reads 30 s of audio a window (1500 frames) and its published text
#: context is 448 tokens; a 224-token prompt is the previous window's text
#: that long-form transcription conditions on (its prompt limit, 448 // 2).
#: h2o_danube_3_4b reads one prompt past its 4096-token window, so that
#: the prefill's flash tiles skip the band's far side, the cache is a
#: rolled ring and every decode step wraps it
SERVE_SHAPES = {arch: (4, 500, 32) for arch in SERVED}
SERVE_SHAPES["whisper_tiny"] = (4, 224, 32)
SERVE_SHAPES["h2o_danube_3_4b"] = (1, 4600, 32)


def model_fields(arch: str, layers=None):
    """The fields of ``SERVED[arch]`` a run's config must have, with its
    depth cut to ``layers`` where given."""
    fields = dict(SERVED[arch])
    if layers is not None:
        fields["n_layers"] = layers
    return fields


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events, after a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def corpus_mappings():
    from repro_torch import CORPUS_DIR
    from repro_torch.compiler.cli import _gather_artifacts

    with contextlib.redirect_stdout(io.StringIO()):  # the MANIFEST note
        arts = _gather_artifacts([CORPUS_DIR])
    return [m for _, art in arts if art.mappings
            for m in art.rebuild_mappings()]


def kernel_phase(bucket_shape):
    """sim_alu against its plain version on the card; returns the kernel's
    JSON record minus ``launches``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.sim_alu import sim_alu_cuda

    rng = np.random.default_rng(SEED)
    max_err = 0.0
    times = {}
    for shape in [(1, 1), (7, 129), tuple(bucket_shape), (4096, 4096)]:
        a, b, c, leaf = (
            torch.from_numpy(np.where(
                rng.random(shape) < 0.1, 0.0,
                rng.integers(-2 ** 15, 2 ** 15 + 1, shape)
            ).astype(np.float32)).cuda() for _ in range(4))
        mixed = torch.from_numpy(
            rng.integers(-1, 21, shape).astype(np.int32)).cuda()
        # every opcode in [0, 20) plus two out-of-range ones, each filling
        # the whole shape, then a random mix
        for code in list(range(-1, 21)) + [None]:
            op = mixed if code is None else torch.full(
                shape, code, dtype=torch.int32, device="cuda")
            got = sim_alu_cuda(op, a, b, c, leaf)
            want = ref.sim_alu(op, a, b, c, leaf)
            torch.cuda.synchronize()
            max_err = max(max_err, (got - want).abs().max().item())
            require(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)),
                    f"sim_alu differs from its plain version at {shape}, "
                    f"opcode {code}")
        if shape in (tuple(bucket_shape), (4096, 4096)):
            iters = 200 if shape == (4096, 4096) else 2000
            k_ms = cuda_ms(lambda: sim_alu_cuda(mixed, a, b, c, leaf), iters)
            p_ms = cuda_ms(lambda: ref.sim_alu(mixed, a, b, c, leaf),
                           max(iters // 10, 20))
            # bound: the larger of bytes over HBM rate and operations
            # (one per lane, two for mac) over the float32 rate
            ops = mixed.numel() + int((mixed == 8).sum())
            bounds = {"bytes": mixed.numel() * SIM_ALU_BYTES_PER_ELEM
                      / HBM_BYTES_PER_S * 1e3,
                      "operations": ops / FP32_OPS_PER_S * 1e3}
            by = max(bounds, key=bounds.get)
            times[shape] = (k_ms, p_ms, bounds[by], by)
            print(f"kernel sim_alu {shape[0]}x{shape[1]}: {k_ms:.6f} ms, "
                  f"plain {p_ms:.6f} ms, bound {bounds[by]:.6f} ms ({by}); "
                  f"bitwise equal on 22 opcodes + mix (tolerance 0)")
        else:
            print(f"kernel sim_alu {shape[0]}x{shape[1]}: bitwise equal on "
                  "22 opcodes + mix (tolerance 0)")
    k_ms, p_ms, bound, by = times[tuple(bucket_shape)]
    return {"name": "sim_alu", "route": "cuda", "source": SIM_ALU_SOURCE,
            "replaces": SIM_ALU_REPLACES, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def sim_loop_bytes(pb) -> int:
    """The bytes the whole loop must move for this bucket's data: ``ii``
    and ``horizon``; ``exec_mask`` and ``issue`` of every node (each cycle
    tests them); ``opcode``, ``leaf`` and ``op_kind`` of each node that
    executes, ``op_dist`` of its routed and broken operands, ``op_src`` and
    the matched ``op_steps`` of its routed ones, ``op_feed`` of its feeds;
    ``step_abs`` of every step and ``step_src`` of each real one; then
    ``val``, ``done`` (node rows) and ``fail`` written once."""
    import numpy as np

    from repro_torch.sim.lower import K_BROKEN, K_FEED, K_ROUTED
    from repro_torch.sim.step import NEVER

    B, N, K, M, S = pb.shape
    ex = pb.exec_mask[:, :, None]
    routed = int(((pb.op_kind == K_ROUTED) & ex).sum())
    broken = int(((pb.op_kind == K_BROKEN) & ex).sum())
    feed = int(((pb.op_kind == K_FEED) & ex).sum())
    n_exec = int(pb.exec_mask.sum())
    read = (8 * B + 5 * B * N + (8 + K) * n_exec + 4 * (routed + broken)
            + routed * (4 + 4 * M) + 4 * feed + 4 * B * S
            + 4 * int(np.sum(pb.step_abs < NEVER)))
    return read + 5 * B * N * pb.iterations + B


@contextlib.contextmanager
def plain_alu():
    """The eager loop with the plain ALU (``ref.sim_alu``) in place of the
    sim_alu kernel while the block runs: the fused kernel's plain version
    on the card."""
    from repro_torch.kernels import ref
    from repro_torch.sim import step

    kernel_alu = step.sim_alu
    step.sim_alu = ref.sim_alu
    try:
        yield
    finally:
        step.sim_alu = kernel_alu


#: cycles of the latency probe's one-node bucket
CHAIN_CYCLES = 4096


def chain_statics(cycles: int):
    """A one-mapping bucket whose one node runs every cycle (ii 1) for
    ``cycles`` cycles, adding a feed to its own previous value, which it
    reads back through one route step (M = 1): each cycle is the fused
    kernel's whole dependent chain (gather, ALU, write, route step, three
    barriers) and nothing else, with its statics hot in L1."""
    import torch

    from repro_torch.kernels.sim_loop import STATICS
    from repro_torch.sim.lower import K_FEED, K_ROUTED

    one = {"ii": [1], "horizon": [cycles], "opcode": [[5]],  # add
           "exec_mask": [[True]], "issue": [[0]], "leaf": [[0.0]],
           "op_kind": [[[K_ROUTED, K_FEED, 0]]], "op_src": [[[0, 1, 1]]],
           "op_dist": [[[1, 0, 0]]], "op_feed": [[[0.0, 1.0, 0.0]]],
           "op_steps": [[[[0], [1], [1]]]], "step_src": [[0]],
           "step_abs": [[1]]}
    return {name: torch.tensor(one[name], dtype=dtype, device="cuda")
            for name, (dtype, _) in STATICS.items()}


def chain_floor_us():
    """Device time per cycle of the fused kernel's dependent chain alone
    (:func:`chain_statics`), after checking the probe's values bit for
    bit against the same float32 adds on the host; None when the profiler
    misses it."""
    import numpy as np

    from repro_torch.kernels.sim_loop import sim_loop_cuda

    statics = chain_statics(CHAIN_CYCLES)
    val, done, fail = sim_loop_cuda(statics, CHAIN_CYCLES)
    want = np.zeros(CHAIN_CYCLES, dtype=np.float32)
    acc = np.float32(0.0)
    for t in range(CHAIN_CYCLES):
        acc = np.float32(acc + np.float32(np.float32(1.0) + np.float32(t)))
        want[t] = acc
    got = val[0, 0].cpu().numpy()
    require(bool(done[0, 0].all()) and not bool(fail.any())
            and np.array_equal(got, want),
            "the latency probe's one-node bucket ran wrong")
    dev = device_ms(lambda: sim_loop_cuda(statics, CHAIN_CYCLES), 10)
    return None if dev is None else dev / CHAIN_CYCLES * 1e3


def path_phase(mappings):
    """The main path on the card: ``verify`` launches ``sim_loop`` once per
    bucket and run; its state equals the CPU run and the eager loop on the
    card (the yardstick, whose sim_alu launches are read here), bit for
    bit.  Returns the sim_loop record minus ``launches``, and the
    launches of the CLI run and of the eager run."""
    import numpy as np
    import torch

    from repro_torch import CORPUS_DIR
    from repro_torch.compiler.cli import main as cli_main
    from repro_torch.kernels.sim_loop import sim_loop_cuda
    from repro_torch.sim.batch import prepare_batch
    from repro_torch.sim.step import (_kernel_statics, run_bucket,
                                      run_bucket_eager)

    with open(os.path.join(CORPUS_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["verify", CORPUS_DIR, "--device", "cuda"])
    launched = read_counts()
    text = buf.getvalue()
    want = dict.fromkeys(launched, 0)
    want["sim_loop"] = 2  # one bucket, in the cold run and in the warm run
    require(launched == want,
            f"verify launched {launched}, want {want} (sim_loop once per "
            "bucket in each of its cold and warm runs, nothing else)")
    require(rc == manifest["verify_exit_code"],
            f"verify exited {rc}, manifest says "
            f"{manifest['verify_exit_code']}; its output ends:\n"
            f"{text[-3000:]}")
    got = {}
    for line in text.splitlines():
        word = line[:6].strip()
        if word in ("OK", "FAIL", "SKIP"):
            got[line[6:40].strip()] = (word, line[41:].strip())
    counts = {"OK": 0, "FAIL": 0, "SKIP": 0}
    for fn, want_v in manifest["files"].items():
        label = fn[:-len(".json")].replace("__", "/")
        require(label in got, f"verify printed no verdict for {label}")
        word, detail = got[label]
        require(word == want_v["verdict"],
                f"{label}: {word} on the card, {want_v['verdict']} in the "
                f"manifest ({detail})")
        if word == "OK":
            require(detail == f"{want_v['segments']} mapping(s) verified",
                    f"{label}: {detail}")
        counts[word] += 1
    require(len(got) == len(manifest["files"]),
            f"{len(got)} verdicts for {len(manifest['files'])} artifacts")
    summary = [ln for ln in text.splitlines() if ln.startswith("batched[")]
    require(len(summary) == 1, "verify printed no throughput line")

    prep = {d: prepare_batch(mappings, iterations=manifest["iterations"],
                             device=d) for d in ("cuda", "cpu")}
    pb = prep["cuda"].packed
    cpu = run_bucket(prep["cpu"].packed)
    reset_counts()
    dev = run_bucket(pb)
    one = read_counts()
    require(one == {**dict.fromkeys(one, 0), "sim_loop": 1},
            f"one run_bucket on the card launched {one}, want sim_loop once")
    dev2 = run_bucket(pb)
    reset_counts()
    eager = run_bucket_eager(pb)
    eager_counts = read_counts()
    require(eager_counts == {**dict.fromkeys(eager_counts, 0),
                             "sim_alu": pb.hmax},
            f"the eager loop launched {eager_counts}, want sim_alu hmax = "
            f"{pb.hmax} times")
    for i, name in enumerate(("val", "done", "fail")):
        for other, what in ((cpu, "the CPU run"), (dev2, "a second fused "
                            "run"), (eager, "the eager loop on the card")):
            require(np.array_equal(dev[i], other[i]) and
                    dev[i].dtype == other[i].dtype,
                    f"{name} of the fused kernel differs from {what}")
    require(bool(np.isfinite(dev[0]).all()), "non-finite values")
    B, N, K, M, S = pb.shape
    print(f"path: verify over {len(manifest['files'])} artifacts, "
          f"{len(mappings)} mappings; bucket (B,N,K,M,S)=({B},{N},{K},{M},"
          f"{S}), hmax {pb.hmax}; verdicts OK {counts['OK']} FAIL "
          f"{counts['FAIL']} SKIP {counts['SKIP']} = manifest; launches "
          f"{launched}")
    print(f"path: {summary[0]}")
    print(f"path: val/done/fail of the fused loop (sim_loop, 1 launch a run)"
          f" equal the CPU run, a second fused run and the eager loop on the "
          f"card (sim_alu launches {eager_counts['sim_alu']} = hmax), bit for "
          f"bit (tolerance 0); "
          f"{int(dev[1].sum())} values, {int(dev[2].sum())} read failures")

    # the warm run of each loop, in turns: wall time, device busy share
    loops = (("fused", lambda: run_bucket(pb), "sim_loop_kernel"),
             ("eager", lambda: run_bucket_eager(pb), "sim_alu_kernel"))
    for turn in range(2):
        for name, run, kernel in loops:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 20 if name == "fused" else 5
            for _ in range(reps):
                run()
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            profile_run(f"{name} loop, turn {turn + 1}", run, wall_ms,
                        kernel, top=turn == 0)

    statics = _kernel_statics(pb)
    kern = lambda: sim_loop_cuda(statics, pb.iterations)  # noqa: E731
    k_turns = [cuda_ms(kern, 200) for _ in range(2)]
    k_devs = [device_ms(kern, 50) for _ in range(2)]
    with plain_alu():
        p_ms = cuda_ms(lambda: run_bucket_eager(pb), 3)
    n_bytes = sim_loop_bytes(pb)
    # per value produced: leaf + q, then one ALU operation (two for mac)
    ops = int((dev[1] * (2 + (pb.opcode == 8))[:, :, None]).sum())
    bound, by = _bound(n_bytes, ops, FP32_OPS_PER_S)
    chain_us = chain_floor_us()
    k_ms, k_dev = _mean(k_turns), _mean(k_devs)
    per_cycle = "not measured" if k_dev is None else \
        f"{k_dev / pb.hmax * 1e3:.3f} us"
    share = "" if k_dev is None else \
        f", {100 * bound / k_dev:.2f}% of the bound in device time"
    if chain_us is None:
        latency, floor_txt = None, "latency floor not measured"
    else:
        latency = pb.hmax * chain_us / 1e3
        floor_txt = (f"latency floor {latency:.6f} ms (hmax {pb.hmax} x "
                     f"{chain_us:.3f} us, one cycle of the dependent chain "
                     f"alone, timed over {CHAIN_CYCLES} cycles of a one-node "
                     "bucket)")
        if k_dev is not None:
            floor_txt += f", {100 * latency / k_dev:.2f}% of it in device time"
    print(f"kernel sim_loop bucket ({B},{N},{K},{M},{S}) I "
          f"{pb.iterations}: {k_ms:.6f} ms a launch (turns "
          f"{_turns_txt(k_turns)}; {_device_txt(k_dev)}, turns "
          f"{_turns_txt(k_devs)}; {per_cycle} of device time per simulated "
          f"cycle over hmax {pb.hmax}), plain {p_ms:.6f} ms (the eager loop "
          f"with ref.sim_alu, copies in and out included), bound "
          f"{bound:.6f} ms ({by}: {n_bytes} bytes){share}; {floor_txt}; "
          "library none (no PyTorch call runs a cycle loop); bitwise equal "
          "(tolerance 0)")
    err = float(np.abs(dev[0] - cpu[0]).max())
    record = {"name": "sim_loop", "route": "cuda", "source": SIM_LOOP_SOURCE,
              "replaces": SIM_ALU_REPLACES, "max_abs_err": err, "ms": k_ms,
              "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": bound,
              "bound_by": by, "latency_floor_ms": latency, "library_ms": None}
    return record, launched, eager_counts


def profile_run(label: str, run, wall_ms: float, kernel: str,
                top: bool) -> None:
    """Where one warm run of a cycle loop spends device time
    (``torch.profiler``): device busy time against the unprofiled warm
    wall time ``wall_ms``, and ``kernel``'s own device time per launch;
    with ``top``, the five largest kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"profile: {label}: warm run {wall_ms:.6f} ms wall; no device "
              "time in the trace (not measured)")
        return
    own = [e for e in kernels if kernel in e.key]
    own_us = (sum(e.self_device_time_total for e in own)
              / max(sum(e.count for e in own), 1))
    print(f"profile: {label}: warm run {wall_ms:.6f} ms wall, device busy "
          f"{busy_ms:.6f} ms ({100 * busy_ms / wall_ms:.2f}% busy); "
          f"{sum(e.count for e in kernels)} kernels; {kernel} "
          f"{own_us:.3f} us/launch")
    if top:
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
            print(f"profile:   {e.self_device_time_total / 1e3:9.6f} ms "
                  f"{e.count:5d}x {e.key[:90]}")


def fail_phase(mappings):
    """A dropped route FAILs through the fused kernel (one launch) with the
    CPU run's reason."""
    from repro_torch.sim.batch import simulate_batch

    bad = copy.deepcopy(next(m for m in mappings if m.routes))
    bad.routes.pop(next(iter(bad.routes)))
    reset_counts()
    v_dev = simulate_batch([bad], iterations=3, device="cuda")[0]
    counts = read_counts()
    v_cpu = simulate_batch([bad], iterations=3, device="cpu")[0]
    require(counts == {**dict.fromkeys(counts, 0), "sim_loop": 1},
            f"the fail run launched {counts}, want sim_loop once")
    require(not v_dev.ok and "not present at read time" in v_dev.reason,
            f"dropped route not caught on the card: {v_dev!r}")
    require((v_dev.ok, v_dev.reason) == (v_cpu.ok, v_cpu.reason),
            f"card {v_dev!r} vs CPU {v_cpu!r}")
    print(f"fail: dropped route FAILs through sim_loop on the card as on the "
          f"CPU: {v_dev.reason}")


#: the JAX package's verdict on the tampered copy of atax_u2__plaid.json
#: (node 5, a load, moved onto FU 0, an ALU): ``python -m repro.compiler
#: verify`` prints this row and exits 1
TAMPERED_ROW = ("FAIL  atax_u2/plaid                      unloadable mapping "
                "(AssertionError: (5, 'load', 'alu'))")
#: the cut of the corpus that ``store_phase`` profiles on the host, gets
#: per key
HOST_PROFILE_GETS = 40


def _tampered_artifact(path: str) -> str:
    """The step-0 fault: ``atax_u2__plaid.json`` without its lowered forms,
    node 5 (a load) moved onto FU 0 (an ALU) in node 2's modulo slot; a
    simulation accepts it, ``Mapping.validate()`` does not."""
    from repro_torch import CORPUS_DIR

    with open(os.path.join(CORPUS_DIR, "atax_u2__plaid.json")) as f:
        art = json.load(f)
    art.pop("compiled_sim")
    art["mappings"][0]["place"]["5"] = 0
    with open(path, "w") as f:
        json.dump(art, f)
    return path


def _store_state(root: str):
    out = {}
    for name in ("index.json", "journal.jsonl"):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    out["entries"] = sorted(os.listdir(os.path.join(root, "entries")))
    return out


def _pct(values, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))]


def _recording_simulate(record):
    """``CompileResult.simulate`` that appends each call's values to
    ``record[device type]`` (the store's verifying gets call it)."""
    import torch

    from repro_torch.compiler.artifact import CompileResult

    simulate = CompileResult.simulate

    def recorded(self, iterations=3, device=None, backend=None):
        out = simulate(self, iterations, device, backend)
        record.setdefault(torch.device(device).type, []).append(out)
        return out

    return recorded


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def host_profile_of_gets(store, keys) -> None:
    """Where a verifying get's host time goes: ``cProfile`` over
    ``HOST_PROFILE_GETS`` gets, each part's cumulative time a get (the
    profiler's own cost inflates every Python call alike).  The top-level
    parts do not nest; "other" is the rest of the get."""
    import cProfile
    import pstats

    top = (("read + sha check", "store.py", "_load_entry_file"),
           ("artifact from JSON", "artifact.py", "from_json"),
           ("rebuild + validate", "artifact.py", "rebuild_mappings"),
           ("stored forms + pack", "artifact.py", "_stored_prepared"),
           ("cycle loop + verdicts", "batch.py", "_bucket_verdicts"),
           ("index row", "store.py", "_index_row"),
           ("journal append", "journal.py", "append"),
           ("index lock", "fsio.py", "locked"))
    nested = (("validate()", "mapping.py", "validate"),
              ("run_bucket", "step.py", "run_bucket"),
              ("sim_loop_cuda", "sim_loop.py", "sim_loop_cuda"))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for k in keys[:HOST_PROFILE_GETS]:
        store.get(k)
    prof.disable()
    per_get = (time.perf_counter() - t0) / HOST_PROFILE_GETS * 1e3
    stats = pstats.Stats(prof).stats

    def ms(fname, func):
        return sum(v[3] for (f, _ln, fn), v in stats.items()
                   if fn == func and f.endswith(fname)
                   and "repro_torch" in f) / HOST_PROFILE_GETS * 1e3

    parts = [(label, ms(f, fn)) for label, f, fn in top]
    parts.append(("other", per_get - sum(v for _, v in parts)))
    print(f"store: host profile of {HOST_PROFILE_GETS} verifying gets "
          f"(cProfile, {per_get:.3f} ms a get under it), ms a get by part: "
          + "; ".join(f"{label} {v:.3f}" for label, v in parts)
          + "; nested: " + "; ".join(f"{label} {ms(f, fn):.3f}"
                                     for label, f, fn in nested))


def store_phase():
    """The verify front door at full size: the whole TABLE2 corpus put into
    a store; ``verify --dir`` on the card (two ``sim_loop`` launches, the
    manifest's verdicts); every key read under ``verify="always"`` (one
    launch a verifying get, values equal to a CPU store's) and twice under
    ``verify="first"`` (the second pass launches nothing); the tampered
    artifact FAILs; an injected ``sim.batch`` fault fails ``verify --dir``
    and leaves the index; ``energy_sweep`` on the card equals the CPU's
    and numpy's rows.  Returns the store path's ``sim_loop`` launches."""
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import CORPUS_DIR
    from repro_torch.compiler.artifact import CompileResult
    from repro_torch.compiler.cli import main as cli_main
    from repro_torch.compiler.store import ArtifactStore, key_for
    from repro_torch.core.power_area import energy_sweep

    with open(os.path.join(CORPUS_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    files = sorted(manifest["files"])
    arts = {fn: CompileResult.load(os.path.join(CORPUS_DIR, fn))
            for fn in files}
    label_of = {key_for(a).describe(): fn for fn, a in arts.items()}
    keys = [key_for(arts[fn]) for fn in files]
    launches = {}
    tmp = tempfile.mkdtemp(prefix="repro_store_")
    try:
        root = os.path.join(tmp, "store")
        # 1. store put, then verify --dir on the card
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["store", "put", "--dir", root,
                           *[os.path.join(CORPUS_DIR, fn) for fn in files]])
        require(rc == 0 and buf.getvalue().count("stored as") == len(files),
                f"store put exited {rc}: {buf.getvalue()[-2000:]}")
        bench = os.path.join(tmp, "bench.json")
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["verify", "--dir", root, "--device", "cuda",
                           "--bench-out", bench, "--bench-note", "store"])
        counts = read_counts()
        want = {**dict.fromkeys(counts, 0), "sim_loop": 2}
        require(counts == want, f"verify --dir launched {counts}, want "
                "sim_loop twice (cold and warm, one bucket) and nothing else")
        require(rc == manifest["verify_exit_code"],
                f"verify --dir exited {rc}")
        launches["verify --dir"] = counts["sim_loop"]
        rows = 0
        for line in buf.getvalue().splitlines():
            word = line[:6].strip()
            if word not in ("OK", "FAIL", "SKIP"):
                continue
            label = next(lb for lb in label_of if line[6:].startswith(lb))
            want_v = manifest["files"][label_of[label]]
            require(word == want_v["verdict"],
                    f"{label}: {word} from the store, {want_v['verdict']} "
                    "in the manifest")
            rows += 1
        require(rows == len(files), f"{rows} rows for {len(files)} entries")
        with open(bench) as f:
            entry = json.load(f)["runs"][-1]["sim_throughput"]
        print(f"store: put {len(files)} artifacts; verify --dir on the card: "
              f"{rows} rows = manifest, launches {counts}; cold "
              f"{entry['cold_mappings_per_s']} mappings/s, warm "
              f"{entry['warm_mappings_per_s']} mappings/s "
              f"(--bench-out entry {json.dumps(entry)})")

        # 2. verify="always": one launch a verifying get; values = CPU's
        cpu_root = os.path.join(tmp, "cpu")
        shutil.copytree(root, cpu_root)
        values = {}
        with _patched(CompileResult, "simulate", _recording_simulate(values)):
            served = {}
            for dev, path in (("cuda", root), ("cpu", cpu_root)):
                store = ArtifactStore(path, verify="always", device=dev)
                reset_counts()
                wall = []
                for k in keys:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = store.get(k)
                    wall.append((time.perf_counter() - t0) * 1e3)
                    require(res is not None, f"{k.describe()} missed")
                counts = read_counts()
                served[dev] = (store.counters.to_json(), wall)
                if dev == "cuda":
                    runs = store.counters.verify_runs
                    want = {**dict.fromkeys(counts, 0), "sim_loop": runs}
                    require(runs == sum(bool(a.mappings)
                                        for a in arts.values()),
                            f"{runs} verifying gets")
                    require(counts == want,
                            f"the always gets launched {counts}, want "
                            f"sim_loop = verify_runs = {runs}, nothing else")
                    launches["store get, always"] = counts["sim_loop"]
        require(served["cuda"][0] == served["cpu"][0],
                f"counters on the card {served['cuda'][0]} vs the CPU "
                f"{served['cpu'][0]}")
        require(values["cuda"] == values["cpu"],
                "a verifying get's values on the card differ from the CPU's")
        wall = served["cuda"][1]
        verifying = [w for w, fn in zip(wall, files) if arts[fn].mappings]
        store = ArtifactStore(root, verify="always", device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in keys:
                store.get(k)
        traced_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        launched = sum(e.count for e in dev if "sim_loop" in e.key)
        busy = ("not measured (no device time in the trace)" if busy_ms == 0
                else f"{busy_ms:.6f} ms of device time ({launched} sim_loop "
                f"launches) in a traced pass of gets that took "
                f"{traced_ms:.3f} ms of wall time "
                f"({100 * busy_ms / traced_ms:.4f}% busy, both from that "
                f"pass; the untraced pass took {sum(wall):.3f} ms)")
        print(f"store: verify=always over {len(keys)} keys on the card: "
              f"sim_loop {launches['store get, always']} = verify_runs, "
              f"nothing else; counters {served['cuda'][0]} = the CPU "
              f"store's; values = the CPU's (tolerance 0); ms a verifying "
              f"get p50 {_pct(verifying, 50):.3f}, p99 "
              f"{_pct(verifying, 99):.3f}, mean "
              f"{sum(verifying) / len(verifying):.3f} ({len(verifying)} "
              f"gets); ms a get over all keys p50 {_pct(wall, 50):.3f}, p99 "
              f"{_pct(wall, 99):.3f}; device {busy}")
        host_profile_of_gets(
            ArtifactStore(root, verify="always", device="cuda"),
            [k for k, fn in zip(keys, files) if arts[fn].mappings])

        # 3. verify="first", twice, on entries stored unverified
        first_root = os.path.join(tmp, "first")
        first = ArtifactStore(first_root, verify="first", device="cuda")
        for fn, k in zip(files, keys):
            a = CompileResult.load(os.path.join(CORPUS_DIR, fn))
            a.verified = None
            first.put(a, key=k)
        per_pass = []
        for _ in range(2):
            reset_counts()
            for k in keys:
                require(first.get(k) is not None, f"{k.describe()} missed")
            per_pass.append(read_counts()["sim_loop"])
        require(per_pass == [first.counters.verify_runs, 0]
                and first.counters.verify_failures == 0,
                f"verify=first launched {per_pass} in its two passes, "
                f"verify_runs {first.counters.verify_runs}")
        launches["store get, first"] = per_pass[0]
        print(f"store: verify=first, two passes: sim_loop {per_pass} "
              f"(verify_runs {first.counters.verify_runs}, then none)")

        # 4. the step-0 fault on the card
        bad = _tampered_artifact(os.path.join(tmp, "tampered.json"))
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["verify", bad, "--device", "cuda"])
        fails = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("FAIL")]
        require(rc == 1 and fails == [TAMPERED_ROW],
                f"the tampered artifact: exit {rc}, rows {fails}")
        bad_store = ArtifactStore(os.path.join(tmp, "bad"), verify="always",
                                  device="cuda")
        res = CompileResult.load(bad)
        bad_store.put(res)
        require(bad_store.get(key_for(res)) is None
                and bad_store.counters.verify_failures == 1
                and read_counts()["sim_loop"] == 0,
                "the tampered artifact was served from a store")
        print(f"store: the tampered artifact FAILs on the card as in the JAX "
              f"package: {fails[0][6:].strip()} (exit 1); a store quarantines "
              f"it without a launch")

        # 5. an injected sim.batch fault fails verify --dir, index untouched
        before = _store_state(root)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   REPRO_FAULTS=json.dumps([{"mode": "oserror",
                                             "site": "sim.batch"}]))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "verify", "--dir", root,
             "--device", "cuda"], env=env, capture_output=True, text=True,
            timeout=300)
        require(proc.returncode != 0 and "injected transient I/O fault at "
                "sim.batch" in proc.stderr,
                f"verify --dir under a sim.batch fault exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        require(_store_state(root) == before,
                "the faulted verify --dir changed the store")
        print(f"store: REPRO_FAULTS sim.batch oserror: verify --dir exits "
              f"{proc.returncode} ({proc.stderr.strip().splitlines()[-1]}); "
              "index, journal and entries unchanged")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. energy_sweep over the corpus mappings
    rows_in = [(a.arch, m, 10) for a in arts.values() if a.mappings
               for m in a.rebuild_mappings()]
    reset_counts()
    t0 = time.perf_counter()
    card = energy_sweep(rows_in, device="cuda")
    card_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    require(counts == {**dict.fromkeys(counts, 0), "sim_loop": 1},
            f"energy_sweep launched {counts}, want sim_loop once")
    launches["energy_sweep"] = 1
    cpu = energy_sweep(rows_in, device="cpu")
    host = energy_sweep(rows_in, backend="numpy")

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "sim_backend"}
                for r in rows]

    require(strip(card) == strip(cpu) == strip(host),
            "energy_sweep rows differ between the card, the CPU and numpy")
    require({r["sim_backend"] for r in card} == {"cuda"}
            and all(r["verified"] for r in card),
            "energy_sweep on the card: a row not verified by cuda")
    print(f"store: energy_sweep over {len(card)} corpus mappings on the card "
          f"in {card_ms:.3f} ms (sim_loop once), rows equal the cpu and "
          f"numpy backends' (sim_backend aside); total energy "
          f"{sum(r['energy_uj'] for r in card):.6f} uJ")

    # 7. the motif pass over llama3_2_3b's RMSNorm+SwiGLU block: the block
    # tests/test_torch_fusion.py holds against the JAX package's jaxpr DFG,
    # at llama's widths, with the report lines that test expects
    import torch.nn.functional as F
    from repro_torch.core.fusion import fusion_report

    def block(x, w1, w3, w2, scale):
        h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) \
            * scale
        y = F.silu(h @ w1) * (h @ w3)
        return x + y @ w2

    d, f_ = SERVED["llama3_2_3b"]["d_model"], SERVED["llama3_2_3b"]["d_ff"]
    args = [torch.empty(s, device="meta")
            for s in [(4, d), (d, f_), (d, f_), (f_, d), (d,)]]
    lines = fusion_report(block, *args).splitlines()[:2]
    require(lines == ["aten DFG: 20 nodes, 13 compute",
                      "motifs: 4 (fan-in 0, fan-out 1, unicast 3), "
                      "covered 12/13"],
            f"the block's fusion report {lines} differs from the lines "
            f"its test holds")
    print(f"fusion: llama3_2_3b RMSNorm+SwiGLU block ({d} -> {f_}, fake "
          f"tensors on the host; the report its test holds): "
          + " | ".join(lines))
    return launches


#: the compile phase's CLI processes at a time: compile is host work, one
#: core a process
COMPILE_WORKERS = 8
#: the artifact fields that record wall time or the run (held out of the
#: comparison with the corpus)
WALL_FIELDS = ("timings", "provenance")


def _mapping_fields(art) -> dict:
    """An artifact's JSON minus what records wall time or the run
    (``timings``, ``provenance``, each pass's ``wall_s``): the mapping,
    its numbers, the motif and pass counters, the route cache, the lowered
    forms and the verdict."""
    out = {k: v for k, v in art.to_json().items() if k not in WALL_FIELDS}
    out["pass_stats"] = [{k: v for k, v in row.items() if k != "wall_s"}
                         for row in out["pass_stats"] or []]
    return out


#: the entry points a ``--count-worker`` process runs, by module
COUNT_ENTRIES = {"repro_torch": "repro_torch.compiler.cli",
                 "repro_torch.core.collect": "repro_torch.core.collect"}
#: names the directory where each runner worker of a ``--count-worker``
#: process writes its launch counts as it exits
WORKER_COUNTS_VAR = "CHIP_SMOKE_WORKER_COUNTS"


class _WorkerCounts:
    """The launch counts of one runner worker process (a cell of the
    sweep, a compile of the farm): set to 0 as the worker starts, written
    to ``$CHIP_SMOKE_WORKER_COUNTS/<pid>.json`` as it exits (a worker that
    crashes or is killed writes nothing)."""

    def start(self):
        from multiprocessing import util

        reset_counts()
        util.Finalize(None, self.dump, exitpriority=10)

    def dump(self):
        path = os.path.join(os.environ[WORKER_COUNTS_VAR],
                            f"{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(read_counts(), f)


if __name__ == "__mp_main__" and os.environ.get(WORKER_COUNTS_VAR):
    # imported as the main module of a runner's forkserver (or of a spawned
    # worker) under a --count-worker process: multiprocessing runs
    # _WorkerCounts.start in each worker process it starts from here
    import multiprocessing.util

    _WORKER_COUNTS = _WorkerCounts()
    multiprocessing.util.register_after_fork(_WORKER_COUNTS,
                                             _WorkerCounts.start)


def count_worker(counts_path: str, entry: str, argv) -> int:
    """``chip_smoke.py --count-worker COUNTS ENTRY -- ARGS``: one ``python
    -m ENTRY ARGS`` (its ``main``, in this process so that its launch
    counters can be read), with the counters set to 0 just before it; just
    after, ``COUNTS`` gets this process's counts (``process``) and the sum
    of its runner workers' (``workers``, each worker counting its own: a
    CUDA context does not cross processes), as JSON."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "src"))
    workers = f"{counts_path}.workers"
    os.makedirs(workers)
    os.environ[WORKER_COUNTS_VAR] = workers
    entry_main = importlib.import_module(COUNT_ENTRIES[entry]).main
    reset_counts()
    rc = entry_main(argv)
    own = read_counts()
    out = {"process": own, "workers": dict.fromkeys(own, 0),
           "worker_processes": 0}
    for fn in os.listdir(workers):
        with open(os.path.join(workers, fn)) as f:
            for name, n in json.load(f).items():
                out["workers"][name] += n
        out["worker_processes"] += 1
    shutil.rmtree(workers)
    with open(counts_path, "w") as f:
        json.dump(out, f)
    return rc


def _counted(counts) -> dict:
    """A ``count_worker`` file's launches, the process's and its
    workers' summed."""
    return {name: n + counts["workers"][name]
            for name, n in counts["process"].items()}


def _count_cmd(counts_path: str, entry: str, argv):
    """The command line of one ``count_worker`` process."""
    return [sys.executable, os.path.abspath(__file__), "--count-worker",
            counts_path, entry, "--", *argv]


def golden_diff(path: str) -> str:
    """``python -m repro_torch diff --golden tests/golden_ii_quick.json
    PATH`` (artifacts or a collect results file): its summary line, which
    must count 0 regressed."""
    from repro_torch.compiler.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["diff", "--golden",
                       os.path.join(ROOT, "tests", "golden_ii_quick.json"),
                       path])
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("ii-diff:")]
    require(rc == 0 and len(line) == 1 and " 0 regressed" in line[0],
            f"diff --golden {path} exited {rc}:\n{buf.getvalue()[-3000:]}")
    return line[0]


def _run_counted(tmp: str, tag: str, entry: str, argv, env, timeout: float):
    """One ``count_worker`` process to its end: (process, its launches
    summed over the process and its workers, the raw counts, seconds)."""
    counts = os.path.join(tmp, f"{tag}.counts.json")
    t0 = time.perf_counter()
    proc = subprocess.run(_count_cmd(counts, entry, argv), env=env,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    raw = None
    if os.path.exists(counts):
        with open(counts) as f:
            raw = json.load(f)
    return proc, (None if raw is None else _counted(raw)), raw, secs


def compile_phase(device: str = "cuda", names=None):
    """The compiler on the card: ``python -m repro_torch compile W -u U
    --all-jobs --verify --device DEVICE --store STORE --out-dir D`` for every
    TABLE2 workload (``names``: a subset), ``COMPILE_WORKERS`` processes at
    a time into one store, ``REPRO_QUICK`` unset, seed 0, full budgets.
    Every artifact must equal the corpus file of its name (the JAX
    package's compile of the same cell) in everything but wall time, and
    its verdict the manifest's; ``sim_loop`` launches once per compile that
    holds a lowered mapping and nothing else launches; ``diff --golden
    tests/golden_ii_quick.json D`` has 0 regressed; ``store get`` of every
    key, with place & route patched to fail: each proven cell hits and
    serves the artifact its compile wrote, each other cell misses (a
    verifying compile stores only what it proved); ``store warm --quick``
    twice: the first compiles (unverified) the quick cells that hold no
    proven mapping and finds the rest, the second compiles nothing.  On the
    card, one cell compiled on the CPU equals its compile on the card, and
    a traced compile gives the device's busy share.  Returns the phase's
    ``sim_loop`` launches."""
    import shutil
    import tempfile

    from repro_torch import CORPUS_DIR
    from repro_torch.compiler.artifact import CompileResult
    from repro_torch.compiler.cli import main as cli_main
    from repro_torch.compiler.pipeline import job_grid
    from repro_torch.core.spatial import SpatialPipelineMapper
    from repro_torch.core.workloads import TABLE2, quick_workloads
    from repro_torch.mapping.mappers import PipelineMapper

    # the corpus is a full-budget compile: so must this be, in every process
    os.environ.pop("REPRO_QUICK", None)
    with open(os.path.join(CORPUS_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    grid = job_grid()
    require(grid == {j: tuple(am) for j, am in manifest["jobs"].items()},
            f"job_grid() {grid} differs from the manifest's "
            f"{manifest['jobs']}")
    table = [w for w in TABLE2 if names is None or w.name in names]
    corpus = {}
    for w in table:
        for job in grid:
            fn = f"{w.name}_u{w.unroll}__{job}.json"
            corpus[fn] = CompileResult.load(os.path.join(CORPUS_DIR, fn))
    # longest first by the corpus's own compile times, to balance the pool
    cost = {w: sum(corpus[f"{w.name}_u{w.unroll}__{job}.json"]
                   .timings["total"] for job in grid) for w in table}
    table.sort(key=lambda w: -cost[w])
    tmp = tempfile.mkdtemp(prefix="repro_compile_")
    try:
        store = os.path.join(tmp, "store")
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

        def run(w):
            argv = ["compile", w.name, "-u", str(w.unroll), "--all-jobs",
                    "--verify", "--device", device, "--store", store,
                    "--out-dir", out_dir]
            proc, counted, _, secs = _run_counted(
                tmp, f"{w.name}_u{w.unroll}", "repro_torch", argv, env, 600)
            return w, argv, proc, counted, secs

        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(COMPILE_WORKERS) as pool:
            runs = list(pool.map(run, table))
        wall = time.perf_counter() - t0
        parent = read_counts()
        require(not any(parent.values()),
                f"the parent process launched {parent} during the CLI runs")
        launched = dict.fromkeys(parent, 0)
        for w, argv, proc, counted, secs in runs:
            key = f"{w.name}_u{w.unroll}"
            want_rc = int(any(corpus[f"{key}__{job}.json"].verified is False
                              for job in grid))
            require(proc.returncode == want_rc and counted is not None,
                    f"python -m repro_torch {' '.join(argv)} exited "
                    f"{proc.returncode}, want {want_rc} (1 where a cell of "
                    f"the corpus is unverified); stdout ends:\n"
                    f"{proc.stdout[-2000:]}\nstderr ends:\n"
                    f"{proc.stderr[-3000:]}")
            for name, n in counted.items():
                launched[name] += n

        got = {}
        for fn, want in corpus.items():
            art = CompileResult.load(os.path.join(out_dir, fn))
            got[fn] = art
            require(_mapping_fields(art) == _mapping_fields(want),
                    f"{fn}: the port's compile differs from the corpus in "
                    + ", ".join(k for k, v in _mapping_fields(art).items()
                                if v != _mapping_fields(want)[k]))
            verdict = manifest["files"][fn]["verdict"]
            require(verdict == ("OK" if art.verified else "SKIP")
                    and (verdict == "SKIP") == (not art.mappings),
                    f"{fn}: verified {art.verified} with "
                    f"{len(art.mappings)} mapping(s); the manifest says "
                    f"{verdict}")
        forms = [fj for a in got.values() if a.compiled_sim
                 for fj in a.compiled_sim["forms"]]
        require(None not in forms,
                "a mapping was not lowered: its verification ran on the "
                "scalar oracle")
        verifying = sum(1 for a in got.values() if a.mappings)
        # the CPU runs the plain loop: no kernel launches there
        want = {**dict.fromkeys(launched, 0),
                "sim_loop": verifying if device == "cuda" else 0}
        require(launched == want,
                f"the compiles launched {launched}, want {want} (sim_loop "
                "once a verifying compile that holds mappings, nothing "
                "else)")

        golden = golden_diff(out_dir)

        # every key from the store, with no place & route and no launch
        def no_pnr(self, dfg):
            raise AssertionError("store get ran place & route")

        reset_counts()
        served = os.path.join(tmp, "served.json")
        hits = 0
        t0 = time.perf_counter()
        with _patched(PipelineMapper, "map", no_pnr), \
                _patched(SpatialPipelineMapper, "map", no_pnr):
            for fn, art in got.items():
                key, job = fn[:-len(".json")].split("__")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli_main(["store", "get", art.workload["name"],
                                   "-u", str(art.workload["unroll"]),
                                   "--job", job, "--dir", store,
                                   "--out", served])
                if not art.verified:
                    # nothing proven enters the store: a miss
                    require(rc == 1, f"store get {fn} (verified "
                            f"{art.verified}) exited {rc}, want a miss")
                    continue
                hits += 1
                require(rc == 0 and buf.getvalue().startswith("HIT"),
                        f"store get {fn} exited {rc}: {buf.getvalue()}")
                require(CompileResult.load(served).to_json()
                        == art.to_json(),
                        f"store get {fn} served another artifact")
        get_s = time.perf_counter() - t0
        gets = read_counts()
        require(not any(gets.values()),
                f"store get (verify policy never) launched {gets}")

        warm = []
        if names is None:
            # the quick cells that hold no proven mapping were never stored
            # by the verifying compiles: the first warm compiles those (no
            # verify) and finds the rest; the second compiles nothing
            quick = {f"{w.name}_u{w.unroll}__{job}.json"
                     for w in quick_workloads() for job in grid}
            unproven = sum(1 for fn in quick if not got[fn].verified)
            for puts in (unproven, 0):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(["store", "warm", "--quick", "--dir",
                                   store])
                warm.append(buf.getvalue().splitlines()[-1])
                want_line = (f"warm done: {puts} compiled+stored, "
                             f"{len(quick) - puts} already present")
                require(rc == 0 and warm[-1].startswith(want_line),
                        f"store warm --quick exited {rc}: {warm[-1]}, want "
                        f"{want_line}")

        totals = {fn: a.timings["total"] for fn, a in got.items()}
        slow = max(totals, key=totals.get)
        verify_s = sum(a.timings["verify"] for a in got.values())
        # each process's first verifying compile also sets up its CUDA
        # context (the grid's job order is each process's compile order)
        first, rest = [], []
        for w in table:
            arts = [got[f"{w.name}_u{w.unroll}__{job}.json"] for job in grid]
            secs = [a.timings["verify"] for a in arts if a.mappings]
            first += secs[:1]
            rest += secs[1:]
        cpus = len(os.sched_getaffinity(0))
        print(f"compile: {len(got)} cells ({len(table)} workloads x "
              f"{len(grid)} jobs) through python -m repro_torch compile "
              f"--all-jobs --verify --device {device} --store, "
              f"{COMPILE_WORKERS} processes at a time on {cpus} CPUs "
              f"(os.cpu_count() {os.cpu_count()}): every artifact = the "
              f"corpus's in mappings, ii, cycles, makespan, spatial, motifs, "
              f"pass and route-cache counters, compiled_sim and verified; "
              f"verdicts = the manifest's; launches {launched} (sim_loop = "
              f"{verifying} compiles with mappings); {golden}")
        print(f"compile: seconds a cell (timings.total, measured in the "
              f"workers) p50 {_pct(list(totals.values()), 50):.3f} p99 "
              f"{_pct(list(totals.values()), 99):.3f} sum "
              f"{sum(totals.values()):.3f}, slowest {slow} "
              f"{totals[slow]:.3f}; verify {verify_s:.3f} s = "
              f"{100 * verify_s / sum(totals.values()):.3f}% of the sum: "
              f"{sum(first):.3f} s in the {len(first)} first verifying "
              f"compiles of a process (p50 {_pct(first, 50):.3f} s, the "
              f"CUDA context's set-up with it), {sum(rest):.3f} s in the "
              f"other {len(rest)} (p50 {1e3 * _pct(rest, 50):.3f} ms, p99 "
              f"{1e3 * _pct(rest, 99):.3f} ms); "
              f"phase wall {wall:.3f} s; process wall a workload p50 "
              f"{_pct([r[4] for r in runs], 50):.3f} max "
              f"{max(r[4] for r in runs):.3f} s")
        print(f"compile: store get of {len(got)} keys: {hits} hits (every "
              f"verified artifact, served as compiled), {len(got) - hits} "
              f"misses (the unverified, never stored), no place & route, no "
              f"launch, {get_s:.3f} s in all; store warm --quick twice: "
              + (" / ".join(warm) or "not run on a subset"))
        if device == "cuda":
            compile_card_vs_cpu(grid)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launched["sim_loop"]


def compile_card_vs_cpu(grid) -> None:
    """One cell (atax_u2 on the spatial job: six segments, one bucket)
    compiled with ``verify=True`` on the CPU and on the card: the same
    artifact but for wall time, one ``sim_loop`` launch; then the same
    compile traced (the second of two traces): the device's busy share and
    sim_loop's device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compiler.pipeline import compile as port_compile

    arch, mapper = grid["spatial"]
    cell = dict(unroll=2, arch=arch, mapper=mapper, seed=0, verify=True)
    cpu = port_compile("atax", device="cpu", **cell)
    reset_counts()
    card = port_compile("atax", device="cuda", **cell)
    counts = read_counts()
    require(counts == {**dict.fromkeys(counts, 0), "sim_loop": 1},
            f"a compile on the card launched {counts}, want sim_loop once")
    require(card.verified and _mapping_fields(card) == _mapping_fields(cpu),
            "atax_u2 spatial: the card's compile differs from the CPU's")
    # the profiler's first window in a process also pays its own set-up:
    # the second traced compile is the one read
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = port_compile("atax", device="cuda", **cell)
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    loop = [e for e in dev if "sim_loop" in e.key]
    n = sum(e.count for e in loop)
    if busy_ms == 0 or n == 0:
        busy = "not measured (no device time in the trace)"
    else:
        loop_ms = sum(e.self_device_time_total for e in loop) / 1e3 / n
        busy = (f"sim_loop {loop_ms:.6f} ms device time a launch ({n} "
                f"launch), device busy {busy_ms:.6f} ms of the traced "
                f"compile's {traced_ms:.3f} ms wall "
                f"({100 * busy_ms / traced_ms:.4f}% busy; timings.total "
                f"{1e3 * traced.timings['total']:.3f} ms, verify "
                f"{1e3 * traced.timings['verify']:.3f} ms)")
    print(f"compile: atax_u2 spatial ({len(card.mappings)} segments) on the "
          f"card = on the CPU but for wall time, 1 sim_loop launch; traced "
          f"compile: {busy}")


#: the ``collect`` phase's worker processes (the card machine's cores)
COLLECT_JOBS = 8
#: what a sweep's record holds beyond the JAX package's results file: wall
#: time, and the store's hits and misses when the sweep runs on a store
RECORD_RUN_FIELDS = ("wall_s", "store")
#: the chaos run's per-cell timeout: the hung cell's wall, and far above
#: an atax_u2 cell's seconds
CHAOS_CELL_TIMEOUT_S = 10.0
#: the chaos plan (``REPRO_FAULTS``): atax_u2's plaid cell crashes on its
#: first two attempts, its st cell hangs past the per-cell timeout
CHAOS_FAULTS = (
    {"mode": "crash", "site": "worker", "match": "atax_u2/plaid",
     "attempts": [0, 1]},
    {"mode": "hang", "site": "worker", "match": "atax_u2/st",
     "seconds": 120},
)


def _record_fields(rec) -> dict:
    """A sweep record less what records the run (``RECORD_RUN_FIELDS``)."""
    return {k: v for k, v in rec.items() if k not in RECORD_RUN_FIELDS}


def _require_rc(proc, want: int, what: str) -> None:
    require(proc.returncode == want,
            f"{what} exited {proc.returncode}, want {want}; stdout ends:\n"
            f"{proc.stdout[-3000:]}\nstderr ends:\n{proc.stderr[-3000:]}")


def collect_phase(device: str = "cuda", workloads=None):
    """The paper's sweep on the card: ``python -m repro_torch.core.collect
    --out T/results.json --bench-out T/bench.json --store T/store --jobs 8
    --batch-verify --device DEVICE --strict`` (``workloads``: a subset of
    TABLE2 keys, for a rehearsal on the CPU), 30 workloads x 8 jobs at seed
    0, full budgets, ``REPRO_QUICK`` unset, each cell in a worker started
    from the runner's forkserver, in a process of its own that counts its
    launches and its workers'.  Every record equals the JAX package's
    ``experiments/cgra/results.json`` in every field but wall time and the
    store's counts (0 hits, 7 misses a workload); ``diff --golden
    tests/golden_ii_quick.json`` 0 regressed; the bench entry's store 0 /
    210 and its batch verify of every stored mapping without a failure;
    ``sim_loop`` once a verifying cell (plaid, st) and once a bucket of the
    batch verify, nothing else.  A second run on the same ``--out`` runs
    nothing.  A chaos run of atax_u2 under ``REPRO_FAULTS``
    (``CHAOS_FAULTS``) records a ``WorkerCrashed`` (2 attempts, exit 137)
    and a ``CompileTimeout`` (1 attempt) and exits 1 under ``--strict``;
    a clean re-run heals the record to the results file's.  Returns
    (``sim_loop`` launches of the sweep, the temp directory, which holds
    the store and the results for the farm phase, and the results)."""
    import tempfile

    from repro_torch.compiler.store import ArtifactStore
    from repro_torch.core.collect import job_names
    from repro_torch.core.workloads import TABLE2

    os.environ.pop("REPRO_QUICK", None)
    with open(os.path.join(ROOT, "experiments", "cgra", "results.json")) as f:
        reference = json.load(f)
    keys = [f"{w.name}_u{w.unroll}" for w in TABLE2
            if workloads is None or f"{w.name}_u{w.unroll}" in workloads]
    names = job_names()
    n_cells = len(keys) * (len(names) - 1)  # the motif job compiles nothing
    tmp = tempfile.mkdtemp(prefix="repro_collect_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_FAULTS", None)
    out = os.path.join(tmp, "results.json")
    bench = os.path.join(tmp, "bench.json")
    store = os.path.join(tmp, "store")
    argv = ["--out", out, "--bench-out", bench, "--store", store, "--jobs",
            str(COLLECT_JOBS), "--batch-verify", "--device", device,
            "--strict"]
    if workloads is not None:
        argv += ["--workloads", ",".join(keys)]

    reset_counts()
    proc, launched, raw, wall = _run_counted(tmp, "sweep",
                                             "repro_torch.core.collect",
                                             argv, env, 900)
    _require_rc(proc, 0, "the collect sweep")
    parent = read_counts()
    require(not any(parent.values()),
            f"chip_smoke's own process launched {parent} during the sweep")
    with open(out) as f:
        results = json.load(f)
    require(sorted(results) == sorted(keys),
            f"the sweep recorded {sorted(results)}, want {keys}")
    for key in keys:
        rec = results[key]
        require(_record_fields(rec) == _record_fields(reference[key]),
                f"{key}: the sweep's record differs from the JAX package's "
                "results file in "
                + ", ".join(k for k in set(rec) | set(reference[key])
                            if k not in RECORD_RUN_FIELDS
                            and rec.get(k) != reference[key].get(k)))
        require(rec["store"] == {"hits": 0, "misses": len(names) - 1},
                f"{key}: store {rec['store']} in a cold sweep")
    # the golden file names every quick workload: a subset misses some
    golden = (golden_diff(out) if workloads is None
              else "ii-diff: not run on a subset")
    with open(bench) as f:
        runs = json.load(f)["runs"]
    entry = runs[-1]
    require(len(runs) == 1 and entry["store"]["hits"] == 0
            and entry["store"]["misses"] == n_cells
            and "failed_cells" not in entry,
            f"the sweep's bench entry {entry}")
    sim = entry["sim_verify"]
    n_mappings = sum(len(a.mappings) for _, a in
                     ArtifactStore(store, device="cpu").iter_artifacts())
    require(sim["mappings"] == n_mappings and sim["failed"] == 0
            and sim["backend"] == device and sim["scalar_fallbacks"] == 0,
            f"the batch verify {sim}, want {n_mappings} mappings on "
            f"{device}, 0 failed")
    verifying = len(keys) * 2  # plaid and st
    want = {**dict.fromkeys(launched, 0),
            "sim_loop": (verifying + 1) if device == "cuda" else 0}
    want_workers = {**dict.fromkeys(launched, 0),
                    "sim_loop": verifying if device == "cuda" else 0}
    require(launched == want and raw["workers"] == want_workers,
            f"the sweep launched {raw}, want {want} in all, "
            f"{want_workers} in the workers (sim_loop once a verifying "
            f"cell, once a bucket of the batch verify, nothing else)")
    arts = dict(ArtifactStore(store, device="cpu").iter_artifacts())
    cells = {key.describe(): art.timings["total"]
             for key, art in arts.items()}
    verify_s = [art.timings["verify"] for art in arts.values()
                if art.verified is not None]
    slow = max(cells, key=cells.get)
    print(f"collect: {len(keys)} workloads x {len(names)} jobs through "
          f"python -m repro_torch.core.collect --store --jobs "
          f"{COLLECT_JOBS} --batch-verify --device {device} --strict, each "
          f"cell a worker "
          f"{'from the runner forkserver' if device == 'cuda' else 'forked'}"
          f": every record = "
          f"experiments/cgra/results.json but for wall_s and store "
          f"(0 hits, {len(names) - 1} misses a workload); {golden}; bench "
          f"store {entry['store']['hits']} hits / {entry['store']['misses']} "
          f"misses; batch verify {sim['mappings']} mappings, {sim['failed']} "
          f"failed, {sim['mappings_per_s']} mappings/s; launches {launched} "
          f"({raw['workers']['sim_loop']} in {raw['worker_processes']} "
          f"worker processes, {raw['process']['sim_loop']} in the batch "
          f"verify)")
    print(f"collect: sweep wall {wall:.3f} s (the process; bench entry "
          f"wall_s {entry['wall_s']}), {len(keys) * len(names) / wall:.3f} "
          f"cells/s; cell seconds (timings.total of the {len(cells)} "
          f"compiled cells, from the store) sum {sum(cells.values()):.3f}, "
          f"p50 {_pct(list(cells.values()), 50):.3f}, p99 "
          f"{_pct(list(cells.values()), 99):.3f}, slowest {slow} "
          f"{cells[slow]:.3f}; records' cpu_s {entry['cpu_s']}; verify "
          f"{sum(verify_s):.3f} s in the {len(verify_s)} verifying cells "
          f"(p50 {_pct(verify_s, 50):.3f} s"
          f"{', each with its process CUDA start' if device == 'cuda' else ''}"
          f") = {100 * sum(verify_s) / sum(cells.values()):.3f}% of the cell "
          f"seconds")

    # a second run on the same --out: nothing to do, nothing appended
    with open(out, "rb") as f:
        before = f.read()
    proc, again, _, secs = _run_counted(tmp, "resume",
                                        "repro_torch.core.collect", argv,
                                        env, 300)
    _require_rc(proc, 0, "the collect re-run")
    with open(out, "rb") as f, open(bench) as g:
        require(f.read() == before and len(json.load(g)["runs"]) == 1
                and not any(again.values()),
                f"a re-run on the same --out changed the results or the "
                f"bench, or launched {again}")

    # chaos: a crashed and a hung cell become records; a re-run heals them
    chaos = os.path.join(tmp, "chaos.json")
    cargs = ["--out", chaos, "--workloads", "atax_u2", "--jobs",
             str(COLLECT_JOBS), "--cell-timeout", str(CHAOS_CELL_TIMEOUT_S),
             "--retries", "1", "--device", device, "--strict"]
    proc, _, _, chaos_s = _run_counted(
        tmp, "chaos", "repro_torch.core.collect", cargs,
        dict(env, REPRO_FAULTS=json.dumps(list(CHAOS_FAULTS))), 300)
    _require_rc(proc, 1, "the chaos run (--strict, two failed cells)")
    with open(chaos) as f:
        rec = json.load(f)["atax_u2"]
    crash, hang = rec["failures"]["plaid"], rec["failures"]["st"]
    require(crash["error"] == "WorkerCrashed" and crash["attempts"] == 2
            and crash["exitcode"] == 137 and hang["error"] == "CompileTimeout"
            and hang["attempts"] == 1 and rec["ii"]["plaid"] is None
            and rec["ii"]["st"] is None
            and sorted(rec["partial_parts"]) == sorted(
                j for j in names if j not in ("plaid", "st")),
            f"the chaos run recorded {rec.get('failures')}")
    proc, healed_launches, _, heal_s = _run_counted(
        tmp, "heal", "repro_torch.core.collect", cargs, env, 300)
    _require_rc(proc, 0, "the healing re-run")
    with open(chaos) as f:
        healed = json.load(f)["atax_u2"]
    require(_record_fields(healed) == _record_fields(reference["atax_u2"])
            and "store" not in healed,
            f"the healed atax_u2 record differs from the results file's: "
            f"{healed}")
    want_heal = {**dict.fromkeys(healed_launches, 0),
                 "sim_loop": 2 if device == "cuda" else 0}
    require(healed_launches == want_heal,
            f"the healing run launched {healed_launches}, want {want_heal} "
            f"(the two failed cells verify again, nothing else runs)")
    print(f"collect: re-run on the same --out {secs:.3f} s, nothing run or "
          f"appended; chaos (atax_u2 under REPRO_FAULTS: plaid crashed at "
          f"attempts 0 and 1, st hung past --cell-timeout "
          f"{CHAOS_CELL_TIMEOUT_S}) {chaos_s:.3f} s: WorkerCrashed "
          f"(2 attempts, exit 137) and CompileTimeout (1 attempt) recorded, "
          f"exit 1 under --strict; the clean re-run {heal_s:.3f} s healed "
          f"the record to the results file's, re-running the 2 failed "
          f"cells only ({healed_launches['sim_loop']} sim_loop launches)")
    return launched["sim_loop"], tmp, results


#: the farm phase's compile workers (``serve --workers``)
FARM_WORKERS = 4


def _start_farm(tmp: str, tag: str, store: str, sock: str, device: str,
                env):
    """A ``python -m repro_torch serve`` daemon in a ``count_worker``
    process, once it answers a ping: (process, counts path, log path)."""
    from repro_torch.serve_farm.client import farm_ping

    counts = os.path.join(tmp, f"{tag}.counts.json")
    log = os.path.join(tmp, f"{tag}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            _count_cmd(counts, "repro_torch",
                       ["serve", "--dir", store, "--socket", sock,
                        "--device", device, "--workers",
                        str(FARM_WORKERS)]),
            env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 120
    while not farm_ping(sock, timeout_s=2.0):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            proc.wait()
            with open(log) as f:
                require(False, f"the farm daemon did not come up; its log "
                        f"ends:\n{f.read()[-3000:]}")
        time.sleep(0.2)
    return proc, counts, log


def _stop_farm(proc, counts: str, log: str):
    """SIGTERM, the drain, exit 0: the daemon's counts and log."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    with open(log) as f:
        text = f.read()
    require(rc == 0 and "drained; journal compacted" in text,
            f"the farm daemon exited {rc} on SIGTERM; its log ends:\n"
            f"{text[-3000:]}")
    with open(counts) as f:
        return json.load(f), text


def farm_phase(tmp: str, results, device: str = "cuda"):
    """The compile farm on the card, over the collect phase's store:
    ``python -m repro_torch serve --dir T/store --socket S --device DEVICE
    --workers 4`` (a process that counts its launches and its workers').
    (1) ``collect --remote S`` with no store: every record equals the cold
    sweep's but for wall time and the store's counts (7 hits a workload),
    and the daemon compiled nothing (``hits`` = the cells, ``compiles`` 0);
    (2) ``compile atax -u 2 --job node_on_plaid --remote S --verify``, a
    cell the store holds unverified: served warm, proven inside the
    daemon; (3) then, with the daemon holding a CUDA context, a cold
    verifying remote compile of a key the store lacks (atax_u2 plaid, seed
    1): a worker compiles it, verified, equal to the same compile on the
    CPU but for wall time; (4) a warm remote compile of every cell, ms at
    p50 and p99; (5) SIGTERM: drained, exit 0, the journal compacted to its
    header; a restart over a stale socket file serves the seed-1 artifact
    warm.  ``sim_loop``: once in the daemon (2), once in its worker (3),
    nothing else anywhere.  Returns the phase's ``sim_loop`` launches."""
    import socket

    from repro_torch.compiler.artifact import CompileResult
    from repro_torch.compiler.pipeline import compile as port_compile
    from repro_torch.compiler.pipeline import job_grid
    from repro_torch.core.collect import VERIFY_JOBS
    from repro_torch.serve_farm.client import farm_status, remote_compile

    store = os.path.join(tmp, "store")
    sock = os.path.join(tmp, "farm.sock")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_FAULTS", None)
    grid = job_grid()
    keys = sorted(results)
    daemon, counts, log = _start_farm(tmp, "farm", store, sock, device, env)
    try:
        # (1) the whole sweep served warm
        remote = os.path.join(tmp, "remote.json")
        rbench = os.path.join(tmp, "remote_bench.json")
        argv = ["--out", remote, "--bench-out", rbench, "--remote", sock,
                "--jobs", str(COLLECT_JOBS), "--device", device, "--strict"]
        if len(keys) < 30:
            argv += ["--workloads", ",".join(keys)]
        proc, launched, _, wall = _run_counted(
            tmp, "remote", "repro_torch.core.collect", argv, env, 600)
        _require_rc(proc, 0, "collect --remote")
        with open(remote) as f:
            served = json.load(f)
        for key in keys:
            require(_record_fields(served[key]) == _record_fields(results[key])
                    and served[key]["store"] == {
                        "hits": results[key]["store"]["misses"],
                        "misses": 0},
                    f"{key}: the farm's record differs from the cold "
                    f"sweep's: {served[key]}")
        status = farm_status(sock)["counters"]
        n_cells = len(keys) * len(grid)
        require(status["compiles"] == 0 and status["hits"] == n_cells
                and status["failures"] == 0 and status["shed"] == 0
                and not any(launched.values()),
                f"the farm's counters after the remote sweep {status}, want "
                f"{n_cells} hits and no compile; the sweep launched "
                f"{launched}")
        with open(rbench) as f:
            farm = json.load(f)["runs"][-1]["farm"]
        # (2) an unverified cell, proven warm inside the daemon
        arch, mapper = grid["node_on_plaid"]
        proven = os.path.join(tmp, "proven.json")
        proc, launched2, _, _ = _run_counted(
            tmp, "proven", "repro_torch",
            ["compile", "atax", "-u", "2", "--arch", arch, "--mapper",
             mapper, "--remote", sock, "--verify", "--device", device,
             "--out", proven], env, 300)
        _require_rc(proc, 0, "compile --remote --verify (warm)")
        art = CompileResult.load(proven)
        status = farm_status(sock)["counters"]
        require("[store hit]" in proc.stdout and art.verified is True
                and status["hits"] == n_cells + 1
                and status["compiles"] == 0 and not any(launched2.values()),
                f"the unverified node_on_plaid cell: {proc.stdout.strip()}, "
                f"verified {art.verified}, counters {status}, client "
                f"launches {launched2}")
        # (3) cold, verifying, after the daemon touched the card: the
        # client from this process (it sends sockets, launches nothing)
        arch, mapper = grid["plaid"]
        t0 = time.perf_counter()
        art = remote_compile(sock, workload="atax", unroll=2, arch=arch,
                             mapper=mapper, seed=1, verify=True)
        cold_s = time.perf_counter() - t0
        cpu = port_compile("atax", unroll=2, arch=arch, mapper=mapper,
                           seed=1, verify=True, device="cpu")
        status = farm_status(sock)["counters"]
        require(art.store_hit is False and art.verified is True
                and _mapping_fields(art) == _mapping_fields(cpu)
                and status["compiles"] == 1 and status["failures"] == 0,
                f"the cold remote compile: hit {art.store_hit}, verified "
                f"{art.verified}, equal to the CPU's "
                f"{_mapping_fields(art) == _mapping_fields(cpu)}, counters "
                f"{status}")
        # (4) warm remote compiles, one a cell, timed from this process
        ms = []
        for key in keys:
            name, unroll = key.rsplit("_u", 1)
            for job, (arch, mapper) in grid.items():
                t0 = time.perf_counter()
                got = remote_compile(sock, workload=name, unroll=int(unroll),
                                     arch=arch, mapper=mapper,
                                     verify=job in VERIFY_JOBS)
                ms.append(1e3 * (time.perf_counter() - t0))
                require(got.store_hit is True, f"{key}/{job} missed")
        status = farm_status(sock)["counters"]
    except BaseException:
        daemon.kill()
        daemon.wait()
        raise
    # (5) the drain, and a restart over a stale socket
    journal = os.path.join(store, "journal.jsonl")
    farm_counts, _ = _stop_farm(daemon, counts, log)
    with open(journal) as f:
        lines = f.read().splitlines()
    require(len(lines) == 1 and not os.path.exists(sock),
            f"after the drain the journal holds {len(lines)} lines (want "
            f"its header alone) and the socket exists: "
            f"{os.path.exists(sock)}")
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(sock)
    stale.close()  # the file stays: what a kill -9 leaves behind
    daemon, counts2, log2 = _start_farm(tmp, "restart", store, sock, device,
                                        env)
    try:
        arch, mapper = grid["plaid"]
        again = remote_compile(sock, workload="atax", unroll=2, arch=arch,
                               mapper=mapper, seed=1, verify=True)
    except BaseException:
        daemon.kill()
        daemon.wait()
        raise
    restart_counts, _ = _stop_farm(daemon, counts2, log2)
    require(again.store_hit is True and again.mappings == art.mappings
            and not any(_counted(restart_counts).values()),
            f"the restarted farm: hit {again.store_hit}, same mapping "
            f"{again.mappings == art.mappings}, launches {restart_counts}")
    launched = _counted(farm_counts)
    want = {**dict.fromkeys(launched, 0),
            "sim_loop": 2 if device == "cuda" else 0}
    require(launched == want, f"the farm launched {farm_counts}, want "
            f"{want}: once proving the warm hit, once in the cold compile's "
            f"worker")
    print(f"farm: python -m repro_torch serve --device {device} --workers "
          f"{FARM_WORKERS} over the sweep's store: collect --remote "
          f"{wall:.3f} s, {n_cells} cells served warm, every record = the "
          f"cold sweep's, daemon hits {n_cells} compiles 0, "
          f"farm.served_per_s {farm['served_per_s']} (served "
          f"{farm['served']}); an unverified cell proven warm in the daemon; "
          f"a cold verifying remote compile (atax_u2 plaid seed 1) after the "
          f"daemon's launch: {cold_s:.3f} s, verified, = the CPU's compile; "
          f"launches {launched} (daemon {farm_counts['process']['sim_loop']}"
          f", its workers {farm_counts['workers']['sim_loop']} in "
          f"{farm_counts['worker_processes']} worker processes)")
    print(f"farm: warm remote compile ms (this process, {len(ms)} cells) "
          f"p50 {_pct(ms, 50):.3f} p99 {_pct(ms, 99):.3f}; counters "
          f"{status}; SIGTERM drained, exit 0, journal compacted to its "
          f"header; restarted over a stale socket file: the seed-1 artifact "
          f"served warm, no launch")
    return launched["sim_loop"]


def _randn(shape, dtype, seed: int, scale=1.0):
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(
        np.float32)).to(device="cuda", dtype=dtype)


def _close(name: str, got, want, tol):
    """Hold ``got`` against ``want`` under ``tol``; returns the largest
    absolute difference and the largest share of the tolerance used."""
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    share = (diff / limit).max().item()
    require(share <= 1.0 and bool(torch.isfinite(got).all()),
            f"{name}: {int((diff > limit).sum())} of {diff.numel()} elements "
            f"outside rtol {tol['rtol']} atol {tol['atol']} (max abs diff "
            f"{diff.max().item()}, {share:.3f} of the tolerance)")
    return diff.max().item(), share


def device_ms(fn, iters: int, expect=()):
    """Mean device time in ms of the CUDA kernels ``fn()`` launches, over
    ``iters`` calls (``torch.profiler``; the host's dispatch is left out,
    unlike :func:`cuda_ms`), from the first of five traces that is whole:
    each of its kernels launched a multiple of ``iters`` times, and each
    name of ``expect`` among them.  The profiler can drop the first
    kernels of a window, and those at its end: each trace waits 50 ms on
    the host once it has started, then opens with eight short spin kernels
    and closes with one of about a millisecond, all left out of the sum.
    None when no trace is whole (a partial sum would understate the time:
    not measured), after a ``device_ms:`` line with the last trace's
    counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(8):
                torch.cuda._sleep(200_000)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        if (events and all(e.count % iters == 0 for e in events)
                and all(any(w in e.key for e in events) for w in expect)):
            return sum(e.self_device_time_total for e in events) / 1e3 / iters
    print(f"device_ms: no whole trace of {iters} calls in 5; the last held "
          f"{[(e.key[:48], e.count) for e in events] or 'no kernel'}")
    return None


def _device_txt(k_dev) -> str:
    if k_dev is None:
        return "device time not measured: no whole trace"
    return f"{k_dev:.6f} ms device time"


def _bound(n_bytes: float, ops: float, ops_rate: float):
    bounds = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / ops_rate * 1e3}
    by = max(bounds, key=bounds.get)
    return bounds[by], by


#: the serve path's kernel shapes of each served model: d_model, d_ff,
#: query heads over kv heads at batch 4, head dim
LM_SHAPES = {"llama3_2_3b": (3072, 8192, 96, 32, 128),
             "stablelm_12b": (5120, 13824, 128, 32, 160)}


def lm_kernel_cases():
    """(name, label, kernel call, plain call, library call or None, bytes,
    operations, operations rate, cuBLAS yardsticks as (label, call) pairs,
    fused_swiglu's route or None) at the serve path's shapes of each model
    of ``LM_SHAPES``, bfloat16: M = B*T = 2000 rows in prefill and 4 in
    decode, S = 500; llama3_2_3b first.  rmsnorm's rows have RMS from 0.1
    to 10, so a missing or misplaced normalization shows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_swiglu import (ROUTE_NAMES,
                                                  fused_swiglu_cuda, route)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    bf = torch.bfloat16
    cases = []
    for D, Ff, H, Hkv, d in LM_SHAPES.values():
        for M in (2000, 4):
            x = _randn((M, D), bf, 1, np.geomspace(0.1, 10.0, M)[:, None])
            s = _randn((D,), bf, 2)
            cases.append((
                "rmsnorm", f"({M},{D})", lambda x=x, s=s: rmsnorm_cuda(x, s),
                lambda x=x, s=s: ref.rmsnorm(x, s),
                lambda x=x, s=s, D=D: F.rms_norm(x, (D,), s, 1e-6),
                (2 * M * D + D) * 2, 4 * M * D, FP32_OPS_PER_S, (), None))
        for M in (2000, 4):
            x = _randn((M, D), bf, 3)
            w1, w3 = (_randn((D, Ff), bf, i, D ** -0.5) for i in (4, 5))
            w13 = torch.cat([w1, w3], dim=1)  # (D, 2F), yardstick only
            cases.append((
                "fused_swiglu", f"({M},{D})x({D},{Ff})",
                lambda x=x, w1=w1, w3=w3: fused_swiglu_cuda(x, w1, w3),
                lambda x=x, w1=w1, w3=w3: ref.fused_swiglu(x, w1, w3), None,
                (M * D + 2 * D * Ff + M * Ff) * 2,
                4 * M * D * Ff + 5 * M * Ff, BF16_OPS_PER_S,
                (("x @ w1", lambda x=x, w1=w1: x @ w1),
                 ("x @ [w1 | w3]", lambda x=x, w13=w13: x @ w13)),
                ROUTE_NAMES[route(M, D, Ff, bf)]))
        S, g = 500, H // Hkv
        q = _randn((H, S, d), bf, 6)
        k, v = (_randn((Hkv, S, d), bf, i) for i in (7, 8))
        pairs = H * S * (S + 1) // 2  # live (q, k) pairs of the causal band
        cases.append((
            "flash_attention", f"({H},{S},{d}) causal kv_group {g}",
            lambda q=q, k=k, v=v, g=g: flash_attention_cuda(
                q, k, v, causal=True, kv_group=g),
            lambda q=q, k=k, v=v, g=g: ref.flash_attention(
                q, k, v, causal=True, kv_group=g),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                enable_gqa=True)[0],
            (2 * H + 2 * Hkv) * S * d * 2, 4 * d * pairs, BF16_OPS_PER_S,
            (), None))
    return cases


def lm_kernel_phase():
    """The serve path's kernels against their plain versions on the card;
    returns each kernel's JSON record minus ``launches`` (times at the
    prefill shape; both shapes under ``at``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_swiglu import fused_swiglu_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    # tests/test_kernels.py's shapes, in both dtypes
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for M, D in [(128, 64), (256, 512), (64, 160)]:
            x, s = _randn((M, D), dt, 10), _randn((D,), dt, 11)
            _close(f"rmsnorm {dtype} ({M},{D})", rmsnorm_cuda(x, s),
                   ref.rmsnorm(x, s), TOL[dtype])
        for M, D, F in [(128, 128, 128), (256, 384, 128), (128, 256, 256)]:
            x = _randn((M, D), dt, 12)
            w1, w3 = _randn((D, F), dt, 13), _randn((D, F), dt, 14)
            _close(f"fused_swiglu {dtype} ({M},{D},{F})",
                   fused_swiglu_cuda(x, w1, w3), ref.fused_swiglu(x, w1, w3),
                   TOL[dtype])
        for H, S, d in [(2, 128, 64), (1, 256, 32), (2, 128, 160),
                        (1, 100, 256)]:
            q, k, v = (_randn((H, S, d), dt, i) for i in (15, 16, 17))
            for kw in (dict(causal=True), dict(causal=True, window=64),
                       dict(causal=False)):
                _close(f"flash_attention {dtype} ({H},{S},{d}) {kw}",
                       flash_attention_cuda(q, k, v, **kw),
                       ref.flash_attention(q, k, v, **kw), TOL[dtype])
        print(f"kernel rmsnorm, fused_swiglu, flash_attention {dtype}: equal "
              f"to plain on tests/test_kernels.py's shapes and the three "
              f"flash cases, with flash also at d = 160 and 256 (rtol "
              f"{TOL[dtype]['rtol']} atol {TOL[dtype]['atol']})")
    flash_tc_checks()
    swiglu_route_checks()

    records = {}
    for (name, label, kern, plain, lib, n_bytes, ops, rate, yardsticks,
         swiglu_route) in lm_kernel_cases():
        err, share = _close(f"{name} bfloat16 {label}", kern(), plain(),
                            PATH_TOL)
        # kernel and library call in turns, so both see the same card state;
        # each turn about 5 ms of calls (20 at least), so the host's jitter
        # averages out of the small shapes' dispatch-bound times
        reps = max(20, min(500, int(5.0 / cuda_ms(kern, 5))))
        k_turns, k_devs, l_turns, l_devs = [], [], [], []
        for _ in range(2):
            k_turns.append(cuda_ms(kern, reps))
            k_devs.append(device_ms(kern, 20))
            if lib is not None:
                l_turns.append(cuda_ms(lib, reps))
                l_devs.append(device_ms(lib, 20))
        k_ms, k_dev = _mean(k_turns), _mean(k_devs)
        l_ms = _mean(l_turns) if lib is not None else None
        p_ms = cuda_ms(plain, 5)
        bound, by = _bound(n_bytes, ops, rate)
        lib_txt = "none" if lib is None else (
            f"{l_ms:.6f} ms (turns {_turns_txt(l_turns)}; device "
            f"{_turns_txt(l_devs)})")
        share_txt = "" if k_dev is None else \
            f", {100 * bound / k_dev:.1f}% of the bound in device time"
        route_txt = "" if swiglu_route is None else f" route {swiglu_route}"
        print(f"kernel {name} {label} bf16{route_txt}: {k_ms:.6f} ms (turns "
              f"{_turns_txt(k_turns)}; {_device_txt(k_dev)}, turns "
              f"{_turns_txt(k_devs)}), plain {p_ms:.6f} ms, bound "
              f"{bound:.6f} ms ({by}){share_txt}, library {lib_txt}; max abs "
              f"err {err:.6g}, {share:.3f} of the tolerance (rtol "
              f"{PATH_TOL['rtol']} atol {PATH_TOL['atol']})")
        at = {"shape": label, "ms": k_ms, "device_ms": k_dev,
              "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
              "library_ms": l_ms, "max_abs_err": err}
        if swiglu_route is not None:
            at["route"] = swiglu_route
        if name not in records:
            records[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": LM_REPLACES[name], **{k: at[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}, "at": []}
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        records[name]["at"].append(at)
        for y_label, y_call in yardsticks:
            y_dev = device_ms(y_call, 20)
            at.setdefault("yardstick_device_ms", {})[y_label] = y_dev
            print(f"yardstick: one torch.matmul {y_label} at {label} bf16 "
                  f"{cuda_ms(y_call, 20):.6f} ms ({_device_txt(y_dev)}; "
                  f"cuBLAS, the port does not call it)")
    flash_long_prefill()
    dispatch_breakdown()
    return records


def swiglu_route_checks() -> None:
    """fused_swiglu against its plain version under ``TOL`` on each route,
    at ragged shapes: the stream route (M <= 16, both dtypes; F = 130 loads
    its rows element by element), the tensor-core route (bf16 past 16 rows,
    across 128-row and 128-column tiles and 64-deep K steps) and the SIMT
    route (float32 past 16 rows, bf16 at F = 130); one launch per call."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_swiglu import (ROUTE_NAMES,
                                                  fused_swiglu_cuda, route)

    worst = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for M in (1, 4, 16, 17, 100, 129, 300):
            for D in (72, 256, 1000):
                for F in (130, 136, 320, 520):
                    x = _randn((M, D), dt, M + D)
                    w1, w3 = (_randn((D, F), dt, F + i) for i in (1, 2))
                    name = ROUTE_NAMES[route(M, D, F, dt)]
                    before = fused_swiglu_cuda.launches
                    got = fused_swiglu_cuda(x, w1, w3)
                    require(fused_swiglu_cuda.launches == before + 1,
                            "fused_swiglu_cuda did not count its launch")
                    share = _close(f"fused_swiglu {dtype} ({M},{D},{F}) "
                                   f"route {name}", got,
                                   ref.fused_swiglu(x, w1, w3),
                                   TOL[dtype])[1]
                    n, w = worst.get((dtype, name), (0, 0.0))
                    worst[(dtype, name)] = (n + 1, max(w, share))
    for (dtype, name), (n, w) in sorted(worst.items()):
        print(f"kernel fused_swiglu {dtype} route {name}: {n} ragged shapes "
              f"(M 1-300, D 72/256/1000, F 130/136/320/520) equal to plain "
              f"within rtol {TOL[dtype]['rtol']} atol {TOL[dtype]['atol']} "
              f"({w:.3f} of it at most)")
    swiglu_misaligned_checks()


def _offset_view(shape, seed: int, scale=1.0):
    """A contiguous bf16 (M, N) tensor one element past a fresh allocation:
    its data pointer is 2 bytes past a 16-byte boundary."""
    import torch

    M, N = shape
    t = torch.empty(M * N + 1, dtype=torch.bfloat16, device="cuda")[1:]
    t = t.view(M, N)
    t.copy_(_randn(shape, torch.bfloat16, seed, scale))
    require(t.is_contiguous() and t.data_ptr() % 16 == 2,
            f"offset view at {t.data_ptr() % 16} bytes past 16")
    return t


def swiglu_misaligned_checks() -> None:
    """bf16 fused_swiglu on views that start 2 bytes past a 16-byte
    boundary, at the prefill shape (2000,3072)x(3072,8192), which the
    tensor-core route would take if aligned: x alone offset, then x, w1
    and w3; each takes the SIMT route and agrees with its plain version
    under ``TOL``.  The count of outputs that differ from the plain version
    and from a float64-summed reference is printed (bf16 products are
    exact in float32, so a kernel that sums in cuBLAS's k order may agree
    with it bit for bit), and the SIMT call is timed in turns with the
    aligned tensor-core call."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_swiglu import (ROUTE_NAMES, SIMT,
                                                  TENSOR_CORES,
                                                  fused_swiglu_cuda, route)

    M, D, F = 2000, 3072, 8192
    bf = torch.bfloat16
    require(route(M, D, F, bf) == TENSOR_CORES,
            "the aligned prefill shape does not take the tensor cores")
    aligned = (_randn((D, F), bf, 61, D ** -0.5),
               _randn((D, F), bf, 62, D ** -0.5))
    offset = (_offset_view((D, F), 61, D ** -0.5),
              _offset_view((D, F), 62, D ** -0.5))
    x = _offset_view((M, D), 60)
    for label, (w1, w3) in (("x", aligned), ("x, w1 and w3", offset)):
        ptrs = (x.data_ptr(), w1.data_ptr(), w3.data_ptr())
        name = ROUTE_NAMES[route(M, D, F, bf, aligned=not any(
            p % 16 for p in ptrs))]
        require(name == ROUTE_NAMES[SIMT],
                f"misaligned {label} routed to {name}")
        before = fused_swiglu_cuda.launches
        got = fused_swiglu_cuda(x, w1, w3)
        require(fused_swiglu_cuda.launches == before + 1,
                "fused_swiglu_cuda did not count its launch")
        want = ref.fused_swiglu(x, w1, w3)
        require(got.data_ptr() != want.data_ptr(),
                "the kernel's output and the plain version's are one tensor")
        err, share = _close(f"fused_swiglu bf16 ({M},{D},{F}) misaligned "
                            f"{label}", got, want, TOL["bfloat16"])
        x64 = x.double()
        wide = (torch.nn.functional.silu(x64 @ w1.double())
                * (x64 @ w3.double())).to(bf)
        n_plain = int((got != want).sum())
        n_wide = int((got != wide).sum())
        del wide, x64
        print(f"kernel fused_swiglu bf16 ({M},{D})x({D},{F}) with {label} 2 "
              f"bytes past 16-byte boundaries: route {name}, equal to plain "
              f"within rtol {TOL['bfloat16']['rtol']} atol "
              f"{TOL['bfloat16']['atol']} ({share:.3f} of it; max abs err "
              f"{err:.6g}; {n_plain} of {got.numel()} outputs differ from "
              f"plain, {n_wide} from the float64-summed reference)")
    xa = _randn((M, D), bf, 60)
    aligned_x = lambda: fused_swiglu_cuda(xa, *aligned)  # noqa: E731
    misaligned = lambda: fused_swiglu_cuda(x, *offset)  # noqa: E731
    turns = [(cuda_ms(misaligned, 3), cuda_ms(aligned_x, 3))
             for _ in range(2)]
    print(f"kernel fused_swiglu bf16 ({M},{D})x({D},{F}): SIMT on the "
          f"misaligned views {_turns_txt([t[0] for t in turns])} ms, tensor "
          f"cores on aligned copies {_turns_txt([t[1] for t in turns])} ms "
          "(turns)")


def flash_long_prefill() -> None:
    """The bf16 flash kernel and SDPA at a 2000-token prefill, (96, 2000,
    128) causal, kv_group 3, device times in turns, with the kernel SDPA
    runs (its yardstick's name; the port never calls it): how both scale
    past the serve shape's 500 tokens."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    H, S, d, g = 96, 2000, 128, 3
    q = _randn((H, S, d), torch.bfloat16, 50)
    k, v = (_randn((H // g, S, d), torch.bfloat16, i) for i in (51, 52))
    kern = lambda: flash_attention_cuda(q, k, v, causal=True,  # noqa: E731
                                        kv_group=g)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], is_causal=True, enable_gqa=True)[0]
    _close(f"flash_attention bf16 ({H},{S},{d}) causal kv_group {g}",
           kern(), ref.flash_attention(q, k, v, causal=True, kv_group=g),
           TOL["bfloat16"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lib()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    k_devs, l_devs = [], []
    for _ in range(2):
        k_devs.append(device_ms(kern, 20))
        l_devs.append(device_ms(lib, 20))
    flop = 4 * d * H * S * (S + 1) // 2
    rate = lambda ms: "not measured" if ms is None else \
        f"{flop / ms / 1e9:.1f} TFLOP/s"  # noqa: E731
    print(f"kernel flash_attention ({H},{S},{d}) causal kv_group {g} bf16: "
          f"device {_turns_txt(k_devs)} ms ({rate(_mean(k_devs))} over the "
          f"live pairs), library device {_turns_txt(l_devs)} ms "
          f"({rate(_mean(l_devs))}); within rtol {TOL['bfloat16']['rtol']} "
          f"atol {TOL['bfloat16']['atol']} of plain; SDPA runs "
          f"{', '.join(n[:100] for n in names)}")


def _mean(values):
    """The mean of ``values``, or None if any is None (not measured)."""
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def _turns_txt(values) -> str:
    return " / ".join("not measured" if v is None else f"{v:.6f}"
                      for v in values)


def flash_tc_checks() -> None:
    """The bf16 tensor-core flash kernel against its plain version on every
    head dim it pads (32, 64, 80 -> 128, 128, 160, 192 -> 256, 256), on
    ragged and one-row sequences, with and without grouped kv heads and in
    every mask mode, under ``TOL``; one launch per call."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    bf = torch.bfloat16
    n, worst, path_worst = 0, 0.0, 0.0
    for d in FLASH_TC_DIMS:
        for S in (1, 17, 64, 65, 500):
            for g in (1, 3):
                H = 2 * g
                q = _randn((H, S, d), bf, 40 + d + S)
                k, v = (_randn((H // g, S, d), bf, 41 + i + d + S)
                        for i in (1, 2))
                for kw in (dict(causal=True), dict(causal=True, window=64),
                           dict(causal=False)):
                    before = flash_attention_cuda.launches
                    got = flash_attention_cuda(q, k, v, kv_group=g, **kw)
                    require(flash_attention_cuda.launches == before + 1,
                            "flash_attention_cuda did not count its launch")
                    want = ref.flash_attention(q, k, v, kv_group=g, **kw)
                    label = f"flash_attention bf16 ({H},{S},{d}) kv_group " \
                            f"{g} {kw}"
                    worst = max(worst, _close(label, got, want,
                                              TOL["bfloat16"])[1])
                    diff = (got.float() - want.float()).abs()
                    path_worst = max(path_worst, (diff / (
                        PATH_TOL["atol"] + PATH_TOL["rtol"]
                        * want.float().abs())).max().item())
                    n += 1
    print(f"kernel flash_attention bf16 tensor cores: {n} cases (d "
          f"{', '.join(map(str, FLASH_TC_DIMS))}; S 1, 17, 64, 65, 500; "
          f"kv_group 1, 3; causal, window "
          f"64, full) equal to plain within rtol {TOL['bfloat16']['rtol']} "
          f"atol {TOL['bfloat16']['atol']} ({worst:.3f} of it at most; "
          f"{path_worst:.3f} of PATH_TOL, not held)")


def dispatch_breakdown() -> None:
    """Host time of one ``rmsnorm_cuda`` call at (4, 3072) bf16, part by
    part: each part over 1000 calls after a synchronize
    (``time.perf_counter``; the device runs behind, only enqueueing is
    timed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _launch
    from repro_torch.kernels import rmsnorm as rn

    x = _randn((4, 3072), torch.bfloat16, 1)
    s = _randn((3072,), torch.bfloat16, 2)
    dev, index = x.device, x.get_device()
    fn, err = _launch.entry("rmsnorm", rn._ARGS)
    out = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(index)
    parts = [
        ("bare ctypes call rmsnorm_error_string(0)", lambda: err(0)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("check_operands (x, scale)",
         lambda: _launch.check_operands("rmsnorm", rn._NAMES, x, s)),
        ("stream: torch._C._cuda_getCurrentRawStream(index) (the port's)",
         lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("stream: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("the C entry refusing dtype code 2 (ctypes alone, no CUDA call)",
         lambda: fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), 4, 3072,
                    1e-6, 2, index, stream)),
        ("the C entry called directly (ctypes + kernel enqueue)",
         lambda: fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), 4, 3072,
                    1e-6, 1, index, stream)),
        ("the whole wrapper rmsnorm_cuda(x, scale)",
         lambda: rn.rmsnorm_cuda(x, s)),
        ("F.rms_norm(x, (3072,), scale, 1e-6), for comparison",
         lambda: F.rms_norm(x, (3072,), s, 1e-6)),
    ]
    for label, call in parts:
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        us = (time.perf_counter() - t0) / 1000 * 1e6
        torch.cuda.synchronize()
        print(f"dispatch: rmsnorm (4,3072) bf16, {label}: {us:.3f} us a call "
              "(host, mean of 1000)")


def kernel_entries():
    """Each kernel's launching entry, which carries its ``launches``."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.fused_swiglu import (fused_swiglu_cuda,
                                                  swiglu_gate_bwd_cuda)
    from repro_torch.kernels.motif_pcu import motif_pcu_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.kernels.sim_alu import sim_alu_cuda
    from repro_torch.kernels.sim_loop import sim_loop_cuda

    return {"sim_alu": sim_alu_cuda, "sim_loop": sim_loop_cuda,
            "rmsnorm": rmsnorm_cuda,
            "fused_swiglu": fused_swiglu_cuda,
            "flash_attention": flash_attention_cuda,
            "motif_pcu": motif_pcu_cuda,
            "rmsnorm_bwd": rmsnorm_bwd_cuda,
            "swiglu_gate_bwd": swiglu_gate_bwd_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda}


def read_counts():
    return {name: fn.launches for name, fn in kernel_entries().items()}


def reset_counts() -> None:
    for fn in kernel_entries().values():
        fn.launches = 0


def teacher_forced(model, prompts, follow, steps: int, extra=None):
    """Logits of ``steps`` decode steps fed ``follow`` after a prefill of
    ``prompts`` (with the ``extra`` inputs of a full-sequence batch, the
    encdec's audio, the vlm's embeddings and M-RoPE positions), and the
    full forward's logits at the same positions (the MoE family's
    ``forward`` returns ``(h, aux)``; the vlm's takes the embeddings of
    the followed tokens, as its decode steps do)."""
    import torch

    from repro_torch.serve.kvcache import grow_cache

    B, T = prompts.shape
    extra = extra or {}
    with torch.inference_mode():
        cache, _ = model.prefill({"tokens": prompts, **extra})
        cache = grow_cache(cache, steps, window=model.cfg.sliding_window)
        dec = []
        for i in range(steps):
            cache, logits = model.decode_step(cache, follow[:, i:i + 1])
            dec.append(logits[:, 0])
        whole = {"tokens": torch.cat([prompts, follow[:, :steps]], dim=1),
                 **extra}
        if model.cfg.family == "vlm":  # decode embeds its tokens
            whole["embeds"] = torch.cat(
                [extra["embeds"], model.emb[follow[:, :steps]]], dim=1)
            whole["positions"] = torch.arange(
                T + steps, dtype=torch.int32,
                device=prompts.device).expand(B, 3, T + steps)
        h = model.forward(whole)
        if isinstance(h, tuple):
            h = h[0]
        full = (h[:, T:T + steps] @ model.emb.T).float()
    return torch.stack(dec, dim=1), full


def serve_phase(arch: str, decode_check: bool):
    """A serving run at full width on the card (the second main path, once
    per model of ``SERVED``); returns the launch counts of its run.  With
    ``decode_check``, 4 teacher-forced decode steps against a full forward
    in float32 at full width and depth follow."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import run as serve_run

    batch, prompt_len, new = SERVE_SHAPES[arch]
    args = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--new-tokens", str(new), "--device", "cuda"]
    if arch in SERVE_LAYERS:
        args += ["--layers", str(SERVE_LAYERS[arch])]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve_run(args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for line in buf.getvalue().splitlines():
        print(f"serve: {line}")
    cfg, info, tokens = out["cfg"], out["info"], out["tokens"]
    layers = cfg.n_layers
    fields = model_fields(arch, SERVE_LAYERS.get(arch))
    require({k: getattr(cfg, k) for k in fields} == fields,
            f"not the full-width {arch} config: {cfg}")
    require(tuple(tokens.shape) == (batch, new),
            f"tokens {tuple(tokens.shape)}")
    require(info["cache_length"] == prompt_len + new - 1,
            f"cache length {info['cache_length']}, want {prompt_len} + "
            f"{new - 1}")
    require(info["logits_finite"], "non-finite logits")
    want = dict.fromkeys(counts, 0)
    want.update(serve_launches(cfg))
    require(counts == want, f"{arch} launch counts {counts}, want {want}")
    params = list(out["model"].parameters())
    n_params = sum(p.numel() for p in params)
    n_bytes = sum(p.numel() * p.element_size() for p in params)
    depth = f", {layers} of {SERVED[arch]['n_layers']} layers" \
        if arch in SERVE_LAYERS else ""
    print(f"serve: {arch} full width{depth} ({n_params} params, "
          f"{n_bytes / 1e9:.3f} GB of weights); prefill "
          f"{info['prefill_s'] * 1e3:.3f} ms, "
          f"decode {info['decode_s'] / info['decode_steps'] * 1e3:.3f} ms "
          f"per token; set-up {out['setup_s']:.3f} s; run {wall:.3f} s; "
          f"peak device memory {peak:.3f} GiB; launches {counts}")

    model, prompts = out["model"], out["prompts"]
    extra = out["extra_batch"] or {}
    # the served prefill again, traced (and its MoE dispatch recorded)
    with torch.inference_mode(), recorded_moe() as calls, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache, _ = model.prefill({"tokens": prompts, **extra})
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    report_trace(prof, f"{arch}: the prefill (batch {batch} x {prompt_len})",
                 info["prefill_s"] * 1e3, traced_ms)
    if calls:  # the same prefill as the served one: its dispatch
        from repro_torch.models.moe import moe_capacity

        dropped = [int((~c["dispatch"][2]).sum()) for c in calls]
        print(f"serve: {arch} routes dropped in the prefill per layer (of "
              f"{calls[0]['dispatch'][2].numel()} a layer, capacity "
              f"{moe_capacity(cfg, prompts.numel())} an expert; random "
              f"weights, not a gate): {dropped}")
    profile_decode(model, cache, tokens[:, :1])
    del out, model, cache
    torch.cuda.empty_cache()
    if not decode_check:
        return counts

    # float32, where sum order is all that differs between the two routes
    model = zoo_init(cfg, torch.float32)
    dec, full = teacher_forced(model, prompts, tokens, 4)
    err, share = _close(f"teacher-forced decode vs forward (f32, {layers} "
                        "layers)", dec, full, DECODE_TOL)
    print(f"serve: 4 teacher-forced decode steps equal the full forward in "
          f"float32 at full width and {layers} layers (rtol "
          f"{DECODE_TOL['rtol']} atol {DECODE_TOL['atol']}); max abs diff "
          f"{err:.6g}, {share:.3f} of the tolerance; logits up to "
          f"{full.abs().max().item():.6g}, mean |logit| "
          f"{full.abs().mean().item():.6g}")
    del model
    torch.cuda.empty_cache()
    return counts


def serve_launches(cfg):
    """The kernels' launches in one serve run (1 prefill + 31 decode
    steps, 32 passes): rmsnorm ln1 + ln2 a layer and ln_f a pass (one ln
    a Mamba-1 layer; ln and the gated norm a Mamba-2 layer, ln1 + ln2 a
    shared-attention site; ln1, ln_x and ln2 a decoder layer, and once in
    the prefill 2 an encoder layer and ln_enc); fused_swiglu one MLP a
    dense layer or site a pass (only arctic's dense branch among the MoE
    configs; an encoder layer's once); flash_attention a causal
    self-attention layer or site in the prefill only (none in Mamba-1;
    the encoder and cross-attention are non-causal and take none); with
    qk-norm rmsnorm twice more a layer a pass, once over q's rows and once
    over k's (qwen3_14b: 161 x 32 = 5152)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"rmsnorm": (L + 1) * 32}
    if cfg.family == "hybrid":
        sites = L // cfg.attn_every
        return {"rmsnorm": (2 * L + 2 * sites + 1) * 32,
                "fused_swiglu": sites * 32, "flash_attention": sites}
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers
        return {"rmsnorm": 2 * enc + 1 + (3 * L + 1) * 32,
                "fused_swiglu": enc + L * 32, "flash_attention": L}
    swiglu = cfg.family != "moe" or bool(cfg.moe_dense_ff)
    norms = 4 if cfg.qk_norm else 2  # q_norm and k_norm: one call each
    return {"rmsnorm": (norms * L + 1) * 32, "fused_swiglu": swiglu * L * 32,
            "flash_attention": L}


@contextlib.contextmanager
def recorded_moe():
    """Each MoE block run while the ``with`` block runs, in call order: a
    dict of its input ``x``, its ``dispatch`` ``(gates, top_e, keep,
    slot)`` and its output ``out`` (``repro_torch.models.moe.moe_block``
    and ``route`` wrapped; no device synchronisation)."""
    from repro_torch.models import moe

    calls, real_block, real_route = [], moe.moe_block, moe.route

    def block(cfg, w, x):
        calls.append({"x": x})
        out = real_block(cfg, w, x)
        calls[-1]["out"] = out[0]
        return out

    def route(gates, top_k, capacity):
        out = real_route(gates, top_k, capacity)
        calls[-1]["dispatch"] = (gates, *out[1:])
        return out

    moe.moe_block, moe.route = block, route
    try:
        yield calls
    finally:
        moe.moe_block, moe.route = real_block, real_route


def zoo_init(cfg, dtype):
    """The model at ``cfg`` with weights drawn on the card from ``SEED``."""
    import torch

    from repro_torch.models import zoo

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return zoo.init_model(cfg, gen, "cuda", dtype)


def first_layers(cfg, n: int, dtype, device: str = "cuda"):
    """The first ``n`` layers of the model at ``cfg``, its weights drawn on
    ``device`` from ``SEED`` at the full depth and sliced (the hybrid's
    stacked ``mamba`` layers; its ``shared`` block is kept whole).
    ``init_params``
    divides a stacked weight by the square root of its layer count (the
    JAX ``init_of`` rule), so a model drawn at 2 layers has weights
    sqrt(L / 2) times those of the full model's layers.  falcon_mamba_7b
    drawn so drives ``dt`` past 1e5 and its state past 1e11, where float32
    decode logits miss a float64 run by more than ``PARITY_TOL`` on the CPU
    as on the card (``scripts/ssm_parity_conditioning.py``).  Sliced from
    the full draw, each layer has the served model's scale."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.layers import init_params

    def head(tree):
        return {k: head(v) if isinstance(v, dict) else v[:n].clone()
                for k, v in tree.items()}

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(zoo.param_spec(cfg), gen, device, dtype)
    stacked = "mamba" if cfg.family == "hybrid" else "layers"
    params[stacked] = head(params[stacked])
    return zoo.build(cfg.replace(n_layers=n), params)


def profile_decode(model, cache, tok) -> None:
    """Device busy share and top kernels of one decode step at full width
    (``torch.profiler``): device time of a profiled step against the wall
    time of an unprofiled one, after a warm step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.kvcache import grow_cache

    # a warm, a timed and a traced step
    cache = grow_cache(cache, 3, window=model.cfg.sliding_window)
    held = (f"cache {cache['k'].shape[2]} slots" if "k" in cache else
            f"state cache conv {tuple(cache['conv'].shape)} + h "
            f"{tuple(cache['h'].shape)} float32")
    with torch.inference_mode():
        model.decode_step(cache, tok)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_step(cache, tok)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    report_trace(prof, f"one decode step (batch {tok.shape[0]}, {held})",
                 wall_ms, traced_ms)


def report_trace(prof, what: str, wall_ms: float, traced_ms: float) -> None:
    """The device busy share of a traced run against the wall time of an
    unprofiled one, its kernel count and its 8 longest kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("profile: no device time in the trace (not measured)")
        return
    print(f"profile: {what}, device busy "
          f"{busy_ms:.6f} ms of {wall_ms:.6f} ms unprofiled wall "
          f"({100 * busy_ms / wall_ms:.2f}% busy; {traced_ms:.6f} ms wall "
          f"while traced); {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.6f} ms "
              f"{e.count:5d}x {e.key[:90]}")


#: the parity phase's depth a model (2 where not listed): zamba2 at 7
#: layers, one shared-attention site and one tail layer, so that both the
#: group path and the tail run; whisper_tiny at its full 4 + 4
PARITY_LAYERS = {"zamba2_1_2b": 7, "whisper_tiny": 4}
#: the hybrid's SSD chunk in the parity phase: a 128-token prompt spans two
PARITY_SSM_CHUNK = 64
#: the parity phase's prompt (batch, length) where not 2 x 128: danube's
#: runs past its window, as its serve run does
PARITY_PROMPTS = {"h2o_danube_3_4b": (1, 4600)}
#: the models whose parity layers are their depth cut (``zoo.depth_cut``:
#: each layer at the full model's weight scale, drawn at the cut depth);
#: qwen2_vl_72b's full draw would be 290 GB in float32
DEPTH_CUT_PARITY = ("qwen3_14b", "qwen2_vl_72b", "h2o_danube_3_4b")


def parity_model(full, n: int, device: str = "cuda"):
    """The parity phases' float32 model on ``device``, ``n`` layers of the
    full-width config ``full``: the first layers of the full draw for the
    moe, ssm and hybrid models (``first_layers``), the depth cut for
    ``DEPTH_CUT_PARITY``, an ``n``-layer draw for the others."""
    import torch

    from repro_torch.models import zoo

    if full.family in ("moe", "ssm", "hybrid"):
        return first_layers(full, n, torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if full.arch_id in DEPTH_CUT_PARITY:
        return zoo.init_model(full, gen, device, torch.float32, layers=n)
    return zoo.init_model(full.replace(n_layers=n), gen, device,
                          torch.float32)


def serve_parity_model(arch: str, device: str = "cuda"):
    """The serve parity phase's float32 model of ``arch`` on ``device``:
    ``PARITY_LAYERS`` deep (2 unless listed; the hybrid's ``ssm_chunk``
    ``PARITY_SSM_CHUNK``), as ``parity_model`` draws it."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    if full.family == "hybrid":
        full = full.replace(ssm_chunk=PARITY_SSM_CHUNK)
    return parity_model(full, PARITY_LAYERS.get(arch, 2), device)


def parity_inputs(arch: str, cfg):
    """The serve parity phase's CPU inputs, drawn from ``SEED``: tokens (B,
    P + 4), a prompt of ``PARITY_PROMPTS`` (2 x 128 unless listed) and 4
    tokens to feed, and the full-sequence batch's other inputs (the
    encdec's audio frames; the vlm's prompt embeddings and M-RoPE
    positions)."""
    import numpy as np
    import torch

    B, P = PARITY_PROMPTS.get(arch, (2, 128))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, P + 4)).astype(np.int32))
    extra = {}
    if cfg.family == "encdec":
        extra["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    elif cfg.family == "vlm":
        extra["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32))
        extra["positions"] = torch.arange(P, dtype=torch.int32).expand(
            B, 3, P).contiguous()
    return toks, extra


def parity_phase(arch: str) -> None:
    """Full width, float32, ``PARITY_LAYERS`` deep (``parity_model``): the
    port on the card (kernels) against the port on the CPU (plain
    versions), same weights and prompts (and audio frames for the encdec,
    embeddings and M-RoPE positions for the vlm): prefill and 4
    teacher-forced decode steps.  For an MoE model the card's dispatch of
    each layer in the prefill (experts, slots, kept routes) must equal the
    CPU's on the same input exactly (``dispatch_parity``).
    """
    import torch

    card = serve_parity_model(arch)
    cfg = card.cfg
    n = cfg.n_layers
    cpu = copy.deepcopy(card).to("cpu")
    toks, extra = parity_inputs(arch, cfg)
    B, P = toks.shape[0], toks.shape[1] - 4
    on_card = {k: v.cuda() for k, v in extra.items()}
    with torch.inference_mode(), recorded_moe() as calls:
        got = [card.prefill({"tokens": toks[:, :P].cuda(), **on_card})[1]]
        n_card = len(calls)
        want = [cpu.prefill({"tokens": toks[:, :P], **extra})[1]]
    if calls:
        dispatch_parity(arch, cpu, calls[:n_card], calls[n_card:])
    dec_c, full_c = teacher_forced(card, toks[:, :P].cuda(),
                                   toks[:, P:].cuda(), 4, on_card)
    dec_h, full_h = teacher_forced(cpu, toks[:, :P], toks[:, P:], 4,
                                   extra)
    depth = f"{n} layers" if cfg.family != "encdec" else \
        f"{cfg.n_enc_layers} + {n} layers, {cfg.enc_seq} audio frames"
    err = max(_close(f"card vs CPU {arch} {what} (f32, full width, "
                     f"{depth})", g.cpu(), w, PARITY_TOL)[0]
              for what, g, w in (("prefill logits", got[0], want[0]),
                                 ("decode logits", dec_c, dec_h),
                                 ("forward logits", full_c, full_h)))
    print(f"parity: {arch} full width, {depth}, f32, batch {B}, prompt {P}, "
          f"4 teacher-forced steps: the card's kernels equal the CPU's plain "
          f"versions (rtol {PARITY_TOL['rtol']} atol {PARITY_TOL['atol']}); "
          f"max abs diff {err:.6g}")
    del card, cpu
    torch.cuda.empty_cache()


def _rank_gaps(gates, K: int):
    """Per token, the smallest gap between neighbouring gates among the
    best K + 1 in log space (how near an expert came to changing rank or
    place; equal gates, zeros included, are ties, which both devices break
    to the lower expert), and the gap between gates K and K + 1 in
    gates."""
    import torch

    top = torch.sort(gates.double(), dim=-1, descending=True).values
    lg = top[:, :K + 1].log()
    gap = torch.nan_to_num(lg[:, :-1] - lg[:, 1:], nan=float("inf"))
    return gap.min(-1).values, top[:, K - 1] - top[:, K]


def dispatch_parity(arch, cpu_model, card, cpu) -> None:
    """The card's MoE dispatch of each layer of a prefill (``card``, calls
    recorded by ``recorded_moe``) against the CPU's dispatch of the same
    layer on the same input (the card's, moved over): experts, slots and
    kept routes equal, the block's output within ``PARITY_TOL`` (atol
    relative to the output's largest magnitude).  The
    CPU's own prefill (``cpu``) reaches each layer with float32 noise of
    its own; where that noise moves a route it is reported, with how near
    that route came to a tie, and not held."""
    import torch

    from repro_torch.models import moe

    cfg = cpu_model.cfg
    K = cfg.top_k
    require(len(card) == len(cpu) == cfg.n_layers,
            f"{len(card)} / {len(cpu)} MoE blocks, want {cfg.n_layers}")
    for i, (c, h) in enumerate(zip(card, cpu)):
        x = c["x"].cpu()
        with recorded_moe() as again:
            out = moe.moe_block(cfg, cpu_model.layers[i]["moe"], x)[0]
        want = again[0]["dispatch"]
        log_gap, gap = _rank_gaps(want[0], K)
        same = all(torch.equal(a.cpu(), b)
                   for a, b in zip(c["dispatch"][1:], want[1:]))
        require(same, f"{arch} layer {i}: the card's dispatch differs from "
                f"the CPU's on the same input; smallest gap between gates "
                f"{K} and {K + 1} of a token, best first: "
                f"{gap.min().item():.6g} (smallest log gap among the best "
                f"{K + 1}: {log_gap.min().item():.6g})")
        # the block's outputs are hidden states, not logits: atol relative
        # to their largest magnitude, as the CPU tests hold hidden states
        scale = max(1.0, out.abs().max().item())
        err, share = _close(f"{arch} MoE block {i} on the card's input",
                            c["out"].cpu(), out,
                            dict(PARITY_TOL, atol=PARITY_TOL["atol"] * scale))
        top_c, top_h = c["dispatch"][1].cpu(), h["dispatch"][1]
        moved = (top_c != top_h).any(-1)
        drift = ((x - h["x"]).abs().max() / h["x"].abs().max()).item()
        print(f"parity: {arch} layer {i} dispatch on the card equals the "
              f"CPU's on the same input, route for route "
              f"({top_c.numel()} routes, {int((~want[2]).sum())} dropped; "
              f"smallest gap between gates {K} and {K + 1} "
              f"{gap.min().item():.6g}, smallest log gap among the best "
              f"{K + 1} {log_gap.min().item():.6g}); block output max abs "
              f"diff {err:.6g} at magnitudes up to {scale:.6g} ({share:.3f} "
              f"of PARITY_TOL, atol times that magnitude). The CPU's own "
              f"run reaches the layer {drift:.3g} away (max |diff| / max "
              f"|x|) and routes {int(moved.sum())} token(s) otherwise"
              + ("" if not moved.any() else
                 f", at log gaps "
                 f"{_rank_gaps(h['dispatch'][0][moved], K)[0].tolist()} "
                 f"(not held)"))


def _motif_inputs(N: int, seed: int, special: bool):
    """(3, N) float32 on the card, uniform in [-100, 100] (the range
    ``random_schedule`` is drawn for); with ``special``, the first columns
    take every mix of NaN, +-inf, +-0 and 1 (for schedules of add, sub,
    mul, max and min only)."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        -100, 100, (3, N)).astype(np.float32)).cuda()
    if special:
        vals = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                             -0.0, 1.0], device="cuda")
        grid = torch.cartesian_prod(vals, vals, vals).T[:, :N]
        x[:, :grid.shape[1]] = grid
    return x


def motif_phase():
    """motif_pcu against its plain version on the card; returns its JSON
    record minus ``launches`` (times at the ops path's (3, 1024); both
    shapes under ``at``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.motif_pcu import (FANIN, FANOUT, MAX_SLOTS,
                                               UNICAST, motif_pcu_cuda,
                                               random_schedule)

    def bitwise(label, sched, x):
        got = motif_pcu_cuda(sched, 3, x)
        want = ref.motif_pcu(sched, 3, x)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"motif_pcu differs from its plain version: {label}")

    canonical = {"FANIN": FANIN, "FANOUT": FANOUT, "UNICAST": UNICAST}
    cases = [(name, s, True) for name, s in canonical.items()] + [
        (f"random seed {s}", random_schedule(s), False) for s in range(3)]
    for name, sched, special in cases:
        for N in MOTIF_NS:
            bitwise(f"{name} at N = {N}", sched, _motif_inputs(N, N, special))
        ops = sorted({op for _, op, _, _ in sched})
        print(f"kernel motif_pcu {name} ({len(sched)} steps: "
              f"{', '.join(ops)}): bitwise equal to plain at N = "
              f"{', '.join(map(str, MOTIF_NS))}"
              f"{' with NaN/+-inf/+-0 columns' if special else ''} "
              "(tolerance 0)")
    sched = random_schedule(7, steps=MAX_SLOTS - 3)
    bitwise("the largest table", sched, _motif_inputs(4099, 7, False))
    print(f"kernel motif_pcu {MAX_SLOTS} slots (the largest table, "
          f"{MAX_SLOTS * 256 * 4 + len(sched) * 16} bytes of shared memory):"
          " bitwise equal at N = 4099")

    max_err = 0.0
    for name, sched in canonical.items():
        x = _randn((3, 2048), torch.bfloat16, 20)
        err, share = _close(f"motif_pcu bfloat16 {name} (3,2048)",
                            motif_pcu_cuda(sched, 3, x),
                            ref.motif_pcu(sched, 3, x), PATH_TOL)
        max_err = max(max_err, err)
        print(f"kernel motif_pcu {name} (3,2048) bf16: max abs err {err:.6g}"
              f", {share:.3f} of the tolerance (rtol {PATH_TOL['rtol']} "
              f"atol {PATH_TOL['atol']})")

    at = []
    for N, iters in ((1024, 2000), (2 ** 24, 50)):
        x = _randn((3, N), torch.float32, 21)
        kern = lambda: motif_pcu_cuda(FANIN, 3, x)  # noqa: E731
        k_ms = cuda_ms(kern, iters)
        k_dev = device_ms(kern, min(iters, 200))
        p_ms = cuda_ms(lambda: ref.motif_pcu(FANIN, 3, x), iters // 10)
        # each input read once, each of the 6 slots written once, 4 bytes;
        # one float32 operation per step and iteration
        bound, by = _bound((3 + 6) * N * 4, 3 * N, FP32_OPS_PER_S)
        share = "" if k_dev is None else \
            f"; {100 * bound / k_dev:.1f}% of the bound in device time"
        print(f"kernel motif_pcu FANIN (3,{N}) f32: {k_ms:.6f} ms "
              f"({_device_txt(k_dev)}), plain {p_ms:.6f} ms, bound "
              f"{bound:.6f} ms ({by}), library none (no single PyTorch "
              f"call computes a schedule){share}")
        at.append({"shape": f"(3,{N})", "ms": k_ms, "device_ms": k_dev,
                   "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None})
    return {"name": "motif_pcu", "route": "cuda", "source": MOTIF_SOURCE,
            "replaces": MOTIF_REPLACES, "max_abs_err": max_err,
            **{k: at[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}, "at": at}


def track_a_phase() -> None:
    """The card's table of each canonical schedule against the Track-A
    interpreter: its DFG (three inputs, one node per step, built with
    ``DFG.add``) evaluated over 64 iterations, each with its own inputs
    (``DFG.eval``'s default leaves ``it + 1 + nid % 5``)."""
    import torch

    from repro_torch.core.dfg import DFG
    from repro_torch.kernels.motif_pcu import (FANIN, FANOUT, UNICAST,
                                               motif_pcu_cuda)

    iters = 64
    x = torch.tensor([[float(it + 1 + i % 5) for it in range(iters)]
                      for i in range(3)], device="cuda")
    for name, sched in (("FANIN", FANIN), ("FANOUT", FANOUT),
                        ("UNICAST", UNICAST)):
        g = DFG(name)
        for _ in range(3):
            g.add("input")
        for dst, op, a, b in sched:
            require(g.add(op, inputs=[a, b]) == dst,
                    f"{name}: DFG node ids do not follow the slots")
        hist = g.eval({}, iterations=iters)
        table = motif_pcu_cuda(sched, 3, x).cpu()
        for nid in g.nodes:
            require(table[nid].tolist() == hist[nid],
                    f"{name}: slot {nid} on the card differs from DFG.eval")
    print(f"track-a: FANIN, FANOUT, UNICAST tables on the card equal "
          f"DFG.eval over {iters} iterations exactly")


def ops_phase() -> int:
    """The third main path: ``repro_torch.kernels.ops`` on ``cuda`` at the
    shapes of ``benchmarks/run.py``'s kernel rows, in float32.  Each row is
    called once and checked against its plain version, then timed over
    ``OPS_REPS`` calls after a warm one; returns the launch counts."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.motif_pcu import FANIN

    f32 = torch.float32
    x = _randn((128, 256), f32, 30)
    w1, w3 = _randn((256, 128), f32, 31), _randn((256, 128), f32, 32)
    s = _randn((256,), f32, 33)
    q = _randn((2, 128, 64), f32, 34)
    m = _randn((3, 1024), f32, 35)
    rows = [
        ("fused_swiglu", lambda: ops.fused_swiglu(x, w1, w3),
         lambda: ref.fused_swiglu(x, w1, w3)),
        ("rmsnorm", lambda: ops.rmsnorm(x, s), lambda: ref.rmsnorm(x, s)),
        ("flash_attention",
         lambda: ops.flash_attention(q, q, q, block_q=64, block_k=64),
         lambda: ref.flash_attention(q, q, q)),
        ("motif_pcu", lambda: ops.motif_pcu(m, schedule=FANIN, n_inputs=3),
         lambda: ref.motif_pcu(FANIN, 3, m)),
    ]
    reset_counts()
    outs, times = {}, {}
    for name, call, _ in rows:
        outs[name] = call()
        times[name] = cuda_ms(call, OPS_REPS) * 1e3
    counts = read_counts()
    for name, _, plain in rows:
        if name == "motif_pcu":
            want = plain()
            torch.cuda.synchronize()
            require(torch.equal(outs[name].view(torch.int32),
                                want.view(torch.int32)),
                    "ops.motif_pcu differs from its plain version")
            err, txt = 0.0, "bitwise equal"
        else:
            err, share = _close(f"ops.{name}", outs[name], plain(),
                                TOL["float32"])
            txt = f"{share:.3f} of rtol {TOL['float32']['rtol']} atol " \
                  f"{TOL['float32']['atol']}"
        print(f"ops: kernel_{name} {times[name]:.3f} us max_abs_err="
              f"{err:.2e} ({txt}); launches {counts[name]}")
    want = {n: 0 for n in counts}
    want.update({name: OPS_REPS + 2 for name, _, _ in rows})
    require(counts == want, f"ops path launch counts {counts}, want {want}")
    return counts


# ---------------------------------------------------------------------------
# Train path: the backward kernels, llama3_2_3b at full width
# ---------------------------------------------------------------------------

#: the backward kernels: the function of the JAX package each computes the
#: gradient of (no TPU kernel had one: ``jax.value_and_grad`` differentiates
#: these inline layers with XLA)
BWD_REPLACES = {
    "rmsnorm_bwd": "src/repro/models/layers.py:87",
    "swiglu_gate_bwd": "src/repro/models/layers.py:359",
    "flash_attention_bwd": "src/repro/models/layers.py:155",
}
BWD_SOURCE = {"rmsnorm_bwd": "rmsnorm", "swiglu_gate_bwd": "fused_swiglu",
              "flash_attention_bwd": "flash_attention"}
#: each backward kernel's CUDA kernels, asserted by name in a trace
BWD_KERNEL_NAMES = {
    "rmsnorm_bwd": ("rmsnorm_bwd_warp_kernel", "rmsnorm_dscale_kernel"),
    "swiglu_gate_bwd": ("swiglu_gate_bwd_kernel",),
    "flash_attention_bwd": ("flash_bwd_delta_kernel",
                            "flash_bwd_dkdv_wgmma_kernel<128>",
                            "flash_bwd_dq_wgmma_kernel<128>"),
}
#: each yardstick's kernels, asserted by name in the traces that time it
#: (the backward of ``F.rms_norm``: layer norm's with the mean left out;
#: SDPA's: cuDNN's flash backward)
LIB_KERNEL_NAMES = {"rmsnorm_bwd": ("layer_norm", "GammaBeta"),
                    "flash_attention_bwd": ("flash_bprop",)}
#: flash's backward does its P and dS products twice (the bf16 value and
#: its remainder): 10 products where the function needs 5, so its design
#: cannot go below twice the function's bound
FLASH_BWD_DESIGN_PRODUCTS = 10
#: the kinds a traced train step's device time is summed by (a kernel
#: takes the first kind one of whose keys is in its name)
TRACE_GROUPS = (
    ("flash_attention_bwd (delta, dk/dv, dq on wgmma)", ("flash_bwd_",)),
    ("flash_attention forward (training form)", ("flash_attention_tc",)),
    ("fused_swiglu forward", ("fused_swiglu_tc",)),
    ("swiglu_gate_bwd", ("swiglu_gate_bwd",)),
    ("rmsnorm forward and backward", ("rmsnorm",)),
    ("cuBLAS products", ("nvjet", "gemm", "xmma", "cutlass")),
    ("Mamba-1 scan steps (one in-place addcmul_ a step, both ways)",
     ("addcmul",)),
)
#: the dense model of the train kernel phase's shapes and of the smoke-width
#: train runs
TRAINED = "llama3_2_3b"
#: each trained model (the fourth main path, one run each), with its depth
#: cut where its state does not fit one card at 12 bytes a parameter:
#: falcon_mamba_7b's 64 layers need about 84 GB (8 layers and the
#: embedding, 1.11 B parameters, about 13.3 GB), qwen2_vl_72b's 80 about
#: 870 GB (2 layers and the embedding, 3.0 B, about 36 GB)
TRAIN_RUNS = {"llama3_2_3b": None, "granite_moe_1b_a400m": None,
              "zamba2_1_2b": None, "whisper_tiny": None,
              "falcon_mamba_7b": 8, "qwen2_vl_72b": 2}
#: every run's traffic: batch x sequence (train_4k's sequence; the global
#: batch cut from 256 to 4), and its steps
TRAIN_SHAPE = (4, 4096)
TRAIN_STEPS = 4
#: the card against the CPU in float32, gradients: the relative L2 error of
#: each leaf.  The 2-layer slice is ill-conditioned (init_params divides a
#: stacked weight by the square root of the layer count, so the residual
#: stream reaches ~9000): the CPU's own float32 gradients miss a float64
#: run by up to 1.14e-3 and the card's by 9.6e-4, card vs CPU 1.29e-3
#: (``scripts/train_parity_conditioning.py`` on the card); held at 5e-3
GRAD_REL_TOL = 5e-3
#: the kernels' query rows of the flash plain gradient at a time (a slice
#: of kv heads; the (S, S) float32 scores of all 96 heads would be 6.4 GB)
PLAIN_FLASH_HEADS = 12


def train_launches(cfg, steps: int):
    """Each kernel's launches in ``steps`` training steps: one backward
    launch per forward call that wants a gradient, and every forward call
    of a block under a wrapping ``remat`` (``"dots"``, ``"nothing"``)
    again when its checkpoint is recomputed in the backward.  A step of
    L layers:

    * dense, vlm: rmsnorm twice a layer and ln_f (ln_f sits outside the
      checkpoints and is not recomputed), the gate and attention once a
      layer: rmsnorm 2L + 1 + 2L, fused_swiglu L + L, flash_attention
      L + L (llama3_2_3b: 113 / 57 / 56 / 28 / 56 / 28);
    * moe: the same without the gate (arctic's dense branch has one);
      granite recomputes all 24 blocks under ``"nothing"``: 97 / 49 / 0 /
      0 / 48 / 24;
    * ssm: one rmsnorm a Mamba-1 layer and ln_f: falcon's 8 layers
      17 / 9;
    * hybrid: each Mamba-2 layer's ln and its gated norm (rmsnorm over
      d_inner), recomputed; the shared block at each of the L //
      attn_every sites (ln1, ln2, the gate, attention) is not
      checkpointed: zamba2 2 x 38 + 2 x 38 + 2 x 6 + 1 = 165 / 89 / 6 /
      6 / 6 / 6;
    * encdec: an encoder layer's ln1, ln2 and gate, recomputed (its
      attention is the plain non-causal one, no kernel), ln_enc once; a
      decoder layer's ln1, ln_x, ln2, gate and causal self-attention,
      recomputed (cross-attention is plain), ln_f once: whisper's 4 + 4
      layers 42 / 22 / 16 / 8 / 8 / 4."""
    L = cfg.n_layers
    rec = 2 if cfg.remat in ("dots", "nothing") else 1  # forward + recompute
    fam = cfg.family
    if fam == "ssm":
        per = {"rmsnorm": rec * L + 1, "rmsnorm_bwd": L + 1}
    elif fam == "hybrid":
        sites = L // cfg.attn_every
        per = {"rmsnorm": 2 * rec * L + 2 * sites + 1,
               "rmsnorm_bwd": 2 * L + 2 * sites + 1,
               "fused_swiglu": sites, "swiglu_gate_bwd": sites,
               "flash_attention": sites, "flash_attention_bwd": sites}
    elif fam == "encdec":
        E = cfg.n_enc_layers
        per = {"rmsnorm": rec * (2 * E + 3 * L) + 2,
               "rmsnorm_bwd": 2 * E + 3 * L + 2,
               "fused_swiglu": rec * (E + L), "swiglu_gate_bwd": E + L,
               "flash_attention": rec * L, "flash_attention_bwd": L}
    else:
        norms = 4 if cfg.qk_norm else 2
        gate = fam != "moe" or bool(cfg.moe_dense_ff)
        per = {"rmsnorm": rec * norms * L + 1, "rmsnorm_bwd": norms * L + 1,
               "fused_swiglu": gate * rec * L, "swiglu_gate_bwd": gate * L,
               "flash_attention": rec * L, "flash_attention_bwd": L}
    return {k: v * steps for k, v in per.items() if v}


def train_kernel_names(cfg):
    """The CUDA kernels a train step of ``cfg`` in bf16 at the train shape
    launches, held by name in a traced step: rmsnorm's forward, its
    backward a warp a row (rows up to 3072) or looping (wider rows:
    falcon's 4096, zamba2's gated norm over 4096, qwen2_vl's 8192) and its
    dscale sum; the gate on tensor cores and its backward; flash's
    training form and its backward on ``wgmma`` at the head dim."""
    widths = {cfg.d_model}
    if cfg.family == "hybrid":
        widths.add(cfg.d_inner)
    if cfg.qk_norm:
        widths.add(cfg.resolved_head_dim)
    names = ["rmsnorm_kernel<__nv_bfloat16>"]
    if min(widths) <= 3072:
        names.append("rmsnorm_bwd_warp_kernel")
    if max(widths) > 3072:
        names.append("rmsnorm_bwd_wide_kernel")
    names.append("rmsnorm_dscale_kernel")
    launches = train_launches(cfg, 1)
    if "fused_swiglu" in launches:
        names += ["fused_swiglu_tc_kernel", "swiglu_gate_bwd_kernel"]
    if "flash_attention" in launches:
        dp = cfg.resolved_head_dim
        names += [f"flash_attention_tc_kernel<{dp}, true>",
                  "flash_bwd_delta_kernel",
                  f"flash_bwd_dkdv_wgmma_kernel<{dp}>",
                  f"flash_bwd_dq_wgmma_kernel<{dp}>"]
    return tuple(names)


def _traced_names(call, wanted) -> set:
    """The CUDA kernel names of up to five traces of three ``call()``s
    each, until every name in ``wanted`` is seen (a trace can drop a
    window's first kernels, or all of a short window's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = set()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        seen |= {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if all(any(w in n for n in seen) for w in wanted):
            break
    return seen


def _grads(fn, inputs, grad_out):
    """Autograd of ``fn(*inputs)`` against ``grad_out``, one gradient per
    input (fresh leaves)."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, grad_out)


def _flash_plain_grads(q, k, v, dout, g, kw):
    """The plain flash gradient, ``PLAIN_FLASH_HEADS`` query heads (their
    kv heads) at a time."""
    import torch

    from repro_torch.kernels import ref

    step = PLAIN_FLASH_HEADS
    dq, dk, dv = [], [], []
    for h0 in range(0, q.shape[0], step):
        kv = slice(h0 // g, (h0 + step) // g)
        a, b, c = _grads(lambda x, y, z: ref.flash_attention(
            x, y, z, kv_group=g, **kw), (q[h0:h0 + step], k[kv], v[kv]),
            dout[h0:h0 + step])
        dq.append(a)
        dk.append(b)
        dv.append(c)
    return torch.cat(dq), torch.cat(dk), torch.cat(dv)


def _gate_plain(a, b):
    import torch

    return (torch.nn.functional.silu(a.float()) * b.float()).to(a.dtype)


def bwd_kernel_cases():
    """(name, label, kernel call -> gradients, plain call -> gradients,
    library call or None, bytes, operations, operations rate) at the train
    path's shapes in bf16: rmsnorm (16384, 3072) with rows at RMS 0.1 to
    10, the gate's (16384, 8192), flash (96, 4096, 128) causal kv_group 3.
    The library call is each yardstick's backward alone: autograd of
    ``F.rms_norm`` and of SDPA (their forwards run once, outside the
    timing)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.fused_swiglu import swiglu_gate_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    bf = torch.bfloat16
    B, T = TRAIN_SHAPE
    M, D, Ff, H, Hkv, d = B * T, 3072, 8192, 96, 32, 128
    x = _randn((M, D), bf, 60, np.geomspace(0.1, 10.0, M)[:, None])
    s, dy = _randn((D,), bf, 61), _randn((M, D), bf, 62)
    xs, ss = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    y_lib = F.rms_norm(xs, (D,), ss, 1e-6)
    cases = [(
        "rmsnorm_bwd", f"({M},{D})", lambda: rmsnorm_bwd_cuda(x, s, dy),
        lambda: _grads(ref.rmsnorm, (x, s), dy),
        lambda: torch.autograd.grad(y_lib, (xs, ss), dy, retain_graph=True),
        3 * M * D * 2 + 2 * D * 2, 10 * M * D, FP32_OPS_PER_S)]
    a, b, dh = (_randn((M, Ff), bf, i) for i in (63, 64, 65))
    cases.append((
        "swiglu_gate_bwd", f"({M},{Ff})",
        lambda: swiglu_gate_bwd_cuda(a, b, dh),
        lambda: _grads(_gate_plain, (a, b), dh), None, 5 * M * Ff * 2,
        12 * M * Ff, FP32_OPS_PER_S))
    g = H // Hkv
    q = _randn((H, T, d), bf, 66)
    k, v = (_randn((Hkv, T, d), bf, i) for i in (67, 68))
    dout = _randn((H, T, d), bf, 69)
    _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g, train=True)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_sdpa = F.scaled_dot_product_attention(
        ql[None], kl[None], vl[None], is_causal=True, enable_gqa=True)[0]
    pairs = H * T * (T + 1) // 2
    cases.append((
        "flash_attention_bwd", f"({H},{T},{d}) causal kv_group {g}",
        lambda: flash_attention_bwd_cuda(q, k, v, out32, dout, lse,
                                         kv_group=g),
        lambda: _flash_plain_grads(q, k, v, dout, g, dict(causal=True)),
        lambda: torch.autograd.grad(y_sdpa, (ql, kl, vl), dout,
                                    retain_graph=True),
        (4 * H + 4 * Hkv) * T * d * 2 + H * T * 4, 10 * d * pairs,
        BF16_OPS_PER_S))
    return cases


def bwd_small_checks() -> None:
    """The backward kernels and the forward's row log-sum-exp against the
    plain gradients on ``tests/test_kernels.py``'s shapes in both dtypes
    (under ``TOL``), flash also at d 160 and 256, with grouped kv heads
    and in every mask mode; and flash's backward in bf16 at d 160 and 256
    with a window at 1024 tokens, under ``PATH_TOL``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.fused_swiglu import swiglu_gate_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    def rel_l2(got, want):
        return (torch.linalg.vector_norm(got.float() - want.float())
                / torch.linalg.vector_norm(want.float())).item()

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        n = 0
        worst = dict.fromkeys(BWD_KERNEL_NAMES, 0.0)
        # (64, 5120) is past the register kernel in both dtypes: the wide one
        for M, D in [(128, 64), (256, 512), (64, 160), (64, 5120)]:
            x, s, dy = (_randn(sh, dt, i) for i, sh in
                        ((70, (M, D)), (71, (D,)), (72, (M, D))))
            for name, got, want in zip(("dx", "dscale"),
                                       rmsnorm_bwd_cuda(x, s, dy),
                                       _grads(ref.rmsnorm, (x, s), dy)):
                _close(f"rmsnorm_bwd {dtype} ({M},{D}) {name}", got, want,
                       TOL[dtype])
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"],
                                           rel_l2(got, want))
                n += 1
        for M, F in [(128, 128), (256, 128), (128, 256), (7, 33)]:
            a, b, dh = (_randn((M, F), dt, i) for i in (73, 74, 75))
            for name, got, want in zip(("da", "db"),
                                       swiglu_gate_bwd_cuda(a, b, dh),
                                       _grads(_gate_plain, (a, b), dh)):
                _close(f"swiglu_gate_bwd {dtype} ({M},{F}) {name}", got,
                       want, TOL[dtype])
                worst["swiglu_gate_bwd"] = max(worst["swiglu_gate_bwd"],
                                               rel_l2(got, want))
                n += 1
        for H, S, d, g in [(2, 128, 64, 1), (1, 256, 32, 1), (2, 128, 160, 1),
                           (1, 100, 256, 1), (6, 100, 128, 3)]:
            q = _randn((H, S, d), dt, 76)
            k, v = (_randn((H // g, S, d), dt, i) for i in (77, 78))
            dout = _randn((H, S, d), dt, 79)
            for kw in (dict(causal=True), dict(causal=True, window=64),
                       dict(causal=False)):
                out, lse, out32 = flash_attention_cuda(
                    q, k, v, kv_group=g, train=True, **kw)
                require(torch.equal(out, out32.to(dt)),
                        "flash's training output is not its float32 one cast")
                _close(f"flash_attention training form {dtype} ({H},{S},{d}) "
                       f"kv_group {g} {kw}", out, ref.flash_attention(
                           q, k, v, kv_group=g, **kw), TOL[dtype])
                got = flash_attention_bwd_cuda(q, k, v, out32, dout, lse,
                                               kv_group=g, **kw)
                want = _grads(lambda a, b, c: ref.flash_attention(
                    a, b, c, kv_group=g, **kw), (q, k, v), dout)
                for name, u, w in zip(("dq", "dk", "dv"), got, want):
                    _close(f"flash_attention_bwd {dtype} ({H},{S},{d}) "
                           f"kv_group {g} {kw} {name}", u, w, TOL[dtype])
                    worst["flash_attention_bwd"] = max(
                        worst["flash_attention_bwd"], rel_l2(u, w))
                    n += 1
        print(f"train kernel rmsnorm_bwd, swiglu_gate_bwd, "
              f"flash_attention_bwd {dtype}: {n} gradients equal to plain "
              f"(autograd of the plain versions) on tests/test_kernels.py's "
              f"shapes, flash at d 32-256, kv_group 1 and 3, causal, window "
              f"64 and full (rtol {TOL[dtype]['rtol']} atol "
              f"{TOL[dtype]['atol']}); worst relative L2 error "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    bf = torch.bfloat16
    worst = 0.0
    for H, S, d, g in [(32, 1024, 160, 4), (16, 1024, 256, 2)]:
        q = _randn((H, S, d), bf, 80)
        k, v = (_randn((H // g, S, d), bf, i) for i in (81, 82))
        dout = _randn((H, S, d), bf, 83)
        kw = dict(causal=True, window=256)
        _, lse, out32 = flash_attention_cuda(q, k, v, kv_group=g,
                                             train=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out32, dout, lse, kv_group=g,
                                       **kw)
        want = _flash_plain_grads(q, k, v, dout, g, kw)
        for name, u, w in zip(("dq", "dk", "dv"), got, want):
            worst = max(worst, _close(
                f"flash_attention_bwd bf16 ({H},{S},{d}) kv_group {g} "
                f"window 256 {name}", u, w, PATH_TOL)[1])
    print(f"train kernel flash_attention_bwd bf16 at (32,1024,160) kv_group "
          f"4 and (16,1024,256) kv_group 2, causal window 256: equal to "
          f"plain within rtol {PATH_TOL['rtol']} atol {PATH_TOL['atol']} "
          f"({worst:.3f} of it at most)")


def bwd_kernel_phase():
    """The backward kernels against their plain gradients on the card,
    deterministic (twice, bitwise), by name in a trace; at the train
    shapes timed beside their plain versions, bounds and yardsticks (in
    turns: kernel, library, kernel, library).  Returns each kernel's JSON
    record minus ``launches``."""
    import torch

    bwd_small_checks()
    records = {}
    for name, label, kern, plain, lib, n_bytes, ops, rate in \
            bwd_kernel_cases():
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        require(all(torch.equal(u, w) for u, w in zip(got, again)),
                f"{name} is not deterministic at {label}")
        want = plain()
        err, share = 0.0, 0.0
        for u, w in zip(got, want):
            e, sh = _close(f"{name} bf16 {label}", u, w, PATH_TOL)
            err, share = max(err, e), max(share, sh)
        del got, again, want
        # the names are held in the train step's trace (train_path_phase);
        # a short window here can come back empty
        names = _traced_names(kern, BWD_KERNEL_NAMES[name])
        seen = [w for w in BWD_KERNEL_NAMES[name]
                if any(w in n for n in names)]
        # about 20 ms of calls a turn, 3 at least
        reps = max(3, min(200, int(20.0 / max(cuda_ms(kern, 1), 1e-3))))
        k_turns, k_devs, l_turns, l_devs = [], [], [], []
        for _ in range(2):
            k_turns.append(cuda_ms(kern, reps))
            k_devs.append(device_ms(kern, reps, BWD_KERNEL_NAMES[name]))
            if lib is not None:
                l_turns.append(cuda_ms(lib, reps))
                l_devs.append(device_ms(lib, reps, LIB_KERNEL_NAMES[name]))
        k_ms, k_dev = _mean(k_turns), _mean(k_devs)
        l_ms = _mean(l_turns) if lib is not None else None
        p_ms = cuda_ms(plain, 1)
        bound, by = _bound(n_bytes, ops, rate)
        lib_txt = "none (no single PyTorch call computes it)" \
            if lib is None else (f"{l_ms:.6f} ms (turns "
                                 f"{_turns_txt(l_turns)}; device "
                                 f"{_turns_txt(l_devs)}; runs "
                                 f"{', '.join(sorted(n[:60] for n in _traced_names(lib, ())))})")
        share_txt = "" if k_dev is None else \
            f", {100 * bound / k_dev:.2f}% of the bound in device time"
        if name == "flash_attention_bwd":
            # the design's own floor: its products at the bf16 peak (the
            # bound counts the function's 5)
            floor = bound * FLASH_BWD_DESIGN_PRODUCTS / 5
            share_txt += (f"; design floor {floor:.6f} ms "
                          f"({FLASH_BWD_DESIGN_PRODUCTS} products with the "
                          f"split)" + ("" if k_dev is None else
                                       f", {100 * floor / k_dev:.2f}% of it"))
        print(f"train kernel {name} {label} bf16: {k_ms:.6f} ms (turns "
              f"{_turns_txt(k_turns)}; {_device_txt(k_dev)}, turns "
              f"{_turns_txt(k_devs)}), plain {p_ms:.6f} ms, bound "
              f"{bound:.6f} ms ({by}){share_txt}, library {lib_txt}; "
              f"deterministic (twice bitwise); max abs err {err:.6g}, "
              f"{share:.3f} of the tolerance (rtol {PATH_TOL['rtol']} atol "
              f"{PATH_TOL['atol']}); kernels seen in its trace: "
              f"{', '.join(seen) or 'none (trace empty)'}")
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{BWD_SOURCE[name]}.cu",
            "replaces": BWD_REPLACES[name], "max_abs_err": err, "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": l_ms, "library_device_ms":
            _mean(l_devs) if lib is not None else None, "shape": label}
    return records


def _history_state(params, seed: int):
    """An optimizer state with history (step 7, moments of the scale past
    gradients leave) shaped like ``params``: from a zero state AdamW's
    first update is the sign of each gradient entry, which float32 noise
    can flip at entries near zero."""
    import torch

    from repro_torch.train.tree import tree_map

    gen = torch.Generator(device="cpu").manual_seed(seed)
    draw = lambda p: torch.randn(p.shape, generator=gen)  # noqa: E731
    return {"m": tree_map(lambda p: (draw(p) * 1e-2).to(p.device), params),
            "v": tree_map(lambda p: ((draw(p) * 1e-2) ** 2 + 1e-6).to(
                p.device), params),
            "step": torch.tensor(7, dtype=torch.int32, device=params[
                "emb"].device)}


def train_path_phase(arch: str):
    """A train run at full width (the fourth main path, once per model of
    ``TRAIN_RUNS``): ``python -m repro_torch.launch.train --arch A --batch
    4 --seq 4096 --steps 4`` on the card (``--layers N`` for a depth cut),
    the launch counters read just around it, then one more step traced.
    Returns the launch counts of the run."""
    import math
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run as train_run
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import batch_to, deterministic

    B, T = TRAIN_SHAPE
    layers = TRAIN_RUNS[arch]
    with tempfile.TemporaryDirectory() as ckpt:
        args = ["--arch", arch, "--batch", str(B), "--seq", str(T),
                "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt,
                "--ckpt-every", "0", "--device", "cuda"]
        if layers is not None:
            args += ["--layers", str(layers)]
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = train_run(args)
        wall = time.perf_counter() - t0
        counts = read_counts()
    for line in buf.getvalue().splitlines():
        print(f"train: {line}")
    cfg = out["cfg"]
    fields = model_fields(arch, layers)
    require({k: getattr(cfg, k) for k in fields} == fields,
            f"not the full-width {arch} config: {cfg}")
    require(cfg.remat == get_config(arch).remat, f"remat {cfg.remat}")
    losses, norms = out["losses"], out["grad_norms"]
    require(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
            f"losses {losses}")
    # the MoE loss adds 0.01 x the aux loss: its nll starts at ln V
    nll = out["metrics"][0].get("nll", losses[0])
    require(abs(nll - math.log(cfg.vocab_size)) < 0.1,
            f"first nll {nll}, ln V = {math.log(cfg.vocab_size)}")
    require(all(map(math.isfinite, norms)), f"grad norms {norms}")
    want = dict.fromkeys(counts, 0)
    want.update(train_launches(cfg, TRAIN_STEPS))
    require(counts == want, f"{arch} train launch counts {counts}, want "
            f"{want}")
    model, opt_state = out["model"], out["opt_state"]
    n_params = sum(p.numel() for p in model.parameters())
    depth = "" if layers is None else \
        f", {layers} of {SERVED[arch]['n_layers']} layers"
    print(f"train: {arch} full width{depth} ({n_params} params, bf16, AdamW "
          f"state {cfg.opt_state_dtype}), batch {B} x {T}, {TRAIN_STEPS} "
          f"steps in {wall:.3f} s (set-up included); first loss "
          f"{losses[0]:.6f}, nll {nll:.6f} (ln V "
          f"{math.log(cfg.vocab_size):.6f}); launches {counts}, exactly "
          f"{TRAIN_STEPS} x train_launches")

    # one more step, traced (its wall time unprofiled just before); every
    # kernel of the path must be in the trace by name (a second traced
    # step if the first comes back without them)
    wanted = train_kernel_names(cfg)
    step_fn = steps_lib.make_train_step(cfg, _run_config(cfg, B, T))
    batch = batch_to(batch_for_step(cfg, out["shape"], 0, TRAIN_STEPS),
                     "cuda", torch.bfloat16)
    with deterministic():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step_fn(model, opt_state, batch)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            names = {e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
            missing = [w for w in wanted if not any(w in n for n in names)]
            if not missing:
                break
    report_trace(prof, f"one train step ({arch}, batch {B} x {T})",
                 wall_ms, traced_ms)
    require(not missing, f"the traced {arch} train step lacks {missing}")
    groups = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        group = next((g for g, keys in TRACE_GROUPS if any(
            key in e.key for key in keys)), "other (elementwise, reductions, "
            "copies)")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile: {arch} train step by kind: {ms:10.3f} ms {n:6d}x "
              f"{group}")
    print(f"train: every kernel of the {arch} path in the traced step by "
          f"name: {', '.join(wanted)}")
    kernel_step_times(arch, cfg, prof)
    del out, model, opt_state, step_fn, batch
    torch.cuda.empty_cache()
    return counts


#: each port kernel's CUDA kernels in a trace, by a part of their names
STEP_KERNEL_KEYS = {"rmsnorm": ("rmsnorm_kernel",),
                    "rmsnorm_bwd": ("rmsnorm_bwd_", "rmsnorm_dscale"),
                    "fused_swiglu": ("fused_swiglu_tc",),
                    "swiglu_gate_bwd": ("swiglu_gate_bwd",),
                    "flash_attention": ("flash_attention_tc",),
                    "flash_attention_bwd": ("flash_bwd_",)}


def kernel_step_times(arch, cfg, prof) -> None:
    """Each port kernel's device time a launch in a traced train step of
    ``cfg`` (its CUDA kernels' time over its launches a step), and
    ``flash_attention_bwd``'s bound at the step's shape (5 products)."""
    from torch.autograd import DeviceType

    B, T = TRAIN_SHAPE
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    for name, n in train_launches(cfg, 1).items():
        ms = sum(e.self_device_time_total for e in events
                 if any(k in e.key for k in STEP_KERNEL_KEYS[name])) / 1e3
        line = (f"train: {arch} {name}: {n} launches a step, {ms / n:.6f} ms "
                f"of device time a launch in the traced step")
        if name == "flash_attention_bwd":
            H, Hkv, d = B * cfg.n_heads, B * cfg.n_kv_heads, \
                cfg.resolved_head_dim
            pairs = H * T * (T + 1) // 2
            bound, by = _bound((4 * H + 4 * Hkv) * T * d * 2 + H * T * 4,
                               10 * d * pairs, BF16_OPS_PER_S)
            line += (f"; bound {bound:.6f} ms ({by}) at ({H}, {T}, {d}) "
                     f"causal kv_group {cfg.n_heads // cfg.n_kv_heads}")
        print(line)


def _run_config(cfg, B: int, T: int):
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeSpec

    return RunConfig(model=cfg, shape=ShapeSpec("train_4k", T, B, "train"),
                     total_steps=10)


#: the train parity slice's depth where not 2 (``PARITY_LAYERS``'s reasons;
#: qwen2_vl_72b one layer: the float32 CPU half of its 2 x 256 slice at 2
#: layers took about 238 s of the script's limit)
TRAIN_PARITY_LAYERS = {"zamba2_1_2b": 7, "whisper_tiny": 4,
                       "qwen2_vl_72b": 1}
#: the train parity slice's batch of 256-token sequences where not 2
#: (qwen2_vl_72b: its 152064-word head is most of its CPU half's work)
TRAIN_PARITY_BATCH = {"qwen2_vl_72b": 1}
#: the train parity slices drawn at the fan-in scale (``fan_in_scaled``):
#: whisper_tiny's full depth is 4, so each stacked weight of its full draw
#: has std 1 / 2 on 384-wide rows, and the CPU's own float32 gradients miss
#: a float64 run by 6% to 13% (relative L2) in every leaf but ln_f
#: (``python3 scripts/train_parity_conditioning.py --arch whisper_tiny
#: --cpu --init-scale``), where the card-vs-CPU comparison tells nothing
TRAIN_PARITY_FAN_IN = ("whisper_tiny",)


def fan_in_scaled(model):
    """``model`` with each normal weight stacked over layers rescaled in
    place from ``init_params``' N(0, 1 / layers) to N(0, 1 / fan-in), its
    second axis."""
    import math

    import torch

    from repro_torch.models import zoo

    def walk(spec, tree):
        for key, s in spec.items():
            if isinstance(s, dict):
                walk(s, tree[key])
            elif s.init == "normal" and s.axes[0] == "layers" \
                    and len(s.shape) >= 3:
                tree[key].mul_(math.sqrt(s.shape[0] / s.shape[1]))

    with torch.no_grad():
        walk(zoo.param_spec(model.cfg), model.params)
    return model


def train_parity_model(arch: str, device: str = "cuda", fan_in=True):
    """The train parity slice of ``arch`` in float32 on ``device``:
    ``TRAIN_PARITY_LAYERS`` deep (2 unless listed), the first layers of
    the full draw for llama3_2_3b (``first_layers``) and as
    ``parity_model`` gives them for the others, ``ssm_chunk``
    ``PARITY_SSM_CHUNK`` for the SSMs (4 chunks of 256 tokens), at the
    fan-in scale for ``TRAIN_PARITY_FAN_IN`` (with ``fan_in``)."""
    import torch

    from repro_torch.configs import get_config

    n = TRAIN_PARITY_LAYERS.get(arch, 2)
    full = get_config(arch)
    if full.family in ("ssm", "hybrid"):
        full = full.replace(ssm_chunk=PARITY_SSM_CHUNK)
    model = first_layers(full, n, torch.float32, device) if arch == TRAINED \
        else parity_model(full, n, device)
    if fan_in and arch in TRAIN_PARITY_FAN_IN:
        fan_in_scaled(model)
    return model


@contextlib.contextmanager
def replayed_moe(dispatch, swaps):
    """The MoE blocks run while the ``with`` block runs take ``dispatch``,
    ``{router data pointer: (top_e, keep, slot)}`` (another device's, by
    layer), in place of their own, with the gate values of those experts
    in their own gates (so the gradient reaches the router as ``route``
    sends it); ``swaps[pointer]`` counts the tokens whose own experts
    differ (float32 noise at a near tie, reported, not held)."""
    import torch

    from repro_torch.models import moe

    real_block, real_route = moe.moe_block, moe.route
    layer = []

    def block(cfg, w, x):
        layer.append(w["router"].data_ptr())
        return real_block(cfg, w, x)

    def route(gates, top_k, capacity):
        top_e, keep, slot = (t.to(gates.device) for t in dispatch[layer[-1]])
        own = real_route(gates, top_k, capacity)[1]
        swaps[layer[-1]] = int((own != top_e).any(-1).sum())
        top_w = gates.gather(-1, top_e)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        return top_w, top_e, keep, slot

    moe.moe_block, moe.route = block, route
    try:
        yield
    finally:
        moe.moe_block, moe.route = real_block, real_route


def train_parity_phase(arch: str) -> None:
    """The card (kernels) against the CPU (plain versions) in float32 at
    full width, batch 2 x 256 (``TRAIN_PARITY_BATCH``), on
    ``train_parity_model``: the loss within
    ``PARITY_TOL``, each gradient leaf within ``GRAD_REL_TOL`` relative L2
    error, the params after one AdamW step within ``PARITY_TOL``.  For an
    MoE model the card's dispatch of each layer, recorded in the forward,
    must equal its recompute's in the backward, and the CPU replays it
    (``replayed_moe``)."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import zoo
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import batch_to
    from repro_torch.train.tree import items, tree_map

    card = train_parity_model(arch)
    cfg = card.cfg
    n = cfg.n_layers
    cpu = zoo.build(cfg, tree_map(lambda t: t.cpu(), card.params))
    B = TRAIN_PARITY_BATCH.get(arch, 2)
    batch = batch_for_step(cfg, ShapeSpec("parity", 256, B, "train"), SEED, 0)
    ocfg = steps_lib.adamw_config(cfg, _run_config(cfg, B, 256))

    results, swaps, dispatch, note = {}, {}, {}, ""
    for where, model in (("cuda", card), ("cpu", cpu)):
        if where == "cuda":
            ctx = recorded_moe()
        elif dispatch:  # the CPU model's router of each layer
            ctx = replayed_moe({cpu.layers[i]["moe"]["router"].data_ptr(): d
                                for i, d in dispatch.items()}, swaps)
        else:
            ctx = contextlib.nullcontext()
        with ctx as calls:
            loss, _, grads = steps_lib.value_and_grad(
                cfg, model, batch_to(batch, where, torch.float32))
        if where == "cuda" and cfg.family == "moe":
            L = cfg.n_layers
            require(len(calls) == 2 * L, f"{len(calls)} MoE blocks in a "
                    f"{cfg.remat} step, want {2 * L}")
            # the backward recomputes the blocks last layer first
            for i, (fwd, again) in enumerate(zip(calls[:L],
                                                 reversed(calls[L:]))):
                require(all(torch.equal(a, b) for a, b in zip(
                    fwd["dispatch"][1:], again["dispatch"][1:])),
                    f"{arch} layer {i}: the backward's recompute routed "
                    f"otherwise than the forward")
                dispatch[i] = tuple(t.cpu() for t in fwd["dispatch"][1:])
        # AdamW reads the gradient tree and leaves it as it is; no copy
        # (qwen2_vl's 2 layers hold 12 GB of float32 params, as much
        # gradient and twice that in moments on each side)
        state = _history_state(model.params, SEED)
        opt_lib.apply_updates(model.params, grads, state, ocfg)
        results[where] = (loss, grads, model.params)
        del state
    if swaps:
        note = (f"; the CPU replays the card's dispatch (recomputed in the "
                f"backward as routed in the forward), its own float32 "
                f"routes differ in {sum(swaps.values())} token(s) over "
                f"{len(swaps)} layers (not held)")
    (lc, gc, pc), (lh, gh, ph) = results["cuda"], results["cpu"]
    err = _close(f"{arch} train parity loss (f32, {n} layers)", lc.cpu(), lh,
                 PARITY_TOL)[0]
    rels = {key: (torch.linalg.vector_norm(a.cpu() - b)
                  / torch.linalg.vector_norm(b)).item()
            for (key, a), (_, b) in zip(items(gc), items(gh))}
    print(f"parity: {arch} gradient relative L2 error, card vs CPU: "
          + ", ".join(f"{key} {rel:.3g}" for key, rel in rels.items()))
    worst_key = max(rels, key=rels.get)
    worst_rel = rels[worst_key]
    require(worst_rel <= GRAD_REL_TOL, f"{arch} train parity gradient "
            f"{worst_key}: relative L2 error {worst_rel:.3g} > "
            f"{GRAD_REL_TOL}")
    p_err = max(_close(f"{arch} train parity params/{key} after one AdamW "
                       f"step", a.cpu(), b, PARITY_TOL)[0]
                for (key, a), (_, b) in zip(items(pc), items(ph)))
    depth = f"{n} layers" if cfg.family != "encdec" else \
        f"{cfg.n_enc_layers} + {n} layers, {cfg.enc_seq} audio frames"
    print(f"parity: {arch} train step full width, {depth}, f32, batch {B} x "
          f"256: loss {lc.item():.6f} (card) vs {lh.item():.6f} (CPU), diff "
          f"{err:.3g} (rtol {PARITY_TOL['rtol']} atol {PARITY_TOL['atol']}); "
          f"every gradient leaf within {GRAD_REL_TOL} relative L2 (worst "
          f"{worst_rel:.3g}, {worst_key}); params after one AdamW step max "
          f"abs diff {p_err:.3g}{note}")
    del card, cpu, results
    torch.cuda.empty_cache()


def train_smoke_phase() -> None:
    """At smoke width on the card, as ``tests/test_torch_train.py`` runs
    them on the CPU: the loss falls on a repeated batch; a run resumed from
    a checkpoint is bit-identical to a straight one; the injected failure
    is retried; a kernel's refused launch propagates out of the loop; the
    grad-accumulation step agrees with one large step."""
    import tempfile

    import numpy as np
    import torch

    import repro_torch.train.loop as loop
    from repro_torch.configs import RunConfig, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import fused_swiglu as fs
    from repro_torch.models import zoo
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.tree import items

    cfg = smoke_config(TRAINED)
    shape = ShapeSpec("smoke", 32, 2, "train")
    with tempfile.TemporaryDirectory() as tmp:
        run = lambda name, **kw: RunConfig(  # noqa: E731
            model=cfg, shape=shape, checkpoint_dir=os.path.join(tmp, name),
            **{"checkpoint_every": 0, "total_steps": 30, **kw})
        real = loop.batch_for_step
        loop.batch_for_step = lambda c, s, seed, step: real(c, s, seed, 0)
        try:
            out = loop.train(run("drop", learning_rate=1e-2, warmup_steps=2,
                                 total_steps=24), steps=20, device="cuda")
        finally:
            loop.batch_for_step = real
        drop = np.mean(out["losses"][:5]) - np.mean(out["losses"][-5:])
        require(drop > 1.0, f"loss fell by {drop:.4f} on a repeated batch")

        straight = loop.train(run("a", checkpoint_every=4), steps=8,
                              device="cuda")
        loop.train(run("b", checkpoint_every=4), steps=4, device="cuda")
        resumed = loop.train(run("b", checkpoint_every=4), steps=8,
                             device="cuda")
        require(resumed["losses"] == straight["losses"][4:],
                f"resumed losses {resumed['losses']} vs "
                f"{straight['losses'][4:]}")
        for tree in ("params", "opt_state"):
            for (key, a), (_, b) in zip(items(straight[tree]),
                                        items(resumed[tree])):
                require(torch.equal(a, b), f"resume: {tree}/{key} differs")

        boom = {"armed": True}

        def fail_once(step):
            if step == 2 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected node failure")

        out = loop.train(run("retry"), steps=4, fail_hook=fail_once,
                         device="cuda")
        require(out["final_step"] == 4 and len(out["losses"]) == 4
                and not boom["armed"], "the injected failure was not retried")

        real_route = fs.route
        fs.route = lambda *a, **kw: 7  # a route code the C entry refuses
        refusal = "none"
        try:
            loop.train(run("refused"), steps=3, device="cuda")
        except RuntimeError as e:
            refusal = str(e)
        finally:
            fs.route = real_route
        require("fused_swiglu launch failed" in refusal,
                f"a refused fused_swiglu launch did not propagate out of the "
                f"loop (raised: {refusal})")

    f32 = cfg.replace(n_layers=1)
    base = ShapeSpec("s", 32, 4, "train")
    full = batch_for_step(f32, base, 1, 0)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    models = []
    for accum in (1, 2):
        model = zoo.init_model(f32, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda", torch.float32)
        state = _history_state(model.params, 5)
        r = RunConfig(model=f32, shape=base, grad_accum=accum, **kw)
        if accum == 1:
            step = steps_lib.make_train_step(f32, r)
            batch = full
        else:
            step = steps_lib.make_grad_accum_step(f32, r)
            batch = {k: v.reshape((2, 2) + v.shape[1:])
                     for k, v in full.items()}
        _, _, metrics = step(model, state, loop.batch_to(batch, "cuda",
                                                         torch.float32))
        models.append((model, metrics))
    for (key, a), (_, b) in zip(items(models[0][0].params),
                                items(models[1][0].params)):
        _close(f"grad accum vs one step: params/{key}", b, a, PARITY_TOL)
    _close("grad accum vs one step: loss", models[1][1]["loss"],
           models[0][1]["loss"], PARITY_TOL)
    print(f"train smoke (card, {TRAINED} smoke width): loss fell {drop:.4f} "
          f"over 20 steps on a repeated batch; resume from step 4 "
          f"bit-identical to a straight 8-step run (losses, params, AdamW "
          f"state); the injected failure retried; a refused launch "
          f"propagated ({refusal}); 2 x 2 grad accumulation equal to one "
          f"step of 4 in float32 (rtol {PARITY_TOL['rtol']} atol "
          f"{PARITY_TOL['atol']})")


def build_all(root: str) -> None:
    """Every kernel's nvcc build, one process each, all started together."""
    from repro_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(one, KERNELS))
    for name, lib, secs in built:
        _build.load(name)
        print(f"build: {name} {secs:.3f} s ({os.path.relpath(lib, root)})")
        with open(f"{lib}.log") as f:
            for line in f.read().splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line or "wgmma" in line):
                    print(f"build: {line.strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # the train path runs with deterministic algorithms, which need cuBLAS's
    # deterministic workspace from its first use in the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the plain versions' float32 products in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build_all(ROOT)
    print(f"phase: build {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    mappings = corpus_mappings()
    from repro_torch.sim.batch import prepare_batch
    pb = prepare_batch(mappings, iterations=3, device="cpu").packed
    alu = kernel_phase(pb.opcode.shape)
    loop, verify, eager = path_phase(mappings)
    loop["launches"] = verify["sim_loop"]
    # sim_alu is off the verify path; it runs on the eager yardstick only
    alu["launches"] = verify["sim_alu"]
    alu["launches_by_path"] = {"verify": verify["sim_alu"],
                               "eager yardstick": eager["sim_alu"]}
    fail_phase(mappings)
    print(f"phase: verify path (sim_loop; sim_alu on the eager yardstick) "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    loop["launches_by_path"] = {"verify": verify["sim_loop"],
                                **store_phase()}
    print(f"phase: store (verify --dir, verifying gets, energy_sweep, "
          f"motifs) {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    loop["launches_by_path"]["compile"] = compile_phase()
    print(f"phase: compile (the TABLE2 grid through the CLI, store get and "
          f"warm, card vs CPU) {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    swept, sweep_dir, results = collect_phase()
    loop["launches_by_path"]["collect"] = swept
    print(f"phase: collect (the TABLE2 sweep, supervised; resume, chaos) "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    try:
        loop["launches_by_path"]["farm"] = farm_phase(sweep_dir, results)
    finally:
        shutil.rmtree(sweep_dir, ignore_errors=True)
    print(f"phase: farm (serve, collect --remote, compile --remote, drain) "
          f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    records = lm_kernel_phase()
    print(f"phase: LM kernels {time.perf_counter() - t0:.3f} s")
    counts = {}
    for arch in SERVED:
        t0 = time.perf_counter()
        counts[f"serve {arch}"] = serve_phase(
            arch, decode_check=arch == "llama3_2_3b")
        print(f"phase: serve path {arch} {time.perf_counter() - t0:.3f} s")
    for arch in SERVED:
        t0 = time.perf_counter()
        parity_phase(arch)
        print(f"phase: card vs CPU parity {arch} "
              f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    motif = motif_phase()
    track_a_phase()
    print(f"phase: motif kernel and Track-A tie "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    counts["ops"] = ops_phase()
    print(f"phase: ops path {time.perf_counter() - t0:.3f} s")
    motif["launches"] = counts["ops"]["motif_pcu"]

    t0 = time.perf_counter()
    bwd = bwd_kernel_phase()
    print(f"phase: train kernels {time.perf_counter() - t0:.3f} s")
    for arch in TRAIN_RUNS:
        t0 = time.perf_counter()
        counts[f"train {arch}"] = train_path_phase(arch)
        train_parity_phase(arch)
        print(f"phase: train path and parity {arch} "
              f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    train_smoke_phase()
    print(f"phase: train smoke-width runs {time.perf_counter() - t0:.3f} s")
    for name, rec in records.items():
        rec["launches"] = counts["serve llama3_2_3b"][name]
        rec["launches_by_path"] = {path: c[name] for path, c in counts.items()}
    for name, rec in bwd.items():
        rec["launches"] = counts[f"train {TRAINED}"][name]
        rec["launches_by_path"] = {path: c[name] for path, c in counts.items()}

    print(json.dumps({"kernels": [alu, loop, *records.values(), motif,
                                  *bwd.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--count-worker"] and sys.argv[4:5] == ["--"]:
        sys.exit(count_worker(sys.argv[2], sys.argv[3], sys.argv[5:]))
    sys.exit(main())
