#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc/`` with ``nvcc``;
2. kernel phase: each kernel against its plain PyTorch version on the
   card, on every opcode, at (1,1), (7,129), the corpus bucket's (B,N) and
   (4096,4096) — results must be bitwise equal; kernel and plain times;
3. path phase: ``python -m repro_torch verify`` over the whole TABLE2
   corpus on ``cuda`` (the main path, with the launch counters read just
   around it).  Every artifact's verdict must equal the corpus manifest's
   (the JAX package's own verdict), and the cycle loop's ``val``/``done``/
   ``fail`` on the card must equal a CPU run of the port; then a
   ``torch.profiler`` trace of one warm run (device busy share, top kernels);
4. fail phase: a corrupted mapping (dropped route) must FAIL on the card
   with the same reason as on the CPU.

Then one JSON line per kernel (``{"kernels": [...]}``) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
#: H100 SXM HBM3 rate (NVIDIA data sheet), for the memory bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12
#: sim_alu moves one int32 opcode + four float32 operands in and one
#: float32 result out per element
SIM_ALU_BYTES_PER_ELEM = 24
SIM_ALU_SOURCE = "src/repro_torch/kernels/csrc/sim_alu.cu"
SIM_ALU_REPLACES = "src/repro/kernels/sim_alu.py:53"


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


def path_phase(mappings):
    """The main path on the card; returns the sim_alu launch count."""
    import numpy as np

    from repro_torch import CORPUS_DIR
    from repro_torch.compiler.cli import main as cli_main
    from repro_torch.kernels.sim_alu import sim_alu_cuda
    from repro_torch.sim.batch import prepare_batch
    from repro_torch.sim.step import run_bucket

    with open(os.path.join(CORPUS_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    buf = io.StringIO()
    sim_alu_cuda.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["verify", CORPUS_DIR, "--device", "cuda"])
    launches = sim_alu_cuda.launches
    text = buf.getvalue()
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
    for fn, want in manifest["files"].items():
        label = fn[:-len(".json")].replace("__", "/")
        require(label in got, f"verify printed no verdict for {label}")
        word, detail = got[label]
        require(word == want["verdict"],
                f"{label}: {word} on the card, {want['verdict']} in the "
                f"manifest ({detail})")
        if word == "OK":
            require(detail == f"{want['segments']} mapping(s) verified",
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
    dev = run_bucket(pb)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        dev2 = run_bucket(pb)
    per_cycle_ms = (time.perf_counter() - t0) / reps / pb.hmax * 1e3
    for name, x, y, z in zip(("val", "done", "fail"), dev, cpu, dev2):
        require(np.array_equal(x, y), f"{name} on the card differs from "
                                      "the CPU run of the port")
        require(np.array_equal(x, z), f"{name} differs between two runs "
                                      "on the card")
    require(bool(np.isfinite(dev[0]).all()), "non-finite values")
    B, N, K, M, S = pb.shape
    print(f"path: verify over {len(manifest['files'])} artifacts, "
          f"{len(mappings)} mappings; bucket (B,N,K,M,S)=({B},{N},{K},{M},"
          f"{S}), hmax {pb.hmax}; verdicts OK {counts['OK']} FAIL "
          f"{counts['FAIL']} SKIP {counts['SKIP']} = manifest")
    print(f"path: {summary[0]}")
    print(f"path: val/done/fail on the card equal the CPU run; warm cycle "
          f"loop {per_cycle_ms:.6f} ms/cycle ({pb.hmax} cycles); sim_alu "
          f"launches {launches} (cold + warm run, 2 x hmax)")
    profile_run(pb, per_cycle_ms * pb.hmax)
    require(launches == 2 * pb.hmax,
            f"sim_alu launched {launches} times, want 2 x hmax = "
            f"{2 * pb.hmax}")
    return launches


def profile_run(pb, warm_ms: float) -> None:
    """Where one warm run of the cycle loop spends device time
    (``torch.profiler``): device busy time against the unprofiled warm
    wall time, and the sim_alu kernel's own device time per launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim.step import run_bucket

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_bucket(pb)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("profile: no device time in the trace (not measured)")
        return
    alu = [e for e in kernels if "sim_alu_kernel" in e.key]
    alu_us = (sum(e.self_device_time_total for e in alu)
              / max(sum(e.count for e in alu), 1))
    print(f"profile: one warm run, device busy {busy_ms:.6f} ms of "
          f"{warm_ms:.6f} ms wall ({100 * busy_ms / warm_ms:.2f}% busy); "
          f"{sum(e.count for e in kernels)} kernels; sim_alu_kernel "
          f"{alu_us:.3f} us/launch")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3:9.6f} ms "
              f"{e.count:5d}x {e.key[:90]}")


def fail_phase(mappings):
    from repro_torch.sim.batch import simulate_batch

    bad = copy.deepcopy(next(m for m in mappings if m.routes))
    bad.routes.pop(next(iter(bad.routes)))
    v_dev = simulate_batch([bad], iterations=3, device="cuda")[0]
    v_cpu = simulate_batch([bad], iterations=3, device="cpu")[0]
    require(not v_dev.ok and "not present at read time" in v_dev.reason,
            f"dropped route not caught on the card: {v_dev!r}")
    require((v_dev.ok, v_dev.reason) == (v_cpu.ok, v_cpu.reason),
            f"card {v_dev!r} vs CPU {v_cpu!r}")
    print(f"fail: dropped route FAILs on the card as on the CPU: "
          f"{v_dev.reason}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    lib = _build.build("sim_alu")
    _build.load("sim_alu")
    print(f"build: sim_alu {time.perf_counter() - t0:.3f} s "
          f"({os.path.relpath(lib, ROOT)})")
    with open(f"{lib}.log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")

    mappings = corpus_mappings()
    from repro_torch.sim.batch import prepare_batch
    pb = prepare_batch(mappings, iterations=3, device="cpu").packed
    record = kernel_phase(pb.opcode.shape)
    record["launches"] = path_phase(mappings)
    fail_phase(mappings)

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
