"""One run of one cell: the entry's set-up, window and comparison, then
the result line's fields: the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), the device, and every compared number
beside its limit."""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict

import torch

from bench.harness import cells, compare, trace as trace_lib


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``not measured``."""
    smi = shutil.which("nvidia-smi")
    if not smi:
        return "not measured"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not measured"


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, test: bool = False) -> Dict:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = cells.entry_module(cell).run(cell, seed, seconds, trace, device,
                                       test)
    e2e = {"setup_s": res["setup_done"] - t_start, **res["e2e"]}
    metrics: Dict[str, Dict] = {}
    if trace:
        ctx = res["ctx"]
        for m in cell.per_layer:
            value = cells.metric_reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {}
    if trace:
        t = res["ctx"]["trace"]
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
    if device.type == "cuda":
        dev["power"] = power_limit()
    checks = compare.checks(res["numbers"],
                            cell.limits["test"] if test else cell.limits)
    out.update(correct=compare.passed(checks) and res["failed"] == 0,
               attempted=res["attempted"], failed=res["failed"],
               metrics=metrics, device=dev)
    if trace:
        out["breakdown"] = trace_lib.breakdown(res["ctx"]["trace"])
        out["groups_s"] = trace_lib.by_group(res["ctx"]["trace"])
    out["checks"] = checks
    out["e2e"] = e2e
    return out
