"""The training entry: one training step of the program at a time, in a
closed loop, as ``repro_torch.train.loop.train`` drives it.

Set-up builds the step of ``repro_torch.train.steps.make_train_step`` with
its model (``repro_torch.models.zoo.build`` around the benchmark's
weights) and its AdamW state (``train.optimizer.init_opt_state``), and
drives it under ``train.loop.deterministic()`` through the first
``compared_steps`` steps, on rows that all differ: those steps warm up
every shape and are what the reference follows.  The window goes on with
the same objects, one device sync a step, until ``--seconds`` have passed;
``train_tokens_per_s`` is the tokens of every step over the time from the
window's start to the end of its last step.  With ``--trace 1`` a fixed
number of further steps run under ``torch.profiler``."""
from __future__ import annotations

import math
import time
from typing import Dict

import torch

from bench.harness import cells, compare, program, traffic, weights
from bench.harness.trace import summarize
from bench.reference import train as ref_train


def _feed(mix: Dict, seed: int, step: int, vocab: int, device):
    rows = traffic.train_batch(mix, seed, step, vocab)
    return {k: torch.from_numpy(v).to(device) for k, v in rows.items()}


def _norms(tree) -> Dict[str, float]:
    """Each leaf's float32 norm, a stacked leaf slice by slice."""
    out = {}
    for path, t in weights.leaves(tree):
        parts = t.unbind(0) if t.dim() >= 3 else (t,)
        out[path] = math.sqrt(sum(
            float(torch.linalg.vector_norm(p.float())) ** 2 for p in parts))
    return out


def _change(tree, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's float32 norm of its change from ``start`` (leaf path ->
    the leaf as it was, on the host)."""
    out = {}
    for path, t in weights.leaves(tree):
        t0 = start[path]
        parts = zip(t.unbind(0), t0.unbind(0)) if t.dim() >= 3 else \
            ((t, t0),)
        out[path] = math.sqrt(sum(
            float(torch.linalg.vector_norm(
                p.float() - p0.to(p.device).float())) ** 2
            for p, p0 in parts))
    return out


class Run:
    """One cell's program side: set-up, window, traced steps."""

    def __init__(self, cell: cells.Cell, seed: int, device,
                 test: bool = False):
        from repro_torch.configs import RunConfig
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.models import zoo
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train import steps as steps_lib
        from repro_torch.train.loop import deterministic

        self.device, self.seed = torch.device(device), seed
        self.conf = cells.as_run(cell.config, "train", test)
        self.mix = cells.traffic_as_run(cell.traffic, test)
        self.deterministic = deterministic
        opt = self.mix["optimizer"]
        self.cfg = program.model_config(self.conf, test)
        B, T = self.mix["batch"], self.mix["seq"]
        run = RunConfig(model=self.cfg,
                        shape=ShapeSpec(self.mix["name"], T, B, "train"),
                        learning_rate=opt["learning_rate"],
                        warmup_steps=opt["warmup_steps"],
                        total_steps=opt["total_steps"],
                        weight_decay=opt["weight_decay"],
                        grad_clip=opt["grad_clip"], checkpoint_every=0,
                        seed=seed)
        ocfg = steps_lib.adamw_config(self.cfg, run)
        stated = {k: opt[k] for k in ("b1", "b2", "eps")}
        if {k: getattr(ocfg, k) for k in stated} != stated:
            raise RuntimeError(f"the program's AdamW {ocfg} departs from "
                               f"the traffic's {opt}")
        program.phase("imports and config", self.device)
        self.spec = zoo.param_spec(self.cfg)
        self.params = weights.make(self.spec, seed, self.device)
        self.model = zoo.build(self.cfg, self.params)
        self.opt_state = opt_lib.init_opt_state(self.model.params, ocfg)
        self.step_fn = steps_lib.make_train_step(self.cfg, run)
        program.phase("weights, model and optimizer state", self.device)
        self.step = 0
        self.losses = []
        with deterministic():
            # the starting weights wait on the host, out of the card's peak
            start = {p: t.to("cpu", copy=True)
                     for p, t in weights.leaves(self.params)}
            for _ in range(self.mix["compared_steps"]):
                metrics = self._step()
                self.losses.append(float(metrics["loss"]))
                if self.step == 1:
                    self.grad_norms = {
                        p: n / (1 - ocfg.b1)
                        for p, n in _norms(self.opt_state["m"]).items()}
            self.change_norms = _change(self.params, start)
            del start
        program.phase("the compared steps", self.device)

    def _step(self):
        batch = _feed(self.mix, self.seed, self.step, self.cfg.vocab_size,
                      self.device)
        self.model, self.opt_state, metrics = self.step_fn(
            self.model, self.opt_state, batch)
        self.step += 1
        return metrics

    def readings(self) -> Dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    def window(self, seconds: float) -> Dict:
        """Steps until ``seconds`` have passed; the tokens a second over
        all of them."""
        B, T = self.mix["batch"], self.mix["seq"]
        losses = []
        with self.deterministic():
            t0 = program.sync(self.device)
            t1 = t0
            while t1 - t0 < seconds:
                losses.append(self._step()["loss"])
                t1 = program.sync(self.device)
        finite = [math.isfinite(float(v)) for v in losses]
        self.window_steps, self.window_s = len(losses), t1 - t0
        return {"attempted": len(losses), "failed": finite.count(False),
                "train_tokens_per_s": len(losses) * B * T / (t1 - t0)}

    def traced(self) -> Dict:
        """A fixed number of further steps under the profiler; the
        per-layer readers' context."""
        from torch.profiler import ProfilerActivity, profile

        n = self.mix["traced_steps"]
        with self.deterministic():
            self._step()  # the profiler's own set-up is not traced
            program.sync(self.device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = program.sync(self.device)
                for _ in range(n):
                    self._step()
                t1 = program.sync(self.device)
        return {"trace": summarize(prof, t1 - t0), "entry": "train",
                "conf": self.conf, "traffic": self.mix, "steps": n,
                "batch": self.mix["batch"], "seq": self.mix["seq"]}

    def release(self) -> None:
        del self.model, self.opt_state, self.step_fn, self.params
        program.free(self.device)

    def reference(self, quant=None) -> Dict:
        """The reference's readings over the same first steps, from the
        same weights drawn again."""
        params = weights.make(self.spec, self.seed, self.device)
        batches = [_feed(self.mix, self.seed, s, self.cfg.vocab_size,
                         self.device)
                   for s in range(self.mix["compared_steps"])]
        out = ref_train.run(self.conf, params, batches,
                            self.mix["optimizer"], quant)
        del params, batches
        program.free(self.device)
        return out


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    return compare.train_numbers(prog, ref)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        test: bool = False) -> Dict:
    """One run of the cell: set-up, window, traced steps, then the
    comparison; ``setup_done`` is the host clock at the window's start."""
    r = Run(cell, seed, device, test)
    setup_done = time.perf_counter()
    out = r.window(seconds)
    ctx = r.traced() if trace else None
    peak = program.memory_peak(device)
    prog = r.readings()
    r.release()
    ref = r.reference()
    nums = numbers(prog, ref)
    return {"setup_done": setup_done, "e2e": {
        "train_tokens_per_s": out["train_tokens_per_s"]},
        "attempted": out["attempted"], "failed": out["failed"],
        "memory_peak_bytes": peak, "numbers": nums, "ctx": ctx}


#: the faults a training cell can have (``bench.harness.faults``)
FAULTS = ("state_unchanged", "half_batch")


def control(cell: cells.Cell, seed: int, device, test: bool = False):
    """The control's numbers: the reference computed in float8 in the
    program's place, against the float32 reference, over the same first
    steps from the same weights."""
    from repro_torch.models import zoo

    conf = cells.as_run(cell.config, "train", test)
    mix = cells.traffic_as_run(cell.traffic, test)
    cfg = program.model_config(conf, test)
    spec = zoo.param_spec(cfg)
    batches = [_feed(mix, seed, s, cfg.vocab_size, device)
               for s in range(mix["compared_steps"])]
    params = weights.make(spec, seed, device)
    ref = ref_train.run(conf, params, batches, mix["optimizer"])
    ctl = ref_train.run(conf, params, batches, mix["optimizer"], "fp8")
    del params
    program.free(device)
    return numbers(ctl, ref)
