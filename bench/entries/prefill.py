"""The prefill entry: batches of prompts through
``repro_torch.serve.loop.generate(cfg, model, prompts, max_new_tokens)``,
one batch at a time, each due at a fixed rate from the window's start (an
open loop: a batch that finds the program busy waits, and its time to
first token counts the wait).

A batch's prompts share one length (``generate`` takes one a batch), as
:func:`bench.harness.traffic.prefill_length` gives it; set-up warms up
each length of the mix once.  ``ttft_p95_ms`` is the 95th
percentile (nearest rank) over every request of the window of the time
from its batch's due time to its first token on the host;
``prefill_tokens_per_s`` is the prompt tokens of every batch over the time
from the window's start to the end of its last batch.  The window serves
every batch due before ``--seconds`` (with no rate: every batch started
before ``--seconds``).  With ``--trace 1`` one further block of batches
runs back to back under ``torch.profiler``.

For the comparison the served tokens, the last-position logits and the
cache the prefill wrote are kept for the sampled batches, drawn over the
whole window (:func:`bench.harness.traffic.sample_batches`)."""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from bench.harness import cells, compare, program, traffic, weights
from bench.harness.trace import summarize
from bench.reference import prefill as ref_prefill


class Run:
    def __init__(self, cell: cells.Cell, seed: int, device,
                 test: bool = False):
        from repro_torch.models import zoo

        self.device, self.seed = torch.device(device), seed
        self.conf = cells.as_run(cell.config, "serve", test)
        self.mix = cells.traffic_as_run(cell.traffic, test)
        self.cfg = program.model_config(self.conf, test)
        program.phase("imports and config", self.device)
        self.params = weights.make(zoo.param_spec(self.cfg), seed,
                                   self.device)
        self.model = zoo.build(self.cfg, self.params)
        program.phase("weights and model", self.device)
        self.sample: set = set()
        self.kept: Dict[int, tuple] = {}
        self.served: Dict[int, torch.Tensor] = {}
        self.keep = None
        prefill = self.model.prefill

        def kept_prefill(batch):
            cache, logits = prefill(batch)
            if self.keep is not None:
                self.kept[self.keep] = (logits, cache["k"], cache["v"])
            return cache, logits

        self.model.prefill = kept_prefill
        for i, length in enumerate(sorted(set(traffic.length_set(self.mix)))):
            self._serve(self._prompts(i, length, traffic.WARM))
        program.phase("warm-up of every length", self.device)

    def _prompts(self, i: int, length: int, stream=traffic.PROMPT):
        return torch.from_numpy(traffic.prompts(
            self.mix, self.seed, i, length, self.cfg.vocab_size, stream))

    def _serve(self, prompts: torch.Tensor) -> torch.Tensor:
        from repro_torch.serve import loop as serve_loop

        toks, info = serve_loop.generate(
            self.cfg, self.model, prompts.to(self.device),
            max_new_tokens=self.mix["new_tokens"])
        self.finite = info["logits_finite"]
        return toks.cpu()

    def window(self, seconds: float) -> Dict:
        B = self.mix["batch"]
        rate = self.mix.get("rate_batches_per_s")
        if rate:
            self.sample = set(traffic.sample_batches(
                self.mix, self.seed, traffic.window_batches(self.mix,
                                                            seconds)))
        ttft: List[float] = []
        tokens, failed, i = 0, 0, 0
        t0 = program.sync(self.device)
        end = t0
        while True:
            if rate:
                if traffic.arrival_s(self.mix, i) >= seconds:
                    break
                due = t0 + traffic.arrival_s(self.mix, i)
            else:
                due = time.perf_counter()
                if due - t0 >= seconds:
                    break
            length = traffic.prefill_length(self.mix, i)
            prompts = self._prompts(i, length)
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.last_late_s = time.perf_counter() - due
            self.keep = i if i in self.sample else None
            toks = self._serve(prompts)
            end = time.perf_counter()
            if self.keep is not None:
                self.served[i] = toks
            failed += 0 if self.finite else B
            ttft += [end - due] * B
            tokens += B * length
            i += 1
        self.keep = None
        self.next_batch = i
        ranked = sorted(ttft)
        p95 = ranked[max(math.ceil(0.95 * len(ranked)) - 1, 0)]
        return {"attempted": len(ttft), "failed": failed,
                "ttft_p95_ms": 1e3 * p95,
                "prefill_tokens_per_s": tokens / (end - t0)}

    def traced(self) -> Dict:
        from torch.profiler import ProfilerActivity, profile

        n = self.mix["traced_batches"]
        first = self.next_batch
        lengths = [traffic.prefill_length(self.mix, first + j)
                   for j in range(n)]
        batches = [self._prompts(first + j, L) for j, L in enumerate(lengths)]
        self._serve(batches[0])  # the profiler's own set-up is not traced
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = program.sync(self.device)
            for p in batches:
                self._serve(p)
            t1 = program.sync(self.device)
        return {"trace": summarize(prof, t1 - t0), "entry": "prefill",
                "conf": self.conf, "traffic": self.mix,
                "batches": [(self.mix["batch"], L) for L in lengths]}

    def release(self) -> None:
        del self.model
        program.free(self.device)

    def sampled(self):
        """(batch index, prompts on the device) of each sampled batch that
        the window served."""
        for i in sorted(self.served):
            length = traffic.prefill_length(self.mix, i)
            yield i, self._prompts(i, length).to(self.device)

    def numbers(self) -> Dict[str, float]:
        """The program's kept outputs against the reference: ``token_gap``
        (the served tokens), ``logit_err`` (the last position's logits)
        and ``kv_err`` (every layer's cache)."""
        gaps, lerr, kverr = [], [], []
        if set(self.served) != self.sample:
            return {}
        emb = self.params["emb"]
        for i, prompts in self.sampled():
            logits, kc, vc = self.kept.pop(i)
            out = None
            for j, got in enumerate(ref_prefill.layers(
                    self.conf, self.params, prompts)):
                if len(got) == 1:
                    out = got[0]
                    break
                k, v = got
                kverr.append(max(compare.rel_err(kc[j], k),
                                 compare.rel_err(vc[j], v)))
            ref = ref_prefill.logits(out[:, -1], emb)
            lerr.append(compare.logit_err(logits[:, -1], ref))
            gaps.append(compare.token_gap(ref, self.served[i][:, 0].to(
                self.device)))
            del kc, vc, logits, out, ref
            program.free(self.device)
        return {"token_gap": max(gaps), "logit_err": max(lerr),
                "kv_err": max(kverr)}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        test: bool = False) -> Dict:
    r = Run(cell, seed, device, test)
    setup_done = time.perf_counter()
    out = r.window(seconds)
    ctx = r.traced() if trace else None
    peak = program.memory_peak(device)
    r.release()
    nums = r.numbers()
    return {"setup_done": setup_done,
            "e2e": {k: out[k] for k in ("ttft_p95_ms",
                                        "prefill_tokens_per_s")},
            "attempted": out["attempted"], "failed": out["failed"],
            "memory_peak_bytes": peak, "numbers": nums, "ctx": ctx}


#: the faults a prefill cell can have (``bench.harness.faults``)
FAULTS = ("token_altered",)


@torch.no_grad()
def control(cell: cells.Cell, seed: int, device, test: bool = False,
            seconds: float = 0.0):
    """The control's numbers: the reference computed in float8 in the
    program's place, against the float32 reference, on the prompts of the
    batches a window of ``seconds`` (default: the benchmark's
    ``run_seconds``) samples: the last position's logits, every layer's
    keys and values, and at each position the gap of the token float8
    puts first."""
    from repro_torch.models import zoo

    device = torch.device(device)
    conf = cells.as_run(cell.config, "serve", test)
    mix = cells.traffic_as_run(cell.traffic, test)
    cfg = program.model_config(conf, test)
    params = weights.make(zoo.param_spec(cfg), seed, device)
    emb = params["emb"]
    gaps, lerr, kverr = [], [], []
    n = traffic.window_batches(mix, seconds or cells.benchmark()[
        "run_seconds"])
    for i in traffic.sample_batches(mix, seed, n):
        length = traffic.prefill_length(mix, i)
        prompts = torch.from_numpy(traffic.prompts(
            mix, seed, i, length, cfg.vocab_size)).to(device)
        for a, b in zip(ref_prefill.layers(conf, params, prompts),
                        ref_prefill.layers(conf, params, prompts, "fp8")):
            if len(a) == 1:
                h32, h8 = a[0], b[0]
                break
            kverr.append(max(compare.rel_err(b[0], a[0]),
                             compare.rel_err(b[1], a[1])))
        r = ref_prefill.logits(h32[:, -1], emb)
        lerr.append(compare.logit_err(ref_prefill.logits(
            h8[:, -1], emb, "fp8"), r))
        for row in range(h32.shape[0]):
            for s in range(0, h32.shape[1], 512):
                r = ref_prefill.logits(h32[row, s:s + 512], emb)
                first = ref_prefill.logits(h8[row, s:s + 512], emb,
                                           "fp8").argmax(-1)
                gaps.append(compare.token_gap(r, first))
        del h32, h8, r
        program.free(device)
    del params
    program.free(device)
    return {"token_gap": max(gaps), "logit_err": max(lerr),
            "kv_err": max(kverr)}
