"""The one traffic generator: every mix under ``bench/traffic/`` is
parameters that these functions read.  Every input is a pure function of
(``--seed``, what is drawn, its index), so the same seed gives the same
inputs; every seed gives the same sizes and arrivals."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

#: what is drawn, the second word of every seed sequence
TRAIN_ROWS, PROMPT, ORDER, WARM, SAMPLE = 1, 2, 3, 4, 5


def rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, *words]))


def train_batch(mix: Dict, seed: int, step: int,
                vocab: int) -> Dict[str, np.ndarray]:
    """The rows of one training step: ``batch`` x ``seq`` token ids drawn
    uniformly over the vocabulary, and as labels the next token of each
    row (the row rolled by one)."""
    tokens = rng(seed, TRAIN_ROWS, step).integers(
        0, vocab, (mix["batch"], mix["seq"]), dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def length_set(mix: Dict) -> List[int]:
    """The prompt lengths of one block of batches: the quantiles (i + 0.5)
    / n of the log-uniform distribution over [min_len, max_len], each
    rounded to a multiple of ``length_multiple``."""
    n, lo, hi = mix["lengths_per_block"], mix["min_len"], mix["max_len"]
    m = mix.get("length_multiple", 1)
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (i + 0.5) / n * math.log(hi / lo))
        out.append(int(min(hi, max(lo, m * round(x / m)))))
    return out


def prefill_length(mix: Dict, i: int) -> int:
    """Batch ``i``'s prompt length.  Each block of ``lengths_per_block``
    batches holds :func:`length_set` once, in an order drawn from the
    mix's own ``order_seed`` and the block's index: one fixed trace of
    arrivals, the same for every ``--seed`` (which draws the prompts and
    the weights), since the tail of a queue this short swings with the
    order more than with the program (``PERF.md``)."""
    n = mix["lengths_per_block"]
    order = rng(mix["order_seed"], ORDER, i // n).permutation(
        sorted(length_set(mix)))
    return int(order[i % n])


def prompts(mix: Dict, seed: int, i: int, length: int, vocab: int,
            stream: int = PROMPT) -> np.ndarray:
    """Batch ``i``'s ``batch`` prompts of ``length`` token ids, uniform
    over the vocabulary."""
    return rng(seed, stream, i).integers(0, vocab, (mix["batch"], length),
                                         dtype=np.int32)


def arrival_s(mix: Dict, i: int) -> float:
    """When batch ``i`` is due, in seconds after the window opens: evenly
    spaced at ``rate_batches_per_s``."""
    return i / mix["rate_batches_per_s"]


def window_batches(mix: Dict, seconds: float) -> int:
    """The batches due in a window of ``seconds``: those with
    :func:`arrival_s` under it."""
    return math.ceil(seconds * mix["rate_batches_per_s"])


def sample_batches(mix: Dict, seed: int, n: int) -> List[int]:
    """The batches of a window of ``n`` whose outputs the comparison
    checks, drawn from the seed over the whole window: one of the longest
    length, and one from each other of ``sample_batches`` equal spans of
    the window."""
    lengths = [prefill_length(mix, i) for i in range(n)]
    r = rng(seed, SAMPLE)
    longest = [i for i, L in enumerate(lengths) if L == max(lengths)]
    first = int(r.choice(longest))
    out = [first]
    for span in np.array_split(np.arange(n), min(mix["sample_batches"], n)):
        if first not in span:
            out.append(int(r.choice(span)))
    return sorted(out)
