"""The one traffic generator: a mix file's parameters and a seed → requests.

Lengths and arrival gaps are drawn in blocks of ``block`` requests.  Each
block holds the same ``block`` quantiles of each distribution (the lognormal
of the prompt and output lengths, the exponential of the gaps), put in an
order drawn from the seed, so every seed offers the same work and arrivals
in another order, and a window that takes whole blocks takes the same set of
sizes.  The order is stratified: the sorted quantiles fall into ``strata``
classes of equal count, and every run of ``strata`` consecutive requests of
a block holds one of each class, so that no seed bunches the long prompts
(or the short gaps) together more than another.  The arrivals are therefore
not a Poisson process: each block of gaps sums to ``block / rate`` exactly,
and no more than two gaps of the shortest class ever follow each other, so
the bursts are milder than a Poisson process's at the same rate.  Token ids,
the order and each request's sampling seed come from the seed.  In every
block the requests at positions ``0, greedy_every, 2·greedy_every, ...``
decode greedily, the others at the mix's temperature and top-p; the
comparison that decides ``correct`` reads both kinds.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    top_p: float
    seed: int
    due_s: float | None = None  # open loop: seconds after the schedule starts

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, sampling, ...)."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def lognormal_quantiles(spec: dict, n: int) -> list[int]:
    """The n midpoint quantiles of a lognormal (``median``, ``sigma``),
    rounded and clipped to [``min``, ``max``]."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [int(min(spec["max"], max(spec["min"], round(spec["median"] * math.exp(spec["sigma"] * zi))))) for zi in z]


def exponential_quantiles(rate: float, n: int) -> list[float]:
    """The n midpoint quantiles of the exponential gaps of a Poisson process
    of ``rate``, scaled so that they sum to n / rate: a block of n arrivals
    takes the same time at every seed."""
    q = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    return [x * n / (rate * sum(q)) for x in q]


def stratified(values: list, strata: int, rng: np.random.Generator) -> list:
    """``values`` in an order drawn from ``rng`` in which every run of
    ``strata`` consecutive entries holds one entry of each of the ``strata``
    classes of equal count that the sorted values fall into."""
    v = sorted(values)
    if len(v) % strata:
        raise ValueError(f"a block of {len(v)} does not split into {strata} strata")
    m = len(v) // strata
    classes = [rng.permutation(v[i * m:(i + 1) * m]).tolist() for i in range(strata)]
    out = []
    for j in range(m):
        out += rng.permutation([c[j] for c in classes]).tolist()
    return out


class Generator:
    """Requests of one mix and seed, block by block, in order."""

    def __init__(self, mix: dict, seed: int, vocab_size: int, ctx: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab_size = vocab_size
        self.ctx = ctx
        self.block = int(mix["block"])
        self.strata = int(mix["strata"])
        self._prompts = lognormal_quantiles(mix["prompt_tokens"], self.block)
        self._outputs = lognormal_quantiles(mix["output_tokens"], self.block)
        loop = mix["loop"]
        self._gaps = exponential_quantiles(loop["rate_per_s"], self.block) if loop["kind"] == "open" else None
        self.block_seconds = self.block / loop["rate_per_s"] if loop["kind"] == "open" else None
        if max(self._prompts) + max(self._outputs) > ctx:
            raise ValueError(f"the longest prompt and output ({max(self._prompts)} + {max(self._outputs)}) "
                             f"pass the context of {ctx} rows")
        self._next = 0
        self._clock = 0.0
        self._pending: list[Request] = []

    def _block(self, k: int) -> list[Request]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1, k]))
        prompts = stratified(self._prompts, self.strata, rng)
        outputs = stratified(self._outputs, self.strata, rng)
        gaps = stratified(self._gaps, self.strata, rng) if self._gaps is not None else None
        s = self.mix["sampling"]
        out = []
        for i in range(self.block):
            greedy = i % s["greedy_every"] == 0
            due = None
            if gaps is not None:
                self._clock += float(gaps[i])
                due = self._clock
            out.append(Request(
                index=k * self.block + i,
                prompt=[int(t) for t in rng.integers(0, self.vocab_size, int(prompts[i]))],
                max_new_tokens=int(outputs[i]),
                temperature=0.0 if greedy else float(s["temperature"]),
                top_p=float(s["top_p"]),
                seed=int(rng.integers(0, 2**31)),
                due_s=due,
            ))
        return out

    def next(self) -> Request:
        if not self._pending:
            self._pending = self._block(self._next // self.block)
        self._next += 1
        return self._pending.pop(0)
