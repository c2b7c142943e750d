"""Host sampling: temperature, top-p (nucleus), argmax, and the xorshift64*
generator.

A numpy copy of the reference package's host sampler, kept bit-exact with it:
the same generator, the same candidate cutoff and the same CDF walks, so a
seed gives the same token stream for the same logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_MUL = np.uint64(0x2545F4914F6CDD1D)


class XorshiftRng:
    """xorshift64*."""

    def __init__(self, seed: int):
        self.state = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)

    def random_u32(self) -> int:
        with np.errstate(over="ignore"):
            s = self.state
            s ^= s >> np.uint64(12)
            s = (s ^ (s << np.uint64(25))) & _MASK64
            s ^= s >> np.uint64(27)
            self.state = s
            return int((s * _MUL & _MASK64) >> np.uint64(32))

    def random_f32(self) -> float:
        """float in [0, 1) with 24 bits of entropy."""
        return np.float32(self.random_u32() >> 8) / np.float32(16777216.0)


def softmax_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    x = np.exp(x - np.max(x), dtype=np.float32)
    return x * (np.float32(1.0) / np.sum(x, dtype=np.float32))


def _argmax_last(x: np.ndarray) -> int:
    """Index of the max; ties resolve to the *last* occurrence."""
    return int(len(x) - 1 - np.argmax(x[::-1]))


@dataclasses.dataclass
class Sampler:
    temperature: float
    topp: float
    rng: XorshiftRng

    def __init__(self, temperature: float, topp: float, seed: int):
        if temperature < 0.0:
            raise ValueError("Temperature must be non-negative")
        if not (0.0 <= topp <= 1.0):
            raise ValueError("Top-p must be between 0.0 and 1.0")
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.rng = XorshiftRng(seed)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)
        if self.temperature == 0.0:
            return _argmax_last(logits)
        probs = softmax_f32(logits / np.float32(self.temperature))
        coin = self.rng.random_f32()
        if self.topp <= 0.0 or self.topp >= 1.0:
            return self._sample_mult(probs, coin)
        return self._sample_topp(probs, coin)

    @staticmethod
    def _sample_mult(probs: np.ndarray, coin: float) -> int:
        cdf = np.cumsum(probs, dtype=np.float32)
        hits = np.nonzero(coin < cdf)[0]
        return int(hits[0]) if len(hits) else len(probs) - 1

    def _sample_topp(self, probs: np.ndarray, coin: float) -> int:
        """Candidate cutoff ``(1-topp)/(n-1)``, sort descending, truncate at
        cumulative > topp, then CDF-walk within the truncated list."""
        n = len(probs)
        cutoff = np.float32(1.0 - self.topp) / np.float32(max(n - 1, 1))
        cand = np.nonzero(probs >= cutoff)[0]
        if len(cand) == 0:
            return 0
        order = cand[np.argsort(-probs[cand], kind="stable")]
        p_sorted = probs[order].astype(np.float32)
        cum = np.cumsum(p_sorted, dtype=np.float32)
        over = np.nonzero(cum > np.float32(self.topp))[0]
        last_idx = int(over[0]) if len(over) else len(order) - 1
        cumulative = cum[last_idx]
        r = np.float32(coin) * cumulative
        hits = np.nonzero(r < cum[: last_idx + 1])[0]
        pick = int(hits[0]) if len(hits) else last_idx
        return int(order[pick])
