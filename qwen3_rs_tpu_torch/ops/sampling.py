"""Sampling: the host sampler (temperature, top-p, argmax, the xorshift64*
generator) and device sampling.

The host sampler is a numpy copy of the reference package's, kept bit-exact
with it: the same generator, the same candidate cutoff and the same CDF walks,
so a seed gives the same token stream for the same logits.

``sample_tokens`` is the port of the reference's on-device sampling
(``sample_tokens_jax``): batched, on the logits' device, without a host
synchronisation, drawing from an explicit ``torch.Generator``.  The same
decisions (temperature 0: the last maximum; top-p outside (0, 1): the whole
distribution; else the nucleus), reproducible per seed, not the reference's
``jax.random`` bits.  Above 512 vocabulary entries the nucleus is drawn from
the top 256 candidates, found exactly (``torch.topk``; the reference uses
``approx_max_k``, which is exact on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


# ------------------------------------------------------------------ device
NUCLEUS_TOPK = 256  # nucleus candidates above 2 * NUCLEUS_TOPK vocabulary entries


def argmax_last(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick over the last axis, ties to the *last* maximum as the host
    sampler breaks them → int32."""
    v = logits.shape[-1]
    return (v - 1 - torch.flip(logits, dims=(-1,)).argmax(dim=-1)).to(torch.int32)


def _categorical(scaled: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(scaled), by the Gumbel-max rule (as
    ``jax.random.categorical``); entries at -inf are never drawn."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device, dtype=torch.float32)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1)


def _topp_sample(scaled: torch.Tensor, generator: torch.Generator, topp) -> torch.Tensor:
    """Nucleus draw from scaled logits [B, V]; ``topp`` a float or [B].  The
    kept set is the smallest prefix of the probabilities in descending order
    whose sum passes topp (a candidate is kept while the mass before it is
    at most topp)."""
    if isinstance(topp, torch.Tensor):
        topp = topp.reshape(-1, 1)
    v = scaled.shape[-1]
    if v <= 2 * NUCLEUS_TOPK:
        probs = torch.softmax(scaled, dim=-1)
        sorted_probs = torch.sort(probs, dim=-1, descending=True).values
        keep = torch.cumsum(sorted_probs, dim=-1) - sorted_probs <= topp
        threshold = torch.where(keep, sorted_probs, float("inf")).amin(dim=-1, keepdim=True)
        return _categorical(torch.where(probs >= threshold, scaled, float("-inf")), generator).to(torch.int32)
    vals, idx = torch.topk(scaled, NUCLEUS_TOPK, dim=-1)  # sorted descending
    probs = torch.exp(vals - torch.logsumexp(scaled, dim=-1, keepdim=True))  # over the whole vocabulary
    keep = torch.cumsum(probs, dim=-1) - probs <= topp
    choice = _categorical(torch.where(keep, vals, float("-inf")), generator)
    return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, temperature, topp) -> torch.Tensor:
    """Batched sampling: logits [B, V] → tokens [B] int32 on their device.

    ``temperature`` and ``topp`` are floats (the whole batch) or per-row [B]
    tensors.  ``generator`` lives on the logits' device."""
    if not isinstance(temperature, torch.Tensor) or temperature.dim() == 0:
        temperature, topp = float(temperature), float(topp)
        if temperature == 0.0:
            return argmax_last(logits)
        scaled = logits.float() / temperature
        if topp <= 0.0 or topp >= 1.0:
            return _categorical(scaled, generator).to(torch.int32)
        return _topp_sample(scaled, generator, topp)
    t = temperature.to(device=logits.device, dtype=torch.float32)
    p = torch.as_tensor(topp, dtype=torch.float32, device=logits.device).expand_as(t)
    scaled = logits.float() / torch.where(t == 0.0, 1.0, t)[:, None]
    nucleus = (p > 0.0) & (p < 1.0)  # rows outside (0, 1) keep everything
    sampled = _topp_sample(scaled, generator, torch.where(nucleus, p, 1.0))
    return torch.where(t == 0.0, argmax_last(logits), sampled)
