"""Perplexity evaluation: the accuracy bar of the quantized engine.

The port of the reference package's ``evaluation.py``.  Perplexity under any
engine mode, so that ``ppl(int8 engine) − ppl(f32 dequantized reference)`` is
measured on one checkpoint:

* ``fast``  — the W8A16 path (the port's kernels)
* ``exact`` — the reference-parity W8A8 path
* ``f32``   — dequantized weights, full-f32 products

Each window is padded to the full window length, as the reference pads it,
so that it runs the same kernels as the reference's window would; the KV
cache is per window, f32.  The weights keep the checkpoint's f32 scales
(the dequant paths use them unrounded); a fast-mode window of at most 256
rows reaches the fused W8A16 kernel, which takes bf16 scales, and casts them
(that kernel rounds every scale to bf16 anyway).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .configuration import ModelConfig
from .device import resolve_device
from .models.qwen3 import Qwen3Weights, cast_weight_scales, init_kv_cache, qwen3_forward, weights_to
from .ops.kernels.qmatmul import MAX_ROWS


@dataclasses.dataclass
class PerplexityResult:
    perplexity: float
    avg_nll: float
    n_tokens: int

    def delta_vs(self, other: "PerplexityResult") -> float:
        return self.perplexity - other.perplexity


def _weights_for(weights: Qwen3Weights, mode: str, window: int) -> Qwen3Weights:
    if mode == "fast" and window <= MAX_ROWS and weights.lm_head.scales.dtype != torch.bfloat16:
        return cast_weight_scales(weights)
    return weights


def _window_logprobs(config, weights, padded: np.ndarray, mode: str) -> torch.Tensor:
    """f32 log-softmax of every position of one [1, S] window → [1, S, V]."""
    dev = weights.embed.q.device
    cache = init_kv_cache(config, 1, dtype=torch.float32, seq_len=padded.shape[1], device=dev)
    logits, _ = qwen3_forward(
        config, weights, padded, cache, np.zeros(1, np.int64), mode=mode, return_all_logits=True
    )
    return torch.log_softmax(logits.float(), dim=-1)


def _windows(token_ids: Sequence[int], window: int):
    """(padded [1, window] tokens, n_valid) for each window: windows overlap
    by one token, so every token after the first is scored once."""
    ids = np.asarray(token_ids, np.int64)
    start = 0
    while start + 1 < len(ids):
        chunk = ids[start : start + window]
        padded = np.zeros((1, window), np.int64)
        padded[0, : len(chunk)] = chunk
        yield padded, len(chunk) - 1
        start += window - 1


def compute_perplexity(
    config: ModelConfig,
    weights: Qwen3Weights,
    token_ids: Sequence[int],
    *,
    mode: str = "fast",
    window: Optional[int] = None,
) -> PerplexityResult:
    """Sliding-window perplexity over a token stream, on the device that
    holds ``weights``.

    Windows are independent (no cross-window context) and overlap by one
    token, so every token after the first is scored exactly once (the first
    token of each window is context only).
    """
    window = min(window or config.seq_len, config.seq_len)
    if len(token_ids) < 2:
        raise ValueError("Need at least 2 tokens to evaluate perplexity")
    weights = _weights_for(weights, mode, window)
    total_nll = 0.0
    total_count = 0
    for padded, n_valid in _windows(token_ids, window):
        lp = _window_logprobs(config, weights, padded, mode)
        targets = torch.as_tensor(padded[:, 1:], device=lp.device)
        tok_lp = lp[:, :-1].gather(-1, targets[..., None])[..., 0]  # [1, S-1]
        mask = torch.arange(tok_lp.shape[1], device=lp.device)[None, :] < n_valid
        total_nll += float(-torch.where(mask, tok_lp, 0.0).sum())
        total_count += n_valid
    avg = total_nll / total_count
    return PerplexityResult(perplexity=math.exp(avg), avg_nll=avg, n_tokens=total_count)


def logit_kl(
    config: ModelConfig,
    weights: Qwen3Weights,
    token_ids: Sequence[int],
    *,
    mode_p: str = "f32",
    mode_q: str = "fast",
    window: Optional[int] = None,
) -> dict:
    """Per-position KL(p‖q) between two engine modes' next-token
    distributions over a token stream (same windowing as
    ``compute_perplexity``).

    A distribution-level accuracy metric: ≥ 0 by construction, and it scales
    with the quantization error, where fixture perplexity deltas sit inside
    sampling noise.  Returns {mean, p99, max, n_positions} in nats."""
    window = min(window or config.seq_len, config.seq_len)
    if len(token_ids) < 2:
        raise ValueError("Need at least 2 tokens")
    wp, wq = _weights_for(weights, mode_p, window), _weights_for(weights, mode_q, window)
    kls = []
    for padded, n_valid in _windows(token_ids, window):
        lp = _window_logprobs(config, wp, padded, mode_p)[0, :n_valid].cpu().numpy()
        lq = _window_logprobs(config, wq, padded, mode_q)[0, :n_valid].cpu().numpy()
        kls.append(np.sum(np.exp(lp) * (lp - lq), axis=-1))
    kl = np.maximum(np.concatenate(kls), 0.0)  # clip float round-off on near-identical dists
    return {
        "mean": float(kl.mean()),
        "p99": float(np.percentile(kl, 99)),
        "max": float(kl.max()),
        "n_positions": int(kl.size),
    }


def quantization_error_bound(config: ModelConfig) -> float:
    """Worst-case per-element relative reconstruction error of Q8_0 group
    quantization: half a quantization step of the group max, i.e.
    ``1/(2·127)`` of the group's max-abs value."""
    return 1.0 / (2 * 127)


def evaluate_checkpoint(
    checkpoint_path,
    text: Optional[str] = None,
    token_ids: Optional[Sequence[int]] = None,
    *,
    modes: Sequence[str] = ("fast", "f32"),
    window: Optional[int] = None,
    device=None,
) -> dict[str, PerplexityResult]:
    """Perplexity of one checkpoint under several engine modes, on the card
    unless ``device="cpu"``."""
    from .checkpoint import load_checkpoint
    from .inference.tokenizer import Tokenizer

    dev = resolve_device(device)
    config, weights = load_checkpoint(checkpoint_path)
    if token_ids is None:
        if text is None:
            raise ValueError("provide text or token_ids")
        token_ids = Tokenizer(checkpoint_path, config.vocab_size).encode(text)
    weights = weights_to(weights, dev)
    return {
        mode: compute_perplexity(config, weights, token_ids, mode=mode, window=window)
        for mode in modes
    }
