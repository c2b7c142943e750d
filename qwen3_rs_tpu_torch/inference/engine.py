"""Inference engine: prefill and decode over a loaded checkpoint.

The port of the reference package's ``inference/engine.py`` for the fast
(W8A16) engine with host sampling.  PyTorch runs eagerly, so there is no
compile step and no bucket padding: a prompt window is exactly as long as
the prompt.  ``prefill`` feeds prompts in windows of at most
``MAX_PREFILL_WINDOW`` rows; a later window attends over the cache rows the
earlier ones wrote, as a chat turn does.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint import load_checkpoint
from ..configuration import ModelConfig
from ..device import resolve_device
from ..models.qwen3 import (
    KVCache,
    QuantizedKVCache,
    Qwen3Weights,
    cast_weight_scales,
    init_kv_cache,
    qwen3_forward,
    weights_to,
)
from ..ops.sampling import Sampler

logger = logging.getLogger(__name__)


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, {item})")


class Engine:
    """Loads a checkpoint and serves prefill/decode on one device.

    Parameters
    ----------
    checkpoint:
        A native checkpoint directory or a legacy ``.bin`` file (or pass
        ``config`` and ``weights``).
    ctx_length:
        Optional context override, clamped to the checkpoint's seq_len.
    mode:
        ``"fast"`` (W8A16, the port's kernels).  ``"exact"`` is not ported.
    cache_dtype:
        ``torch.float32`` (default), ``torch.bfloat16`` or ``"int8"``.
    device:
        ``None`` takes ``cuda`` and raises without it; pass ``"cpu"`` for the
        plain PyTorch versions of the kernels.
    """

    # Prompt windows are at most this long: the W8A16 kernel takes up to 256
    # activation rows, and the >256-row kernels are not ported yet.
    MAX_PREFILL_WINDOW = 256

    def __init__(
        self,
        checkpoint: str | Path | None = None,
        *,
        config: ModelConfig | None = None,
        weights: Qwen3Weights | None = None,
        ctx_length: Optional[int] = None,
        mode: str = "fast",
        cache_dtype=torch.float32,
        batch_size: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        if mode != "fast":
            raise not_ported(f"engine mode {mode!r}", "queue 1: exact (W8A8) mode")
        if checkpoint is not None:
            config, weights = load_checkpoint(checkpoint)
        if config is None or weights is None:
            raise ValueError("Engine needs a checkpoint, or config and weights")
        self.config = config.with_seq_len(ctx_length).validate()
        # bf16 scales: the kernel rounds scales to bf16 anyway, and they are
        # half the streamed scale bytes.
        self.weights = cast_weight_scales(weights_to(weights, self.device))
        self.mode = mode
        self.cache_dtype = cache_dtype
        self.batch_size = batch_size

    # ------------------------------------------------------------------ api
    def new_cache(self, batch_size: Optional[int] = None) -> KVCache | QuantizedKVCache:
        return init_kv_cache(
            self.config, batch_size or self.batch_size, dtype=self.cache_dtype, device=self.device
        )

    def prefill(
        self, cache, prompt_tokens: np.ndarray, pos_start: np.ndarray
    ) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
        """Run a prompt: prompt_tokens [B, S] from positions pos_start [B];
        returns logits [B, V] at each row's last token."""
        prompt_tokens = np.asarray(prompt_tokens, np.int64)
        b, s_real = prompt_tokens.shape
        pos0 = np.asarray(pos_start, np.int64).reshape(b)
        room = cache.seq_len - int(pos0.max())
        if s_real > room:
            raise ValueError(
                f"prompt window of {s_real} tokens does not fit the cache: "
                f"{room} rows left of {cache.seq_len} (pos {int(pos0.max())})"
            )
        w = self.MAX_PREFILL_WINDOW
        logits = None
        for off in range(0, s_real, w):
            logits, cache = qwen3_forward(
                self.config, self.weights, prompt_tokens[:, off : off + w], cache, pos0 + off
            )
        return logits, cache

    def decode_step(self, cache, tokens, pos) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
        """One decode step: tokens [B], pos [B] → logits [B, V]."""
        tokens = np.asarray(tokens, np.int64).reshape(-1, 1)
        return qwen3_forward(self.config, self.weights, tokens, cache, np.asarray(pos).reshape(-1))


class TokenMetrics:
    """tokens/sec and time-to-first-token reporter."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.prefill_start: Optional[float] = None
        self.generated = 0

    def start_prefill(self):
        if self.prefill_start is None:
            self.prefill_start = time.perf_counter()

    def start_generation(self):
        if self.start_time is None:
            self.start_time = time.perf_counter()

    def increment(self):
        if self.first_token_time is None:
            self.first_token_time = time.perf_counter()
        self.generated += 1

    def report_and_reset(self) -> Optional[dict]:
        stats = None
        if self.start_time is not None:
            duration = time.perf_counter() - self.start_time
            if self.generated > 0 and duration > 0:
                stats = {
                    "tokens": self.generated,
                    "seconds": duration,
                    "tokens_per_sec": self.generated / duration,
                }
                if self.prefill_start is not None and self.first_token_time is not None:
                    stats["ttft_sec"] = self.first_token_time - self.prefill_start
                logger.info(
                    "[Generated %d tokens in %.2fs - %.2f tokens/sec]",
                    stats["tokens"],
                    stats["seconds"],
                    stats["tokens_per_sec"],
                )
        self.__init__()
        return stats


class TokenSampler:
    """Host sampling front-end for the generation loops (the reference
    package's xorshift64* sampler, bit-exact)."""

    def __init__(self, temperature: float, topp: float, seed: int, device: bool = False):
        if device:
            raise not_ported("device sampling", "queue 1: device sampling and decode_chunk")
        self.temperature = temperature
        self.topp = topp
        self.device = False
        self._host = Sampler(temperature, topp, seed)

    def sample(self, logits: torch.Tensor) -> int:
        """logits [1, V] or [V] → token id."""
        return self._host.sample(logits.reshape(-1).float().cpu().numpy())

    def skip_draws(self, n: int):
        """Advance the RNG stream by n discarded draws: the reference chat loop
        samples once per fed prompt token and keeps only the last sample, and
        each sample at temperature > 0 takes one coin."""
        if self.temperature == 0.0 or n <= 0:
            return
        for _ in range(n):
            self._host.rng.random_f32()
