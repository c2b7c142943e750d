"""Inference engine: prefill and decode over a loaded checkpoint.

The port of the reference package's ``inference/engine.py`` for the fast
(W8A16) and exact (W8A8) engines, with host sampling or, through
``decode_chunk``, device sampling; ``decode_chunk_spec`` runs greedy n-gram
speculative rounds.  PyTorch runs eagerly, so there is no
compile step and no bucket padding: a prompt window is exactly as long as the
prompt.  ``prefill`` feeds prompts in windows of at
most ``MAX_PREFILL_WINDOW`` rows; a window that starts at position 0 is a
fresh prefill (the causal prefill kernel in fast mode), a later window
attends over the cache rows the earlier ones wrote, as a chat turn does.

Sequence parallelism (``sp_mesh``, ``start_sp_engine``): a fresh prompt of
at least ``sp_threshold`` rows is one window, not chunked, and runs over the
ranks of the ``sp`` mesh (ring attention, ``qwen3_forward(sp_mesh=...)``)
where its bucket (the reference engine's padded width) reaches the threshold
and divides over the ranks; the window is padded to that bucket, and the
padding rows write nothing.  Otherwise it is one plain window.  Decode steps
and every other window run on rank 0 alone.  Ranks 1..N-1 hold the weights,
no cache, and wait in ``worker_loop`` for rank 0's next sp window until its
``close()``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

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
    megakernel_route,
    megakernel_step,
    qwen3_forward,
    weights_to,
)
from ..ops import collectives
from ..ops.kernels import LAUNCHES, reset_launches
from ..ops.quant import Q4Tensor
from ..ops.sampling import Sampler, sample_tokens
from ..parallel.distributed import launch
from ..parallel.mesh import SP_AXIS

logger = logging.getLogger(__name__)

# The reference engine's compile buckets: a prefill window pads to the first
# that holds it, past the last to a multiple of 1024 rows.
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


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
        ``"fast"`` (W8A16, the port's kernels) or ``"exact"`` (W8A8 with the
        reference's rounding, for parity; f32 residual stream).
    cache_dtype:
        ``torch.float32`` (default), ``torch.bfloat16`` or ``"int8"``.
    device:
        ``None`` takes ``cuda`` and raises without it; pass ``"cpu"`` for the
        plain PyTorch versions of the kernels.
    sp_mesh, sp_threshold:
        This rank's mesh on the ``sp`` axis (``start_sp_engine``), and the
        fewest rows of a fresh prompt that runs sequence-parallel.
    """

    # Long prompts prefill in windows of this size, as the reference engine's;
    # a continuation window attends over the prefix like a chat turn.
    MAX_PREFILL_WINDOW = 2048

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
        sp_mesh=None,
        sp_threshold: int = 4096,
    ):
        if sp_mesh is not None:
            if device is not None and torch.device(device) != sp_mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {sp_mesh.device} for this rank")
            device = sp_mesh.device
        self.device = resolve_device(device)
        if mode not in ("fast", "exact"):
            raise ValueError(f"engine mode {mode!r} is not 'fast' or 'exact'")
        if checkpoint is not None:
            config, weights = load_checkpoint(checkpoint)
        if config is None or weights is None:
            raise ValueError("Engine needs a checkpoint, or config and weights")
        self.config = config.with_seq_len(ctx_length).validate()
        weights = weights_to(weights, self.device)
        if mode == "fast":
            # bf16 scales: the W8A16 kernels round scales to bf16 anyway, and
            # they are half the streamed scale bytes.  Exact mode keeps f32.
            weights = cast_weight_scales(weights)
        self.weights = weights
        self.mode = mode
        self.cache_dtype = cache_dtype
        self.batch_size = batch_size
        self.sp_mesh = sp_mesh
        self.sp_threshold = sp_threshold
        self._sp = sp_mesh.shape.get(SP_AXIS, 1) if sp_mesh is not None else 1

    # ------------------------------------------------------ sequence parallel
    def _sync(self, op: str, payload=None) -> None:
        """Rank 0: tell the worker ranks what to do next."""
        if self.sp_mesh.rank != 0 or self.sp_mesh.group is None:
            raise RuntimeError("only rank 0 drives a sequence-parallel engine, and only until close()")
        self.sp_mesh.workers.check()
        torch.distributed.broadcast_object_list([(op, payload)], src=0, group=self.sp_mesh.group)

    def worker_loop(self) -> None:
        """Ranks 1..N-1: run rank 0's sp windows, each on this rank's rows,
        until rank 0 closes."""
        while True:
            box = [None]
            torch.distributed.broadcast_object_list(box, src=0, group=self.sp_mesh.group)
            op, payload = box[0]
            if op == "stop":
                return
            if op == "prefill":
                tokens, out_idx = payload
                qwen3_forward(self.config, self.weights, tokens, None, np.zeros(len(tokens), np.int64),
                              mode=self.mode, out_idx=out_idx, fresh_prefill=True, sp_mesh=self.sp_mesh)
            elif op == "reset":
                self._reset_counters()
            elif op == "report":
                torch.distributed.gather_object(self._report(), None, dst=0, group=self.sp_mesh.group)

    def close(self) -> None:
        """Rank 0 of an sp engine: stop the worker ranks, join them and leave
        the process group.  Nothing else to do for one device."""
        if self._sp == 1 or self.sp_mesh.group is None:
            return
        try:
            self._sync("stop")
        finally:
            self.sp_mesh.close()

    def _reset_counters(self) -> None:
        reset_launches()
        collectives.reset_counts()

    def reset_counters(self) -> None:
        """Zero the kernel launch and collective counts of every rank."""
        if self._sp > 1:
            self._sync("reset")
        self._reset_counters()

    def _report(self) -> dict:
        rank = self.sp_mesh.rank if self.sp_mesh is not None else 0
        return {"rank": rank, "launches": dict(LAUNCHES), "collectives": dict(collectives.COUNTS)}

    def rank_reports(self) -> list[dict]:
        """Every rank's kernel launches and collective counts since the last
        ``reset_counters``, rank 0 first."""
        if self._sp == 1:
            return [self._report()]
        self._sync("report")
        out = [None] * self._sp
        torch.distributed.gather_object(self._report(), out, dst=0, group=self.sp_mesh.group)
        return out

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
        if self._sp > 1 and s_real >= self.sp_threshold and not pos0.any():
            # A sequence-parallel prompt: one window, not chunked.
            return self._prefill_window(cache, prompt_tokens, pos0)
        w = self.MAX_PREFILL_WINDOW
        logits = None
        for off in range(0, s_real, w):
            logits, cache = self._prefill_window(cache, prompt_tokens[:, off : off + w], pos0 + off)
        return logits, cache

    def _prefill_window(self, cache, tokens: np.ndarray, pos: np.ndarray):
        """One window.  A fresh one on an sp engine whose bucket (never past
        the room in the cache) reaches ``sp_threshold`` and divides over the
        ranks runs sequence-parallel, padded to that bucket."""
        b, s_real = tokens.shape
        fresh = not pos.any()
        if fresh and self._sp > 1:
            s_pad = max(s_real, min(_bucket(s_real), cache.seq_len))
            if s_pad >= self.sp_threshold and s_pad % self._sp == 0:
                padded = np.zeros((b, s_pad), np.int64)
                padded[:, :s_real] = tokens
                out_idx = np.full(b, s_real - 1, np.int64)
                self._sync("prefill", (padded, out_idx))
                return qwen3_forward(self.config, self.weights, padded, cache, pos, mode=self.mode,
                                     out_idx=out_idx, fresh_prefill=True, sp_mesh=self.sp_mesh)
        return qwen3_forward(self.config, self.weights, tokens, cache, pos, mode=self.mode, fresh_prefill=fresh)

    def decode_step(self, cache, tokens, pos) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
        """One decode step: tokens [B], pos [B] → logits [B, V]."""
        tokens = np.asarray(tokens, np.int64).reshape(-1, 1)
        return qwen3_forward(
            self.config, self.weights, tokens, cache, np.asarray(pos).reshape(-1), mode=self.mode
        )

    def decode_chunk(
        self, cache, token: int, pos: int, n_steps: int, *, temperature: float = 0.0, topp: float = 0.9,
        generator: torch.Generator | None = None,
    ) -> tuple[np.ndarray, KVCache | QuantizedKVCache]:
        """``n_steps`` decode-and-sample steps of one request from ``token``
        at ``pos``, on the device: returns the sampled ids [n_steps].  Its
        device part is ``decode_chunk_device``.

        The counterpart of the reference engine's on-device loop.  Room is
        checked once, before the chunk; inside it the token and the position
        stay on the device (a decode step through the megakernel: the
        embedding row gathered from the device token, the RoPE rows from the
        device position, one launch, ``sample_tokens``), and the ids come back
        to the host once, at the end.  ``generator`` (on the engine's device;
        default seed 0) draws the samples: greedy is exact, temperature > 0
        reproducible per seed, not the reference's ``jax.random`` bits.
        Where the gate refuses the shapes the steps take the per-layer path,
        which reads the position on the host."""
        tokens, cache = self.decode_chunk_device(cache, token, pos, n_steps, temperature=temperature, topp=topp,
                                                 generator=generator)
        return tokens.cpu().numpy(), cache

    def decode_chunk_device(
        self, cache, token: int, pos: int, n_steps: int, *, temperature: float = 0.0, topp: float = 0.9,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
        """``decode_chunk`` without its copy to the host: the sampled ids
        [n_steps] stay on the device."""
        if n_steps < 1 or pos < 0 or pos + n_steps > cache.seq_len:
            raise ValueError(
                f"a chunk of {n_steps} steps at position {pos} does not fit the cache of {cache.seq_len} rows"
            )
        dev = self.weights.embed.q.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        token_dev = torch.full((1,), int(token), dtype=torch.long, device=dev)
        fused = megakernel_route(self.config, cache, 1, 1, self.mode,
                                 q4=isinstance(self.weights.layers.wqkv, Q4Tensor))
        pos_dev = torch.full((1,), int(pos), dtype=torch.int32, device=dev)
        out = []
        for i in range(n_steps):
            if fused:
                logits = megakernel_step(self.config, self.weights, token_dev, cache, pos_dev)
                pos_dev += 1
            else:
                logits, cache = qwen3_forward(self.config, self.weights, token_dev[:, None], cache, [pos + i],
                                              mode=self.mode)
            token_dev = sample_tokens(logits, generator, temperature, topp).long()
            out.append(token_dev)
        return torch.cat(out), cache

    def decode_chunk_spec(
        self, cache, token: int, pos: int, n_rounds: int, k: int, history,
    ) -> tuple[np.ndarray, np.ndarray, KVCache | QuantizedKVCache]:
        """``n_rounds`` greedy speculative rounds (n-gram drafts,
        ``speculative.spec_round``) of one request from ``token`` at ``pos``.

        ``history`` holds every consumed token (prompt and generated, ending
        with ``token``); the most recent ``seq_len`` of them go into a
        ``[seq_len]`` buffer on the device, which the rounds extend there.  A
        round verifies ``k`` drafts in one window of ``k + 1`` rows and emits
        1 to ``k + 1`` tokens.  The drafted window, the tokens, the history
        and its length stay on the device; each round reads its count back
        to the host (the forward takes host positions), and the tokens come
        back once, at the end.  Returns (tokens ``[n_rounds, k + 1]``, counts
        ``[n_rounds]``, cache): round r's tokens are ``tokens[r, :counts[r]]``,
        the plain greedy loop's."""
        if n_rounds < 1 or k < 1 or pos < 0 or pos + n_rounds * (k + 1) > cache.seq_len:
            raise ValueError(
                f"{n_rounds} rounds of {k + 1} rows at position {pos} do not fit the cache of {cache.seq_len} rows"
            )
        from .speculative import spec_round

        t = self.config.seq_len
        history = np.asarray(history, np.int32)[-t:]
        dev = self.weights.embed.q.device
        hist = torch.zeros(t, dtype=torch.int32, device=dev)
        hist[: len(history)] = torch.as_tensor(history, device=dev)
        carry = (torch.full((1,), int(token), dtype=torch.int32, device=dev), cache, np.asarray([pos], np.int64),
                 hist, torch.tensor(len(history), dtype=torch.int32, device=dev))

        def forward(window, cache, pos, **kw):
            return qwen3_forward(self.config, self.weights, window, cache, pos, mode=self.mode, **kw)

        preds, counts = [], []
        for _ in range(n_rounds):
            carry, (p, c) = spec_round(forward, carry, k)
            preds.append(p)
            counts.append(c)
        return torch.stack(preds).cpu().numpy(), np.asarray(counts, np.int32), carry[1]

    def all_logits(self, cache, tokens, pos_start) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
        """Logits for every position of one window: tokens [B, S] → [B, S, V]."""
        tokens = np.asarray(tokens, np.int64)
        return qwen3_forward(
            self.config, self.weights, tokens, cache, np.asarray(pos_start).reshape(-1),
            mode=self.mode, return_all_logits=True,
        )


def _sp_rank(mesh, source: Callable, engine_kw: dict) -> None:
    """A worker rank of ``start_sp_engine``: the weights, following rank 0."""
    config, weights = source()
    engine = Engine(config=config, weights=weights, sp_mesh=mesh, **engine_kw)
    del config, weights
    engine.worker_loop()


def start_sp_engine(source: Callable, devices, **engine_kw) -> Engine:
    """A sequence-parallel engine over ``devices`` (one rank each; a card may
    hold more than one rank): ranks 1..N-1 start as processes of their own
    and this process is rank 0, whose engine is returned.  ``source()``
    gives (config, weights) on every rank (e.g.
    ``functools.partial(load_checkpoint, path)``); it and ``engine_kw``
    (``Engine``'s keywords: ``ctx_length``, ``mode``, ``sp_threshold``, ...)
    must pickle.  ``close()`` stops the workers."""
    mesh = launch(devices, _sp_rank, source, engine_kw, axis=SP_AXIS)
    try:
        config, weights = source()
        return Engine(config=config, weights=weights, sp_mesh=mesh, **engine_kw)
    except BaseException:
        mesh.workers.join(timeout=0)
        mesh.close()
        raise


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
    """Sampling front-end for the generation loops: the reference package's
    xorshift64* host sampler (bit-exact), or with ``device=True`` device
    sampling (``sample_tokens``) from generators seeded off one seeded
    stream, the counterpart of the reference's PRNG key splits."""

    def __init__(self, temperature: float, topp: float, seed: int, device: bool = False):
        self.temperature = temperature
        self.topp = topp
        self.device = device
        self._host = Sampler(temperature, topp, seed)
        self._seeds = torch.Generator()
        self._seeds.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)

    def sample(self, logits: torch.Tensor) -> int:
        """logits [1, V] or [V] → token id."""
        if self.device:
            gen = self.next_generator(logits.device)
            return int(sample_tokens(logits.reshape(1, -1), gen, self.temperature, self.topp)[0])
        return self._host.sample(logits.reshape(-1).float().cpu().numpy())

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self._seeds))

    def next_generator(self, device="cpu") -> torch.Generator:
        """A fresh generator on ``device`` for an on-device sampling chunk
        (the reference's ``next_key``)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self._next_seed())
        return gen

    def skip_draws(self, n: int):
        """Advance the RNG stream by n discarded draws: the reference chat loop
        samples once per fed prompt token and keeps only the last sample, and
        each sample at temperature > 0 takes one coin (on the device: one
        generator)."""
        if self.temperature == 0.0 or n <= 0:
            return
        for _ in range(n):
            if self.device:
                self._next_seed()
            else:
                self._host.rng.random_f32()
