"""Continuous batching over fixed decode slots.

The port of the reference package's ``serving/scheduler.py``, with host or
device sampling.  The engine decodes a fixed-width batch of request *slots*
every step and refills slots as requests finish:

* decode: one step over all ``n_slots`` (per-slot positions; empty and
  mid-prefill slots are masked out of the cache writes and their logits
  ignored);
* prefill, dense layout: a new request runs through a batch-1 scratch cache
  (bucketed prompt length) and its K/V window is copied into the shared
  cache at its slot;
* prefill, paged layout: queued requests that share a prompt bucket admit as
  a **group**, one batched prefill writing every request's K/V straight into
  its own pages; the group pads to a power of two;
* sampling: per-request host samplers (the reference's xorshift streams,
  per-request seeds), or device sampling: ``decode_chunk_steps`` decode steps
  per dispatch, each forward followed by ``sample_tokens`` with per-slot
  temperatures and top-p, the tokens copied to the host once per chunk.
  Draws come from one ``torch.Generator`` seeded with ``seed``: reproducible
  per seed, not the reference's ``jax.random`` bits.
* speculative decoding (``spec_k``, page pool and device sampling only):
  every slot drafts ``spec_k`` tokens from its history per round
  (``inference/speculative.py``), verifies them in one window of
  ``spec_k + 1`` rows and emits 1 to ``spec_k + 1`` tokens; greedy slots
  accept by argmax match, sampled slots by sampled-token match (exact
  speculative sampling for the deterministic drafter).  The histories stay
  on the device, seeded at admission.  Each round reads its counts back to
  the host, since the forward takes host positions, so a chunk's positions
  are exact when its dispatch returns; the host keeps JAX's upper bound
  (``n_rounds·(spec_k + 1)`` rows a slot) until the chunk's tokens are read.
  Slots with fewer than ``spec_k + 1`` rows left finish on plain one-token
  steps.  An acceptance-adaptive policy turns speculation off while the
  tokens a round (an EWMA) stay under ``spec_min_accept`` and probes it
  again later, on traffic that repeats bigrams.
* pipelining (device sampling): chunk N+1 is dispatched before chunk N's
  tokens are read; continuing slots chain their input token on the device,
  and on the page pool admissions sample their first tokens on the device
  and scatter them into the next chunk's input.  A request that finishes
  inside a chunk keeps decoding to its end with its writes masked off (its
  tokens are dropped when the chunk is read).

PyTorch runs eagerly and compiles nothing, but the bucket ladder and the
group padding stay: they decide each admission's page reservation and which
requests admit together, so the same queue admits in the same groups as in
the reference package.

Scheduling is FCFS; each ``step()`` first admits queued requests into free
slots (bounded by ``max_admissions_per_step``), then advances every active
slot by one decode step (host sampling) or one chunk (device sampling, or a
speculative chunk of rounds).

Tensor parallelism (``mesh``, ``start_tp_engine``): every rank of the mesh
runs this engine in lockstep on its own weight and cache shards (SPMD).  At
the top of each ``step()`` rank 0 broadcasts the requests submitted since
the last step; every rank then makes the same scheduling decisions and
samples the same tokens from the same all-gathered logits with the same
seeded streams, so the cache bookkeeping outside the forward (the dense
admission copy, the warm-up, the page tables) needs no messages of its own.
Ranks 1..N-1 run ``worker_loop()`` until rank 0's ``close()``.  A rank that
dies makes rank 0's next step raise; it never carries on with fewer ranks.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import load_checkpoint
from ..configuration import ModelConfig
from ..device import resolve_device
from ..inference.speculative import spec_round_batched
from ..models.qwen3 import (
    Qwen3Weights,
    cast_weight_scales,
    init_kv_cache,
    megakernel_route,
    megakernel_step,
    qwen3_forward,
    weights_to,
)
from ..ops import collectives
from ..ops.kernels import LAUNCHES, build, reset_launches
from ..ops.quant import Q4Tensor
from ..ops.sampling import Sampler, sample_tokens
from ..parallel.distributed import launch
from ..parallel.mesh import DP_AXIS, TP_AXIS
from ..parallel.tp import local_config, shard_weights_tp
from .paged_cache import PageAllocator, init_paged_cache

# Seconds an idle tensor-parallel engine waits before it tells its workers it
# is alive (``heartbeat``); far below the collectives' timeout.
HEARTBEAT_S = 10.0
# The request fields rank 0 sends its workers.
_REQUEST_FIELDS = ("request_id", "prompt_tokens", "max_new_tokens", "temperature", "topp", "seed", "eos_token_ids")


class RequestState(enum.Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    DONE = "done"


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_tokens: list[int]
    max_new_tokens: int = 256
    temperature: float = 0.0
    topp: float = 0.9
    seed: int = 0
    eos_token_ids: tuple[int, ...] = ()
    # Filled by the scheduler:
    generated: list[int] = dataclasses.field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    _sampler: Optional[Sampler] = None
    _next_pos: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one shared KV cache (dense slots
    or a page pool), on ``device`` (the card unless the caller asks for the
    CPU)."""

    # Speculative chunks read before the acceptance-adaptive policy may turn
    # speculation off (the drafting histories start cold).
    _SPEC_GRACE_CHUNKS = 3
    _SPEC_ROUND_BUCKETS = (16, 8, 4, 2, 1)
    # The re-probe gate: a bigram repeated in a live stream's last
    # _SPEC_GATE_WINDOW tokens, checked every _SPEC_GATE_RECHECK plain chunks
    # once the probe interval has passed; after _SPEC_GATE_MAX_HOLDS held
    # probes one fires all the same (the window cannot see longer cycles).
    _SPEC_GATE_WINDOW = 64
    _SPEC_GATE_RECHECK = 4
    _SPEC_GATE_MAX_HOLDS = 16

    def __init__(
        self,
        checkpoint: str | Path | None = None,
        *,
        config: ModelConfig | None = None,
        weights: Qwen3Weights | None = None,
        n_slots: int = 8,
        mode: str = "fast",
        cache_dtype=torch.bfloat16,
        prefill_buckets: tuple[int, ...] = (32, 128, 512, 2048),
        sampling: str = "host",
        decode_chunk_steps: int = 8,
        seed: int = 0,
        kv_layout: str = "dense",
        page_size: int = 128,
        n_pages: int | None = None,
        max_admissions_per_step: int | None = None,
        mesh=None,
        spec_k: int = 0,
        spec_min_accept: float = 1.35,
        spec_probe_chunks: int = 16,
        prefix_cache: bool = False,
        prefill_chunk: int | None = None,
        device=None,
    ):
        if sampling not in ("host", "device"):
            raise ValueError(f"unknown sampling: {sampling!r}")
        if spec_k > 0 and (kv_layout != "paged" or sampling != "device"):
            raise ValueError('speculative serving requires kv_layout="paged" and sampling="device"')
        # Tensor-parallel serving: weights and KV shard over the mesh's tp
        # axis, and every forward is this rank's part of the tp forward.
        # Data parallelism is request-level (one engine per replica), so the
        # mesh must be tp-only.
        self.mesh = mesh
        tp = 1
        if mesh is not None:
            if mesh.shape.get(DP_AXIS, 1) != 1:
                raise ValueError(
                    "serving engine shards tensor-parallel only; run one engine per dp replica for data parallelism"
                )
            tp = mesh.shape[TP_AXIS]
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device} for this rank")
            device = mesh.device
        self._tp = tp
        self._rank = mesh.rank if mesh is not None else 0
        self.device = resolve_device(device)
        if checkpoint is not None:
            config, weights = load_checkpoint(checkpoint)
        if config is None or weights is None:
            raise ValueError("ContinuousBatchingEngine needs a checkpoint, or config and weights")
        self.config = config.validate()
        # The forward's config: this rank's heads and hidden columns under tp.
        self._cfg = local_config(self.config, tp)
        if tp > 1:
            weights = shard_weights_tp(weights, mesh, self.config)  # this rank's part, before the copy
        weights = weights_to(weights, self.device)
        if mode == "fast":
            weights = cast_weight_scales(weights)
        self.weights = weights
        self._group = mesh.tp_group if tp > 1 else None
        self._outbox: list[Request] = []  # rank 0: submitted since the last step, for the workers
        self._last_sync = time.monotonic()
        self._broken = False
        self.n_slots = n_slots
        self.mode = mode
        # "host": per-request xorshift samplers, one forward per step.
        # "device": forward and sampling chunked on the device,
        # decode_chunk_steps tokens per dispatch per slot.
        self.sampling = sampling
        self.decode_chunk_steps = decode_chunk_steps
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Speculative decoding pays while the tokens a round stay above
        # ``spec_min_accept``: the EWMA of a round's tokens is taken as each
        # chunk is read, speculation falls back to plain chunks below it and
        # is probed again after ``spec_probe_chunks`` plain chunks (doubling
        # after a probe that fails at once), gated on repeated bigrams.
        self.spec_k = spec_k
        self.spec_min_accept = spec_min_accept
        self.spec_probe_chunks = spec_probe_chunks
        self._spec_enabled = spec_k > 0
        self._spec_accept_ewma: float | None = None
        self._spec_plain_chunks = 0
        self._spec_chunks_seen = 0
        self._spec_probe_interval = spec_probe_chunks
        self._spec_probes_gated = 0
        self._spec_gate_base = 0
        # prefix_cache: requests sharing a prompt prefix adopt the pages that
        # cover it; their admission prefill runs only the prompt suffix, at
        # pos_start = the matched rows.
        self.prefix_cache = prefix_cache
        if prefix_cache and kv_layout != "paged":
            raise ValueError('prefix caching requires kv_layout="paged"')
        # prefill_chunk: a long prompt prefills ``prefill_chunk`` rows per
        # step through the continued prefill, interleaved with the decode
        # steps of the active slots, which bounds their inter-token stall.
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if kv_layout != "paged":
                raise ValueError('chunked prefill requires kv_layout="paged"')
            if prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be positive")
            self.prefill_chunk = min(prefill_chunk, config.seq_len)
        # None = admit into every free slot each step (TTFT first); a small
        # value bounds how long active streams stall behind prefills.
        self.max_admissions_per_step = max_admissions_per_step
        self.prefill_buckets = tuple(b for b in prefill_buckets if b <= config.seq_len) or (config.seq_len,)
        if self.prefill_chunk is not None:
            self.prefill_buckets = tuple(sorted(set(self.prefill_buckets) | {self.prefill_chunk}))

        # "dense" reserves seq_len rows per slot; "paged" backs all slots with
        # a shared page pool and per-slot page tables.
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            max_pages_per_slot = -(-self.config.seq_len // page_size)
            if n_pages is None:
                # Default pool: half of the dense footprint, plus the null page.
                n_pages = 1 + max(2, (n_slots * max_pages_per_slot) // 2)
            self.cache = init_paged_cache(self._cfg, n_pages, page_size, dtype=cache_dtype, device=self.device)
            self.allocator = PageAllocator(n_pages, n_slots, max_pages_per_slot)
            self.page_size = page_size
            self._scratch_cache = None
        elif kv_layout == "dense":
            if cache_dtype in ("int8", torch.int8):
                raise ValueError(
                    'INT8 KV cache requires kv_layout="paged" (the dense layout has no per-row scale storage)'
                )
            self.cache = init_kv_cache(self._cfg, n_slots, dtype=cache_dtype, device=self.device)
            self._scratch_cache = init_kv_cache(self._cfg, 1, dtype=cache_dtype, device=self.device)
            self.allocator = None
        else:
            raise ValueError(f"unknown kv_layout: {kv_layout!r}")

        # Host-side slot bookkeeping.
        self.slot_request: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)  # next write position
        self.slot_token = np.zeros(n_slots, np.int32)  # last sampled token
        # Speculative rounds dispatched and not yet read, per slot: each emits
        # at least one token (``_provably_done``).
        self._spec_pending_rounds = np.zeros(n_slots, np.int64)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self._decode_steps = 0
        self._decode_tokens = 0
        self._prefix_hits = 0
        self._prefix_rows_reused = 0
        # Chunked prefill: slot → {"req", "done", "plen"} for requests whose
        # prompt is mid-prefill.  A partial slot holds pages and its slot but
        # stays out of ``slot_request`` (so out of every decode step's write
        # mask) until its final chunk samples the first token.
        self._partials: dict[int, dict] = {}
        self._partial_waves = 0
        # Device sampling pipelines decode chunks: the chunk whose tokens are
        # still on the device, {toks, last, n_steps, pos0, active, reqs}.
        self._inflight: Optional[dict] = None

    # ------------------------------------------------------- step functions
    def _forward(self, tokens, pos, **kw):
        logits, self.cache = self._forward_on(self.cache, tokens, pos, **kw)
        return logits, self.cache

    def _forward_on(self, cache, tokens, pos, **kw):
        """The forward (this rank's part under tp) over ``cache``."""
        return qwen3_forward(self._cfg, self.weights, tokens, cache, pos, mode=self.mode, tp_group=self._group, **kw)

    def _decode(self, active):
        """One decode step over every slot; inactive slots write nothing."""
        tables = {"page_table": self.allocator.tables} if self.allocator is not None else {}
        logits, self.cache = self._forward(self.slot_token[:, None], self.slot_pos, write_mask=active, **tables)
        return logits

    def _prefill_paged(self, tokens, out_idx, tables, pos=None):
        """Batched prefill straight into the pool.  ``pos`` None: a fresh
        window at position 0; otherwise a continued window (prefix-cache hits
        and chunked-prefill waves) that reads the pages below ``pos``."""
        fresh = pos is None
        if fresh:
            pos = np.zeros(tokens.shape[0], np.int64)
        logits, self.cache = self._forward(tokens, pos, out_idx=out_idx, page_table=tables, fresh_prefill=fresh)
        return logits

    def _to_device(self, a, dtype) -> torch.Tensor:
        """A host array as a device tensor, copied without waiting for the
        device (from pinned memory) on the card."""
        t = torch.as_tensor(np.asarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_host(self, t: torch.Tensor) -> dict:
        """Start the copy of a device tensor to the host; ``_host_array``
        waits for it."""
        if self.device.type != "cuda":
            return {"host": t}
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return {"host": host, "done": done}

    @staticmethod
    def _host_array(copy: dict) -> np.ndarray:
        if "done" in copy:
            copy["done"].synchronize()
        return copy["host"].numpy()

    def _prefill_paged_sampled(self, tokens, out_idx, tables, pos, temps, topps, slots, fresh, generator=None,
                               spec_state=None, picks=()):
        """Device-sampling admission: the batched prefill, its first tokens
        sampled on the device, and those scattered into ``fresh`` (the next
        chunk's input, [n_slots] on the device) at ``slots`` (one per real
        row; padding rows drop).  Returns (tokens [k_pad], fresh).

        With ``spec_state`` (speculative serving) each admitted slot's
        drafting history on the device becomes its whole prompt (an adopted
        prefix included, so that it can be drafted from) and its first token;
        ``picks`` holds each real row's (request, prompt length)."""
        logits = self._prefill_paged(tokens, out_idx, tables, pos)
        toks = sample_tokens(logits, generator or self._gen, self._to_device(temps, torch.float32),
                             self._to_device(topps, torch.float32))
        k = len(slots)
        if k:
            sl = self._to_device(slots, torch.long)
            fresh = fresh.clone()
            fresh[sl] = toks[:k]
            if spec_state is not None:
                rows = np.zeros((k, self.config.seq_len), np.int32)
                plens = np.array([plen for _, plen in picks], np.int64)
                for i, (req, plen) in enumerate(picks):
                    rows[i, :plen] = req.prompt_tokens[:plen]
                hist, hlen = spec_state["hist"], spec_state["hlen"]
                hist[sl] = self._to_device(rows, torch.int32)
                hist[sl, self._to_device(plens, torch.long)] = toks[:k].to(hist.dtype)
                hlen[sl] = self._to_device(plens + 1, torch.int32)
        return toks, fresh

    def _decode_chunked(self, prev_last, fresh, pos0, active, temps, topps, n_steps, generator=None):
        """``n_steps`` decode-and-sample steps of every slot on the device:
        slots with ``fresh >= 0`` start from that token, the others from
        ``prev_last`` (the previous chunk's last tokens, still on the
        device); inactive slots write nothing.  Returns (tokens
        [n_steps, n_slots], the last row) on the device.

        Dense slots whose shapes pass the megakernel gate run each step as
        one megakernel launch from device tokens and positions (no host
        synchronisation inside the chunk); other steps take the forward with
        the host-known positions ``pos0 + i``."""
        gen = generator or self._gen
        tokens = torch.where(fresh >= 0, fresh, prev_last)
        temps_t, topps_t = self._to_device(temps, torch.float32), self._to_device(topps, torch.float32)
        paged = self.kv_layout == "paged"
        fused = self._tp == 1 and megakernel_route(self.config, self.cache, self.n_slots, 1, self.mode, paged,
                                                   q4=isinstance(self.weights.layers.wqkv, Q4Tensor))
        if fused:
            pos_dev = self._to_device(pos0, torch.int32)
            ok = self._to_device(active, torch.int32)
        tables = {"page_table": self.allocator.tables} if paged else {}
        out = []
        for i in range(n_steps):
            if fused:
                logits = megakernel_step(self.config, self.weights, tokens, self.cache, pos_dev, ok)
                pos_dev = pos_dev + 1
            else:
                logits, self.cache = self._forward(tokens[:, None], pos0 + i, write_mask=active, **tables)
            tokens = sample_tokens(logits, gen, temps_t, topps_t)
            out.append(tokens)
        return torch.stack(out), tokens

    def _decode_spec(self, prev_last, fresh, pos, active, temps, topps, hist, hlen, n_rounds, generator=None):
        """``n_rounds`` batched speculative rounds of every slot
        (``speculative.spec_round_batched``): slots with ``fresh >= 0`` start
        from that token, the others from ``prev_last`` (the previous chunk's
        last tokens, on the device); ``pos`` [n_slots] host positions;
        inactive slots write nothing and advance nothing.  Returns (tokens
        [n_rounds, n_slots, k + 1] on the device, counts [n_rounds, n_slots]
        on the host, the last tokens, the positions after the rounds (host),
        hist, hlen).  A verify window of n_slots × (k + 1) rows takes #3's
        routes and, on the pool, #10."""
        def forward(window, cache, pos, **kw):
            return self._forward_on(cache, window, pos, **kw)

        tokens = torch.where(fresh >= 0, fresh, prev_last)
        carry = (tokens, self.cache, np.asarray(pos, np.int64), hist, hlen, temps, topps, generator or self._gen)
        toks, counts = [], []
        for _ in range(n_rounds):
            carry, (t, c) = spec_round_batched(forward, carry, self.spec_k, self.allocator.tables, active)
            toks.append(t)
            counts.append(c)
        last, self.cache, pos, hist, hlen = carry[:5]
        return torch.stack(toks), np.stack(counts), last, pos, hist, hlen

    # ------------------------------------------------------- tensor parallel
    def _sync(self, op: str) -> None:
        """Rank 0: tell every worker what to do next (``op``), with the
        requests submitted since the last step.  Raises if a worker is gone."""
        if self._tp == 1:
            return
        if self._rank != 0 or self._group is None:
            raise RuntimeError("only rank 0 drives a tensor-parallel engine, and only until close()")
        if self._broken:
            raise RuntimeError("a step of this tensor-parallel engine failed; its ranks are out of step")
        reqs = [{f: getattr(r, f) for f in _REQUEST_FIELDS} for r in self._outbox] if op == "step" else []
        try:
            self.mesh.workers.check()
            torch.distributed.broadcast_object_list([(op, reqs)], src=0, group=self._group)
        except BaseException:
            self._broken = True
            raise
        if op == "step":
            self._outbox.clear()
        self._last_sync = time.monotonic()

    def worker_loop(self) -> None:
        """Ranks 1..N-1: follow rank 0's engine, step for step, until it
        closes."""
        while True:
            box = [None]
            torch.distributed.broadcast_object_list(box, src=0, group=self._group)
            op, reqs = box[0]
            if op == "stop":
                return
            if op == "step":
                for fields in reqs:
                    self.submit(Request(**fields))
                self._step()
            elif op == "warmup":
                self._warmup()
            elif op == "reset":
                self._reset_counters()
            elif op == "report":
                torch.distributed.gather_object(self._report(), None, dst=0, group=self._group)

    def heartbeat(self) -> None:
        """Rank 0 of an idle tp engine: tell the workers it is alive, at most
        every ``HEARTBEAT_S`` seconds, so that their wait for the next step
        never reaches the collectives' timeout."""
        if self._tp > 1 and time.monotonic() - self._last_sync >= HEARTBEAT_S:
            self._sync("heartbeat")

    def close(self, force: bool = False) -> None:
        """Rank 0 of a tp engine: stop the workers, join them and leave the
        process group.  The engine takes no step after it.  ``force``: the
        ranks may be out of step (a step still runs in another thread), so
        the workers are stopped without a message."""
        if self._tp == 1 or self._group is None:
            return
        self._broken |= force
        try:
            if not self._broken:
                self._sync("stop")
        finally:
            if self._broken:
                self.mesh.workers.join(timeout=0)  # out of step: stop them now
            self.mesh.close()
            self._group = None

    def _reset_counters(self) -> None:
        reset_launches()
        collectives.reset_counts()

    def reset_counters(self) -> None:
        """Zero the kernel launch and collective counts of every rank."""
        self._sync("reset")
        self._reset_counters()

    def _report(self) -> dict:
        return {"rank": self._rank, "streams": {r.request_id: list(r.generated) for r in self.completed},
                "launches": dict(LAUNCHES), "collectives": dict(collectives.COUNTS)}

    def rank_reports(self) -> list[dict]:
        """Every rank's completed streams, kernel launches and collective
        counts since the last ``reset_counters``, rank 0 first (one rank:
        this one's)."""
        if self._tp == 1:
            return [self._report()]
        self._sync("report")
        out = [None] * self._tp
        torch.distributed.gather_object(self._report(), out, dst=0, group=self._group)
        return out

    # ------------------------------------------------------------------ api
    def warmup(self) -> None:
        """Build the kernels and run one prefill per warmed bucket and one
        decode step, so that the first requests' TTFT does not include them.

        Safe on live state: every write goes to the null page (zeroed page
        tables) or the dense scratch cache, and the decode step runs with
        every slot masked."""
        self._sync("warmup")
        self._warmup()

    def _warmup(self) -> None:
        if self.device.type == "cuda":
            build.build()
        device = self.sampling == "device"
        # Warm-up draws come from a generator of their own: the engine's
        # stream stays as it would be without the warm-up.
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        for b in self._warm_buckets():
            s_pad = min(b, self.config.seq_len)
            tokens = np.zeros((1, s_pad), np.int64)
            if self.kv_layout == "paged":
                tables = np.zeros((1, self.allocator.max_pages_per_slot), np.int32)
                if device:
                    self._prefill_paged_sampled(tokens, [0], tables, None, [0.0], [1.0], [],
                                                self._to_device(np.full(self.n_slots, -1), torch.int32), gen)
                else:
                    self._prefill_paged(tokens, [0], tables)
            else:
                _, self._scratch_cache = self._forward_on(self._scratch_cache, tokens, [0], out_idx=[0],
                                                          fresh_prefill=True)
        inactive = np.zeros(self.n_slots, bool)
        if device:
            zeros = torch.zeros(self.n_slots, dtype=torch.int32, device=self.device)
            self._decode_chunked(zeros, zeros, self.slot_pos.copy(), inactive, np.zeros(self.n_slots, np.float32),
                                 np.ones(self.n_slots, np.float32),
                                 max(1, min(self.decode_chunk_steps, self.config.seq_len)), gen)
        if self.spec_k and self.config.seq_len >= self.spec_k + 1:
            # A speculative round, and the plain step of the context-end taper.
            hist = torch.zeros(self.n_slots, self.config.seq_len, dtype=torch.int32, device=self.device)
            self._decode_spec(zeros, zeros, np.zeros(self.n_slots, np.int64), inactive,
                              np.zeros(self.n_slots, np.float32), np.ones(self.n_slots, np.float32), hist,
                              torch.zeros(self.n_slots, dtype=torch.int32, device=self.device), 1, gen)
        if not device or self.spec_k:
            self._decode(inactive)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, request: Request) -> None:
        request.submit_time = time.perf_counter()
        request.state = RequestState.QUEUED
        request._sampler = Sampler(request.temperature, request.topp, request.seed)
        self.queue.append(request)
        if self._tp > 1 and self._rank == 0:
            self._outbox.append(request)

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.slot_request)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.active_count > 0 or self._inflight is not None or bool(self._partials)

    def _ladder(self) -> list[int]:
        """The widths above the largest declared bucket (last bucket × 2^k,
        capped at seq_len), for both ``_bucket`` and ``_warm_buckets``."""
        out = []
        b = self.prefill_buckets[-1]
        while b < self.config.seq_len:
            b = min(b * 2, self.config.seq_len)
            out.append(b)
        return out

    def _warm_buckets(self) -> list[int]:
        """The declared buckets plus the ladder rungs up to 4096 rows (the
        reference's default warm set): the admission snaps a prefix-cache
        hit's window to one of these."""
        cap = min(self.config.seq_len, 4096)
        warm = list(self.prefill_buckets)
        warm += [b for b in self._ladder() if b <= max(cap, warm[-1])]
        return sorted(set(warm))

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        for b in self._ladder():
            if n <= b:
                return b
        return self.config.seq_len

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_request):
            if r is None:
                return i
        return None

    # ------------------------------------------------------------ scheduling
    def step(self) -> list[tuple[Request, int]]:
        """One scheduler iteration.  Returns the (request, token) pairs emitted."""
        self._sync("step")
        try:
            return self._step()
        except BaseException:
            self._broken = self._tp > 1  # the other ranks may wait in a collective of this step
            raise

    def _step(self) -> list[tuple[Request, int]]:
        emitted: list[tuple[Request, int]] = []
        # Device sampling on the pool defers admissions: their first tokens
        # stay on the device, chained into the next chunk's input (``fresh``),
        # and are read only after that chunk is dispatched.
        deferred = self.sampling == "device" and self.kv_layout == "paged"
        prev = self._inflight
        # When the acceptance-adaptive policy switched modes since the last
        # dispatch, read the previous chunk first: chunks of the two kinds do
        # not chain, and an empty pipeline starts from exact host state.
        use_spec = self.spec_k > 0 and self._spec_enabled
        if self.spec_k and prev is not None and ("hist" in prev) != use_spec:
            self._inflight = None
            if "hist" in prev:
                self._process_spec_chunk(prev, emitted)
            else:
                self._process_chunk(prev, emitted)
            prev = None
        fresh = self._to_device(self._fresh_base(prev), torch.int32) if deferred else None
        # Speculative mode: the drafting histories chain on the device from
        # the previous chunk; with none in flight they are rebuilt from the
        # host's exact state.
        spec_state = None
        if use_spec:
            if prev is not None:
                spec_state = {"hist": prev["hist"], "hlen": prev["hlen"]}
            else:
                hist, hlen = self._spec_host_hist()
                spec_state = {"hist": self._to_device(hist, torch.int32), "hlen": self._to_device(hlen, torch.int32)}
        pending: list[dict] = [] if deferred else None
        admitted = 0
        if self.prefill_chunk is not None:
            # Advance every mid-prefill slot by one chunk (and start new
            # partials from the queue head) before the group admission, so
            # that short prompts still admit into the remaining slots.  New
            # partial starts count against max_admissions_per_step.
            fresh, started = self._advance_partials(emitted, fresh, pending, spec_state,
                                                    budget=self.max_admissions_per_step)
            admitted += started
        while True:
            budget = None if self.max_admissions_per_step is None else self.max_admissions_per_step - admitted
            if budget is not None and budget <= 0:
                break
            if self.kv_layout == "paged":
                k, fresh = self._admit_group(emitted, budget, fresh=fresh, pending=pending, spec_state=spec_state)
            else:
                k = 1 if self._admit_one(emitted) else 0
            if k == 0:
                break
            admitted += k
        if use_spec:
            # Dispatch the next speculative chunk, then read the previous one.
            self._inflight = chunk = None
            if self.active_count and not self._all_live_finish_within(prev):
                chunk = self._inflight = self._dispatch_spec_chunk(prev, fresh, spec_state["hist"], spec_state["hlen"])
            for entry in pending:
                self._process_admits(entry, emitted)
            if prev is not None:
                self._process_spec_chunk(prev, emitted)
            # The context-end taper: live slots the chunk could not take
            # (fewer than k + 1 rows left) advance by plain one-token steps on
            # exact state, so that one stream near its end does not take the
            # whole batch out of speculative mode.
            tail = [slot for slot, r in enumerate(self.slot_request)
                    if r is not None and not (chunk is not None and chunk["active"][slot])
                    and not self._provably_done(r, slot) and int(self.slot_pos[slot]) < self.config.seq_len]
            if tail:
                self._decode_all(emitted, slots=tail)
        elif self.sampling == "device":
            # Dispatch the next chunk first, then read the previous one (and
            # the deferred admissions) while it runs.  When every live slot
            # is certain to finish inside the previous chunk, the next one
            # would run for nothing: skip it.
            self._inflight = None
            if self.active_count and not self._all_live_finish_within(prev):
                self._inflight = self._dispatch_chunk(prev, fresh)
                if self.spec_k:
                    self._count_plain_chunk()
            for entry in pending or ():
                self._process_admits(entry, emitted)
            if prev is not None:
                self._process_chunk(prev, emitted)
        elif self.active_count:
            self._decode_all(emitted)
        return emitted

    def _count_plain_chunk(self) -> None:
        """Speculation turned off by the policy: count a plain chunk towards
        the next probe.  The probe fires only on traffic where some live
        stream repeats a bigram (the drafter has nothing to draft otherwise);
        a held probe is checked again every ``_SPEC_GATE_RECHECK`` chunks,
        and after ``_SPEC_GATE_MAX_HOLDS`` holds it fires all the same."""
        self._spec_plain_chunks += 1
        if self._spec_plain_chunks < self._spec_probe_interval:
            return
        if self._traffic_repetitive() or self._spec_probes_gated - self._spec_gate_base >= self._SPEC_GATE_MAX_HOLDS:
            self._spec_enabled = True
            self._spec_accept_ewma = None
            self._spec_chunks_seen = 0
            self._spec_plain_chunks = 0
            self._spec_gate_base = self._spec_probes_gated
        else:
            self._spec_probes_gated += 1
            self._spec_plain_chunks = max(0, self._spec_probe_interval - self._SPEC_GATE_RECHECK)

    def run(self) -> list[Request]:
        """Drain the queue and the slots; returns the completed requests."""
        while self.has_work:
            self.step()
        return self.completed

    def _admit_one(self, emitted) -> bool:
        """Admit at most one queued request (dense layout).  True if one was
        admitted."""
        slot = self._free_slot()
        if slot is None or not self.queue:
            return False
        req = self.queue.pop(0)
        prompt = req.prompt_tokens[: self.config.seq_len - 1]
        s_real = max(len(prompt), 1)
        s_pad = max(s_real, min(self._bucket(s_real), self.config.seq_len))
        padded = np.zeros((1, s_pad), np.int64)
        padded[0, :s_real] = prompt
        logits, self._scratch_cache = self._forward_on(self._scratch_cache, padded, [0], out_idx=[s_real - 1],
                                                       fresh_prefill=True)
        # Copy the scratch window into the slot (padding rows included: they
        # sit past the request's position until decode overwrites them).
        for big, small in zip(self.cache, self._scratch_cache):
            big[:, slot, :, :s_pad] = small[:, 0, :, :s_pad]
        first = req._sampler.sample(logits[0].float().cpu().numpy())
        self._activate(req, slot, s_real, first, emitted)
        return True

    def _pad_group(self, k: int) -> int:
        """A group size padded to a power of two (capped at n_slots)."""
        p = 1
        while p < k:
            p *= 2
        return min(p, self.n_slots)

    def _admit_group(self, emitted, budget: int | None, *, fresh=None, pending=None,
                     spec_state=None) -> tuple[int, object]:
        """Admit a group of queued requests with one batched prefill (paged
        layout).  The group is the longest FCFS prefix that shares a prompt
        bucket and a fresh/continued mode, fits in the free slots and pages,
        and respects ``budget``; the step() loop admits the next group at
        once.  Returns (the number admitted, ``fresh``).

        With ``pending`` (device sampling) the admission is deferred: the
        first tokens are sampled on the device and scattered into ``fresh``
        for the next chunk, and ``_process_admits`` reads them after that
        chunk's dispatch; with ``spec_state`` each slot's drafting history is
        seeded on the device too."""
        free = [i for i, r in enumerate(self.slot_request) if r is None and i not in self._partials]
        if not free or not self.queue:
            return 0, fresh
        limit = len(free) if budget is None else min(len(free), budget)
        # (request, prompt_len, hit_rows, hit_pages): hit_* nonzero only with
        # prefix_cache on and an indexed prefix match.
        picks: list[tuple[Request, int, int, list[int]]] = []
        bucket = 0
        cont_group = False
        avail = self.allocator.free_pages
        for req in self.queue:
            if len(picks) == limit:
                break
            prompt_len = min(max(len(req.prompt_tokens), 1), self.config.seq_len - 1)
            if self.prefix_cache:
                hpages, hrows = self.allocator.match_prefix(req.prompt_tokens[:prompt_len], self.page_size)
            else:
                hpages, hrows = [], 0
            # The window holds only the prompt suffix on a hit; the bucket
            # follows the suffix length.
            suffix = prompt_len - hrows
            if self.prefill_chunk is not None and suffix > self.prefill_chunk:
                break  # chunked prefill takes it (FCFS: end the group)
            # Cap the padded window so that padding rows stay inside the
            # context after a prefix hit, snapping to a warmed width that
            # covers the suffix under the cap.
            allowed = self.config.seq_len - hrows
            b_width = self._bucket(suffix)
            if b_width > allowed:
                fits = [w for w in self._warm_buckets() if suffix <= w <= allowed]
                b_width = min(fits) if fits else allowed
            s_pad = max(suffix, min(b_width, allowed))
            cont = hrows > 0
            if not picks:
                bucket, cont_group = s_pad, cont
            elif s_pad != bucket or cont != cont_group:
                break
            # Reserve the whole request's pages up front; too few free pages
            # leave it queued (backpressure; FCFS never skips past it).
            # Padding rows write up to hrows + s_pad, decode rows up to
            # hrows + suffix + max_new: the two overlap, so take the max.
            worst_rows = min(self.config.seq_len, hrows + max(s_pad, suffix + req.max_new_tokens + 1))
            need = -(-worst_rows // self.page_size)
            if need > avail:
                break
            avail -= need
            picks.append((req, prompt_len, hrows, hpages))
        if not picks:
            if self.active_count == 0 and self._inflight is None and not self._partials:
                head = self.queue[0]
                # Leave the head to _advance_partials only when it would take
                # it (it routes by the prefix-adjusted suffix).
                if self.prefill_chunk is not None:
                    plen = min(max(len(head.prompt_tokens), 1), self.config.seq_len - 1)
                    head_hrows = (
                        self.allocator.match_prefix(head.prompt_tokens[:plen], self.page_size)[1]
                        if self.prefix_cache else 0
                    )
                    if plen - head_hrows > self.prefill_chunk:
                        return 0, fresh
                raise RuntimeError(
                    f"request {head.request_id} needs more KV pages than the pool holds "
                    f"({self.allocator.n_pages}); raise n_pages or lower max_new_tokens"
                )
            return 0, fresh  # wait for active requests to release pages

        k = len(picks)
        k_pad = self._pad_group(k)
        del self.queue[:k]
        tokens = np.zeros((k_pad, bucket), np.int64)
        out_idx = np.zeros(k_pad, np.int64)
        pos0 = np.zeros(k_pad, np.int64)
        tables = np.zeros((k_pad, self.allocator.max_pages_per_slot), np.int32)
        slots: list[int] = []
        # Pin every pick's matched pages first, so that an earlier pick's
        # allocation cannot evict a later pick's still-cached match.
        for i, (_, _, _, hpages) in enumerate(picks):
            if hpages:
                self.allocator.adopt(free[i], hpages)
        for i, (req, prompt_len, hrows, _) in enumerate(picks):
            slot = free[i]
            suffix = prompt_len - hrows
            worst_rows = min(self.config.seq_len, hrows + max(bucket, suffix + req.max_new_tokens + 1))
            self.allocator.ensure_capacity(slot, worst_rows, self.page_size)
            tokens[i, :suffix] = req.prompt_tokens[hrows:prompt_len]
            out_idx[i] = suffix - 1
            pos0[i] = hrows
            tables[i] = self.allocator.tables[slot]
            slots.append(slot)
        if self.prefix_cache:
            for i, (req, prompt_len, hrows, _) in enumerate(picks):
                self.allocator.register_prefix(slots[i], req.prompt_tokens[:prompt_len], self.page_size)
                if hrows:
                    self._prefix_hits += 1
                    self._prefix_rows_reused += hrows
        # Padding rows (i >= k) keep zero tokens and all-null page tables:
        # their K/V lands in the null page, which no request reads.
        pos = pos0 if cont_group else None
        if pending is not None:
            pairs = [(r, pl) for r, pl, _, _ in picks]
            toks, fresh = self._prefill_paged_sampled(tokens, out_idx, tables, pos,
                                                      *self._sampling_rows([r for r, _ in pairs], k_pad), slots, fresh,
                                                      spec_state=spec_state, picks=pairs)
            for i, (req, prompt_len) in enumerate(pairs):
                self._occupy(req, slots[i], prompt_len)
            pending.append({"toks": self._to_host(toks[:k]), "picks": pairs})
            return k, fresh
        logits = self._prefill_paged(tokens, out_idx, tables, pos)
        logits_np = logits[:k].float().cpu().numpy()
        for i, (req, prompt_len, _, _) in enumerate(picks):
            self._occupy(req, slots[i], prompt_len)
            self._first_token(req, req._sampler.sample(logits_np[i]), emitted)
        return k, fresh

    @staticmethod
    def _sampling_rows(reqs, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-row temperatures and top-p of ``rows`` rows: the requests',
        then greedy padding (an empty row is None)."""
        temps = np.zeros(rows, np.float32)
        topps = np.ones(rows, np.float32)
        for i, r in enumerate(reqs):
            if r is not None:
                temps[i], topps[i] = r.temperature, r.topp
        return temps, topps

    def _advance_partials(self, emitted, fresh=None, pending=None, spec_state=None, *,
                          budget=None) -> tuple[object, int]:
        """Chunked prefill: start new partial prefills from the queue head and
        advance every partial by one chunk.  Intermediate chunks only write
        the cache; a partial's final chunk samples its first token (deferred,
        as ``_admit_group``'s, with ``pending``).  ``budget`` caps the new
        starts.  Returns (``fresh``, the number started)."""
        chunk = self.prefill_chunk
        started = 0
        while self.queue:
            if budget is not None and started >= budget:
                break
            req = self.queue[0]
            prompt_len = min(max(len(req.prompt_tokens), 1), self.config.seq_len - 1)
            if self.prefix_cache:
                hpages, hrows = self.allocator.match_prefix(req.prompt_tokens[:prompt_len], self.page_size)
            else:
                hpages, hrows = [], 0
            if prompt_len - hrows <= chunk:
                break  # one window: the group admission takes it
            free = [i for i, r in enumerate(self.slot_request) if r is None and i not in self._partials]
            if not free:
                break
            worst_rows = min(self.config.seq_len, prompt_len + req.max_new_tokens + 1)
            need = -(-worst_rows // self.page_size)
            if need > self.allocator.free_pages:
                # Backpressure; if nothing holds pages, it never fits.
                if self.active_count == 0 and self._inflight is None and not self._partials:
                    raise RuntimeError(
                        f"request {req.request_id} needs more KV pages than the pool holds "
                        f"({self.allocator.n_pages}); raise n_pages or lower max_new_tokens"
                    )
                break
            slot = free[0]
            self.queue.pop(0)
            if hpages:
                self.allocator.adopt(slot, hpages)
                self._prefix_hits += 1
                self._prefix_rows_reused += hrows
            self.allocator.ensure_capacity(slot, worst_rows, self.page_size)
            self._partials[slot] = {"req": req, "done": hrows, "plen": prompt_len}
            started += 1
        if not self._partials:
            return fresh, started
        # One chunk per partial per step; intermediate chunks share one wave,
        # final chunks group by their suffix bucket.
        inter = [s for s, p in self._partials.items() if p["plen"] - p["done"] > chunk]
        final = [s for s, p in self._partials.items() if p["plen"] - p["done"] <= chunk]
        if inter:
            self._partial_wave(sorted(inter), chunk, final=False, emitted=emitted)
        by_bucket: dict[int, list[int]] = {}
        for s in final:
            rem = self._partials[s]["plen"] - self._partials[s]["done"]
            b = max(rem, min(self._bucket(rem), self.config.seq_len))
            by_bucket.setdefault(b, []).append(s)
        for b, slots in sorted(by_bucket.items()):
            fresh = self._partial_wave(sorted(slots), b, final=True, emitted=emitted, fresh=fresh, pending=pending,
                                       spec_state=spec_state)
        return fresh, started

    def _partial_wave(self, slots, win, *, final, emitted, fresh=None, pending=None, spec_state=None):
        """One batched continued prefill over partial slots: ``win`` prompt
        rows per slot from each slot's done-rows offset.  Returns ``fresh``."""
        k = len(slots)
        k_pad = self._pad_group(k)
        tokens = np.zeros((k_pad, win), np.int64)
        out_idx = np.zeros(k_pad, np.int64)
        pos0 = np.zeros(k_pad, np.int64)
        tables = np.zeros((k_pad, self.allocator.max_pages_per_slot), np.int32)
        for i, s in enumerate(slots):
            p = self._partials[s]
            n = min(win, p["plen"] - p["done"])
            tokens[i, :n] = p["req"].prompt_tokens[p["done"] : p["done"] + n]
            out_idx[i] = n - 1
            pos0[i] = p["done"]
            tables[i] = self.allocator.tables[s]
        self._partial_waves += 1
        if not final:
            self._prefill_paged(tokens, out_idx, tables, pos0)  # cache writes only
            for i, s in enumerate(slots):
                self._partials[s]["done"] += int(out_idx[i]) + 1
            return fresh
        picks = [(self._partials[s]["req"], self._partials[s]["plen"]) for s in slots]
        for s in slots:
            del self._partials[s]
        if pending is not None:
            toks, fresh = self._prefill_paged_sampled(tokens, out_idx, tables, pos0,
                                                      *self._sampling_rows([r for r, _ in picks], k_pad), slots, fresh,
                                                      spec_state=spec_state, picks=picks)
            for i, (req, plen) in enumerate(picks):
                self._occupy(req, slots[i], plen)
            pending.append({"toks": self._to_host(toks[:k]), "picks": picks})
        else:
            logits = self._prefill_paged(tokens, out_idx, tables, pos0)
            logits_np = logits[:k].float().cpu().numpy()
            for i, (req, plen) in enumerate(picks):
                self._occupy(req, slots[i], plen)
                self._first_token(req, req._sampler.sample(logits_np[i]), emitted)
        if self.prefix_cache:
            # Register only now that every prompt page is written: a partial
            # registered at its start would let another admission adopt
            # half-written pages.
            for i, (req, plen) in enumerate(picks):
                self.allocator.register_prefix(slots[i], req.prompt_tokens[:plen], self.page_size)
        return fresh

    def _occupy(self, req: Request, slot: int, s_real: int) -> None:
        """Bind an admitted request to its slot."""
        req.state = RequestState.ACTIVE
        req.slot = slot
        req._next_pos = s_real
        self.slot_request[slot] = req
        self.slot_pos[slot] = s_real

    def _first_token(self, req: Request, first: int, emitted) -> None:
        req.first_token_time = time.perf_counter()
        if req.slot is not None:
            self.slot_token[req.slot] = first
        self._emit(req, first, emitted)

    def _activate(self, req: Request, slot: int, s_real: int, first: int, emitted) -> None:
        self._occupy(req, slot, s_real)
        self._first_token(req, first, emitted)

    def _decode_all(self, emitted, slots=None) -> None:
        """One single-token step of every active slot, or of ``slots`` alone
        (the speculative taper; the other slots' writes are masked)."""
        active = np.array([r is not None and (slots is None or i in slots) for i, r in enumerate(self.slot_request)])
        logits_np = self._decode(active).float().cpu().numpy()
        self._decode_steps += 1
        for slot, req in enumerate(self.slot_request):
            if req is None or not active[slot]:
                continue
            self._decode_tokens += 1
            self.slot_pos[slot] += 1
            if self.slot_pos[slot] >= self.config.seq_len:
                self._finish(req, "length")
                continue
            token = req._sampler.sample(logits_np[slot])
            self.slot_token[slot] = token
            self._emit(req, token, emitted)

    # ------------------------------------------------------- device sampling
    def _process_admits(self, entry: dict, emitted) -> None:
        """Read a deferred admission group's first tokens (the chunk that
        consumes them is already dispatched) and emit them."""
        firsts = self._host_array(entry["toks"])
        for i, (req, _) in enumerate(entry["picks"]):
            self._first_token(req, int(firsts[i]), emitted)

    def _fresh_base(self, prev: Optional[dict]) -> np.ndarray:
        """Host-known starting tokens of the next chunk: -1 for slots that are
        empty or chain on the device from ``prev`` (the same request active
        there), the last processed token otherwise."""
        fresh = np.full(self.n_slots, -1, np.int32)
        for slot, r in enumerate(self.slot_request):
            if r is None:
                continue
            if not (prev is not None and prev["active"][slot] and prev["reqs"][slot] is r):
                fresh[slot] = self.slot_token[slot]
        return fresh

    def _provably_done(self, r: Request, slot: int) -> bool:
        """Whether the request is certain to finish by the tokens already
        dispatched (processed and in flight): ``slot_pos`` is the dispatch
        position, so it less the prompt end and the processed tokens counts
        the unread ones (a deferred first token included).  EOS only ends a
        request earlier, so True is exact.

        While speculative rounds are dispatched and unread, ``slot_pos`` is
        an upper bound (a round advances 1 to k + 1 rows): the tokens certain
        to come are one a round (and a deferred first token).  The rounds'
        bound keeps positions inside the context, and the taper finishes on
        exact state, so there is no context-end clause there."""
        if self.spec_k and (self._spec_enabled or int(self._spec_pending_rounds[slot]) > 0):
            pend = int(self._spec_pending_rounds[slot]) + (1 if r.first_token_time is None else 0)
            return len(r.generated) + pend >= r.max_new_tokens
        pending = int(self.slot_pos[slot]) - (r._next_pos + len(r.generated) - 1)
        return (len(r.generated) + pending >= r.max_new_tokens
                or int(self.slot_pos[slot]) >= self.config.seq_len)

    def _all_live_finish_within(self, prev: Optional[dict]) -> bool:
        """Whether every live slot is certain to finish inside the unread
        chunk ``prev``: the next chunk would decode for nothing."""
        if prev is None:
            return False
        live = [(slot, r) for slot, r in enumerate(self.slot_request) if r is not None]
        return bool(live) and all(self._provably_done(r, s) for s, r in live)

    def _dispatch_chunk(self, prev: Optional[dict], fresh=None) -> dict:
        """Dispatch one device-sampled decode chunk without reading the
        previous one: continuing slots take its last tokens on the device,
        slots (re)admitted since take their known first token.  Slots whose
        request is certain to finish inside ``prev`` are masked out (they
        would otherwise shorten the chunk for every slot near the context
        end); a request that turns out to finish inside ``prev`` decodes on
        here with its tokens dropped and its writes masked or on its own
        released rows, which a later admission's prefill overwrites in
        dispatch order."""
        active = np.array([r is not None and not self._provably_done(r, slot)
                           for slot, r in enumerate(self.slot_request)])
        reqs = list(self.slot_request)
        if fresh is None:  # dense slots: admissions are synchronous, every start is known
            fresh = self._to_device(self._fresh_base(prev), torch.int32)
        prev_last = torch.zeros(self.n_slots, dtype=torch.int32, device=self.device) if prev is None else prev["last"]
        pos0 = self.slot_pos.copy()
        live_pos = pos0[active]
        max_pos = int(live_pos.max()) if live_pos.size else 0
        n_steps = max(1, min(self.decode_chunk_steps, self.config.seq_len - max_pos))
        toks, last = self._decode_chunked(prev_last, fresh, pos0, active, *self._sampling_rows(reqs, self.n_slots),
                                          n_steps)
        # Dispatch-time positions advance now; request state when it is read.
        self.slot_pos[active] += n_steps
        return {"toks": self._to_host(toks), "last": last, "n_steps": n_steps, "pos0": pos0, "active": active,
                "reqs": reqs}

    def _process_chunk(self, chunk: dict, emitted) -> None:
        """Read one chunk's tokens and emit them; EOS and length end a
        request on the host (its rows past that point are never read)."""
        toks_np = self._host_array(chunk["toks"])  # [n_steps, B]
        n_steps = chunk["n_steps"]
        self._decode_steps += n_steps
        for slot, req in enumerate(chunk["reqs"]):
            if req is None or req.state is not RequestState.ACTIVE:
                continue  # empty at dispatch, or finished in an earlier chunk
            pos = int(chunk["pos0"][slot])
            for i in range(n_steps):
                self._decode_tokens += 1
                pos += 1
                if pos >= self.config.seq_len:
                    self._finish(req, "length")
                    break
                token = int(toks_np[i, slot])
                self.slot_token[slot] = token
                self._emit(req, token, emitted)
                if req.state is RequestState.DONE:
                    break

    # ---------------------------------------------------------- speculative
    def _spec_n_rounds(self, avail: int) -> int:
        """The largest round bucket that fits ``avail`` rounds (0: none)."""
        cap = min(avail, max(self.decode_chunk_steps, 1))
        return next((rb for rb in self._SPEC_ROUND_BUCKETS if rb <= cap), 0)

    def _spec_host_hist(self) -> tuple[np.ndarray, np.ndarray]:
        """Every slot's drafting history from the host's exact request state
        (no chunk in flight): prompt (cut as admission cuts it) and generated
        tokens, the last ``seq_len`` of them, ending with the slot's pending
        input token."""
        t = self.config.seq_len
        hist = np.zeros((self.n_slots, t), np.int32)
        hlen = np.zeros(self.n_slots, np.int32)
        for slot, req in enumerate(self.slot_request):
            if req is None:
                continue
            h = (list(req.prompt_tokens[: t - 1]) + req.generated)[-t:]
            hist[slot, : len(h)] = h
            hlen[slot] = len(h)
        return hist, hlen

    def _dispatch_spec_chunk(self, prev, fresh, hist_in, hlen_in) -> Optional[dict]:
        """Run one speculative chunk without reading the previous one's tokens
        (the pipelining of ``_dispatch_chunk``): slots that chain from
        ``prev`` take its last tokens, positions and histories, slots with
        ``fresh >= 0`` their known token and position.  Slots with fewer than
        k + 1 rows left are masked out (``step()`` finishes them on plain
        steps) rather than cutting every slot's rounds.  None when no slot
        can run a round.

        The rounds read their counts on the host, so the chunk's positions
        are exact when it returns; ``slot_pos`` takes the upper bound
        ``n_rounds·(k + 1)`` all the same, as the reference's does, until the
        chunk is read."""
        k = self.spec_k
        seq_len = self.config.seq_len
        active = np.array([r is not None and not self._provably_done(r, slot)
                           and seq_len - int(self.slot_pos[slot]) >= k + 1
                           for slot, r in enumerate(self.slot_request)])
        if not active.any():
            return None
        n_rounds = self._spec_n_rounds((seq_len - int(self.slot_pos[active].max())) // (k + 1))
        if n_rounds == 0:
            return None
        reqs = list(self.slot_request)
        # The slots that chain from prev are those with fresh < 0 (``_fresh_base``).
        chained = np.array([prev is not None and r is not None and prev["active"][s] and prev["reqs"][s] is r
                            for s, r in enumerate(reqs)])
        pos = np.where(chained, prev["pos"] if prev is not None else 0, self.slot_pos)
        prev_last = torch.zeros(self.n_slots, dtype=torch.int32, device=self.device) if prev is None else prev["last"]
        toks, counts, last, pos, hist, hlen = self._decode_spec(prev_last, fresh, pos, active,
                                                                *self._sampling_rows(reqs, self.n_slots),
                                                                hist_in, hlen_in, n_rounds)
        self.slot_pos[active] += n_rounds * (k + 1)
        self._spec_pending_rounds[active] += n_rounds
        return {"toks": self._to_host(toks), "counts": counts, "last": last, "pos": pos, "hist": hist, "hlen": hlen,
                "n_rounds": n_rounds, "active": active, "reqs": reqs}

    def _process_spec_chunk(self, chunk: dict, emitted) -> None:
        """Read one speculative chunk: emit each slot's accepted runs, set its
        exact position (prompt and generated less the pending input, plus the
        reservation of the chunk still in flight), and feed the acceptance
        policy."""
        toks_np = self._host_array(chunk["toks"])  # [n_rounds, B, k + 1]
        counts_np = chunk["counts"]  # [n_rounds, B]
        n_rounds = chunk["n_rounds"]
        self._decode_steps += n_rounds
        for slot, req in enumerate(chunk["reqs"]):
            if req is None or req.state is not RequestState.ACTIVE or not chunk["active"][slot]:
                continue  # empty, finished earlier, or masked at dispatch
            pos = req._next_pos + len(req.generated) - 1  # the chunk's exact start
            for r in range(n_rounds):
                for i in range(int(counts_np[r, slot])):
                    self._decode_tokens += 1
                    pos += 1
                    if pos >= self.config.seq_len:
                        # As the plain path: the token from the last context row is dropped.
                        self._finish(req, "length")
                        break
                    token = int(toks_np[r, slot, i])
                    self.slot_token[slot] = token
                    self._emit(req, token, emitted)
                    if req.state is not RequestState.ACTIVE:
                        break
                if req.state is not RequestState.ACTIVE:
                    break
            if req.state is not RequestState.ACTIVE:
                continue
            self._spec_pending_rounds[slot] = max(0, self._spec_pending_rounds[slot] - n_rounds)
            inflight = self._inflight
            reserved = (inflight["n_rounds"] * (self.spec_k + 1)
                        if inflight is not None and "hist" in inflight and inflight["active"][slot]
                        and inflight["reqs"][slot] is req else 0)
            self.slot_pos[slot] = req._next_pos + len(req.generated) - 1 + reserved
        # The EWMA of the tokens a round over this chunk's live slots.
        act = [s for s, r in enumerate(chunk["reqs"]) if r is not None and chunk["active"][s]]
        if not act or not n_rounds:
            return
        mean_tok = float(counts_np[:, act].mean())
        w = 0.2
        self._spec_chunks_seen += 1
        self._spec_accept_ewma = mean_tok if self._spec_accept_ewma is None else (
            (1 - w) * self._spec_accept_ewma + w * mean_tok)
        # Not one draft accepted after two chunks: cold histories show some
        # acceptance where there is any, so the grace is not waited out.
        zero_accept = self._spec_chunks_seen >= 2 and self._spec_accept_ewma <= 1.05
        if (self._spec_enabled and (zero_accept or self._spec_chunks_seen >= self._SPEC_GRACE_CHUNKS)
                and self._spec_accept_ewma < self.spec_min_accept):
            self._spec_enabled = False
            self._spec_plain_chunks = 0
            if self._spec_chunks_seen <= self._SPEC_GRACE_CHUNKS + 2:
                # The probe failed at the grace's end: back off the next one.
                self._spec_probe_interval = min(self._spec_probe_interval * 2, 1024)
            else:
                # It paid for a while before the EWMA sank: the traffic changed.
                self._spec_probe_interval = self.spec_probe_chunks

    def _traffic_repetitive(self) -> bool:
        """Whether some live stream's last ``_SPEC_GATE_WINDOW`` tokens (prompt
        tail and generated) repeat a bigram: the drafter can accept nothing
        otherwise, so a probe there only pays its grace chunks.  The tails are
        cut before they are joined."""
        w = self._SPEC_GATE_WINDOW
        for r in self.slot_request:
            if r is None:
                continue
            seq = (list(r.prompt_tokens[-w:]) + list(r.generated[-w:]))[-w:]
            seen = set()
            for pair in zip(seq, seq[1:]):
                if pair in seen:
                    return True
                seen.add(pair)
        return False

    def _emit(self, req: Request, token: int, emitted) -> None:
        if token in req.eos_token_ids:
            self._finish(req, "stop")
            return
        req.generated.append(token)
        emitted.append((req, token))
        if len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str) -> None:
        req.state = RequestState.DONE
        req.finish_time = time.perf_counter()
        req.finish_reason = reason
        if req.slot is not None:
            if self.allocator is not None:
                self.allocator.release(req.slot)
            self.slot_request[req.slot] = None
            self.slot_pos[req.slot] = 0
            self.slot_token[req.slot] = 0
            self._spec_pending_rounds[req.slot] = 0
            req.slot = None
        self.completed.append(req)

    # -------------------------------------------------------------- metrics
    def stats(self) -> dict:
        done = [r for r in self.completed if r.finish_time]
        ttfts = sorted(r.ttft for r in done if r.ttft is not None)
        out = {
            "completed": len(done),
            "decode_steps": self._decode_steps,
            "decode_tokens": self._decode_tokens,
            "p50_ttft": ttfts[len(ttfts) // 2] if ttfts else None,
            "slot_utilization": (
                self._decode_tokens / (self._decode_steps * self.n_slots) if self._decode_steps else 0.0
            ),
        }
        if self.spec_k:
            out["spec_enabled"] = self._spec_enabled
            out["spec_accept_ewma"] = self._spec_accept_ewma
            out["spec_probes_gated"] = self._spec_probes_gated
        if self.allocator is not None:
            out["kv_pages_total"] = self.allocator.n_pages - 1
            out["kv_pages_free"] = self.allocator.free_pages
        if self.prefix_cache:
            out["prefix_hits"] = self._prefix_hits
            out["prefix_rows_reused"] = self._prefix_rows_reused
            out["prefix_cached_pages"] = self.allocator.cached_pages
        if self.prefill_chunk is not None:
            out["prefill_waves"] = self._partial_waves
        return out


def _engine_rank(mesh, source: Callable, engine_kw: dict) -> None:
    """A worker rank of ``start_tp_engine``: its own engine over its shard,
    following rank 0."""
    config, weights = source()
    engine = ContinuousBatchingEngine(config=config, weights=weights, mesh=mesh, **engine_kw)
    del config, weights  # only the shard stays
    engine.worker_loop()


def start_tp_engine(source: Callable, devices, **engine_kw) -> ContinuousBatchingEngine:
    """A tensor-parallel engine over ``devices`` (one rank each; a card may
    hold more than one rank): ranks 1..N-1 start as processes of their own,
    and this process is rank 0, whose engine is returned.  ``source()``
    gives (config, weights) on every rank, which takes its shard and frees
    the rest (e.g. ``functools.partial(load_checkpoint, path)``); it and
    ``engine_kw`` must pickle.  ``close()`` stops the workers."""
    mesh = launch(devices, _engine_rank, source, engine_kw)
    try:
        config, weights = source()
        return ContinuousBatchingEngine(config=config, weights=weights, mesh=mesh, **engine_kw)
    except BaseException:
        mesh.workers.join(timeout=0)
        mesh.close()
        raise
