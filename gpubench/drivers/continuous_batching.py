"""Drives ``ContinuousBatchingEngine`` as ``cli.py batch`` builds it.

The engine: the mix's ``engine`` settings (slots, sampling, KV layout),
everything else the CLI's defaults, ``warmup()`` called as the CLI calls it.
It is driven by ``submit()`` and ``step()``.

* Closed loop (``loop.kind`` "closed"): ``backlog`` requests always wait
  behind the slots.  Before the window the slots are filled with requests
  whose outputs are cut to (i + ½)/n_slots of their drawn length, so their
  ends are staggered when it opens.  A request counts if its first token
  comes inside the window.
* Open loop ("open"): requests are submitted when due on the mix's
  schedule, from ``preroll_s`` before the window (the last ``preroll_s`` of
  the schedule's first whole blocks, so that the window opens on a block's
  start and a window of whole blocks takes the same arrivals at every seed);
  one counts if it falls due inside the window, and its times start when it
  was due.

The load goes on after the window until every counted request has finished
(at most ``DRAIN_LIMIT_S``); tokens after the window are not counted.

With ``trace`` the calls into each layer run inside ``record_function``
spans (``Recorder``: ``gpubench.*`` the harness's loop, ``scheduler.*``,
``model.*`` and ``kernel.*`` the program's calls) and their shapes are
recorded for the per-layer readers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from gpubench import traffic

DRAIN_LIMIT_S = 240.0
VOCAB_PAD_MULTIPLE = 2048  # the checkpoint loader pads the classifier's vocab axis to this


@dataclasses.dataclass
class Tracked:
    index: int
    prompt: list
    max_new_tokens: int
    temperature: float
    top_p: float
    due: float  # host clock: when it was due (open loop) or submitted (closed)
    submitted: float = 0.0
    first: float | None = None
    last: float | None = None
    served: list = dataclasses.field(default_factory=list)
    finished: bool = False
    handle: object = None

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _program_weights(w: dict, c):
    """The benchmark's draw in the program's weight layout (the loader's:
    scales of the linear layers and classifier as served, the classifier's
    vocab axis padded with zero codes and unit scales)."""
    from qwen3_rs_tpu_torch.models.qwen3 import Qwen3LayerWeights, Qwen3Weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor

    v = c.vocab_size
    v_pad = v + (-v) % VOCAB_PAD_MULTIPLE if v >= VOCAB_PAD_MULTIPLE else v
    dev = w["embed_q"].device
    lm_q = torch.zeros(c.dim, v_pad, dtype=torch.int8, device=dev)
    lm_s = torch.ones(c.dim // c.group_size, v_pad, dtype=torch.bfloat16, device=dev)
    if "lm_q" in w:
        lm_q[:, :v], lm_s[:, :v] = w["lm_q"], w["lm_s"]
    else:
        lm_q[:, :v], lm_s[:, :v] = w["embed_q"].T, w["embed_s"].T
    layers = Qwen3LayerWeights(
        rms_att=w["rms_att"], rms_ffn=w["rms_ffn"], q_norm=w["q_norm"], k_norm=w["k_norm"],
        **{n: QuantizedTensor(w[n + "_q"], w[n + "_s"]) for n in ("wqkv", "wo", "w13", "w2")})
    return Qwen3Weights(embed=QuantizedTensor(w["embed_q"], w["embed_s"]), layers=layers,
                        rms_final=w["rms_final"], lm_head=QuantizedTensor(lm_q, lm_s))


def _model_config(c):
    from qwen3_rs_tpu_torch.configuration import ARCHITECTURE_QWEN3, ModelConfig

    return ModelConfig(architecture_id=ARCHITECTURE_QWEN3, dim=c.dim, hidden_dim=c.hidden_dim,
                       n_layers=c.n_layers, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
                       seq_len=c.seq_len, vocab_size=c.vocab_size, group_size=c.group_size,
                       shared_classifier=c.tied, norm_eps=c.norm_eps, rope_theta=c.rope_theta,
                       use_qk_norm=True).validate()


class Recorder:
    """The traced window's spans and the shapes of the calls they wrap."""

    def __init__(self):
        self.calls: list[dict] = []
        self._chunk = None
        self._undo = []

    def _wrap(self, owner, attr: str, span, note=None, after=None):
        """Run ``owner.attr`` inside the span ``span`` (or the name that
        ``note``, called first with the call's arguments, returns)."""
        fn = getattr(owner, attr)

        def call(*a, **kw):
            name = span
            if note is not None:
                name = note(*a, **kw) or span
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                if after is not None:
                    after()

        self._undo.append((owner, attr, fn, attr in vars(owner)))
        setattr(owner, attr, call)

    def install(self, engine) -> None:
        import qwen3_rs_tpu_torch.models.qwen3 as model

        def forward(cache, tokens, pos, **kw):
            b, s = tuple(torch.as_tensor(tokens).shape)
            pos = [int(p) for p in torch.as_tensor(pos).reshape(-1).tolist()]
            if s == 1:
                mask = kw.get("write_mask")
                live = [p for i, p in enumerate(pos) if mask is None or bool(mask[i])]
                self.calls.append({"kind": "decode_step", "positions": live})
            else:
                out = kw.get("out_idx")
                rows = [int(o) + 1 for o in out] if out is not None else [s] * b
                self.calls.append({"kind": "prefill", "rows": rows, "positions": pos})

        def chunk(prev_last, fresh, pos0, active, temps, topps, n_steps, generator=None):
            self._chunk = {"pos0": [int(p) for p in pos0], "active": [bool(a) for a in active], "step": 0}

        def chunk_done():
            self._chunk = None

        def megakernel(*a, **kw):
            # Inside a decode chunk the rows' positions are the chunk's; a
            # launch from the forward is counted by its ``decode_step``.
            ch = self._chunk
            live = None
            if ch:
                live = [p + ch["step"] for p, on in zip(ch["pos0"], ch["active"]) if on]
                ch["step"] += 1
            self.calls.append({"kind": "megakernel", "span": "kernel.megakernel", "positions": live})

        def rows_kernel(x, w, layer, *a, **kw):
            n, d = w.shape[-2:]
            self.calls.append({"kind": "rows", "span": "kernel.rows", "rows": x.numel() // n, "n": n, "d": d,
                               "g": n // w.scales.shape[-2]})

        def attention(q, k, v, *a, **kw):
            b, s, h, hd = q.shape
            self.calls.append({"kind": "prefill_attention", "span": "kernel.prefill_attention", "b": b, "s": s,
                               "h": h, "kv": k.shape[2], "hd": hd})

        def fused(x, w, layer, *a, **kw):
            # The fused kernel's tensor-core route takes windows of 9 to 256 rows.
            n, d = w.shape[-2:]
            rows = x.numel() // x.shape[-1]
            span = "kernel.fused_tc" if 9 <= rows <= 256 else "kernel.fused"
            self.calls.append({"kind": "fused", "span": span, "rows": rows, "n": n, "d": d,
                               "g": n // w.scales.shape[-2]})
            return span

        self._wrap(engine, "_admit_one", "scheduler.admit")
        self._wrap(engine, "_dispatch_chunk", "scheduler.dispatch_chunk")
        self._wrap(engine, "_process_chunk", "scheduler.read_chunk")
        self._wrap(engine, "_forward_on", "model.forward", forward)
        self._wrap(engine, "_decode_chunked", "model.decode_chunk", chunk, chunk_done)
        self._wrap(model, "decode_stack_megakernel", "kernel.megakernel", megakernel)
        self._wrap(model, "qmatmul_w8a16_rows", "kernel.rows", rows_kernel)
        self._wrap(model, "causal_prefill_attention", "kernel.prefill_attention", attention)
        self._wrap(model, "qmatmul_w8a16", "kernel.fused", fused)

    def remove(self) -> None:
        for owner, attr, fn, own in reversed(self._undo):
            if own:
                setattr(owner, attr, fn)
            else:  # the instance's attribute hid the class's method
                delattr(owner, attr)
        self._undo.clear()


def run(ctx) -> dict:
    """Build the engine, run the pre-roll, the window and the drain.
    ``ctx``: ``shapes``, ``mix``, ``weights`` (the draw), ``seed``,
    ``seconds``, ``trace``, ``device``, ``t0`` (the process's start on
    ``time.perf_counter``), ``sync`` (waits for the device).  Returns the
    run's records; ``ctx.release()`` frees the engine."""
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

    c, mix = ctx.shapes, ctx.mix
    eng = mix["engine"]
    engine = ContinuousBatchingEngine(
        config=_model_config(c), weights=_program_weights(ctx.weights, c), n_slots=eng["n_slots"],
        sampling=eng["sampling"], seed=traffic.derive_seed(ctx.seed, 2), kv_layout=eng["kv_layout"],
        page_size=128, n_pages=None, spec_k=0, prefix_cache=False, prefill_chunk=None, device=ctx.device)
    engine.warmup()
    ctx.sync()
    ctx.hold(engine)

    gen = traffic.Generator(mix, ctx.seed, c.vocab_size, c.seq_len)
    loop = mix["loop"]
    tracked: list[Tracked] = []
    by_handle: dict[int, Tracked] = {}
    live: list[Tracked] = []  # submitted and not finished

    def submit(r: traffic.Request, due: float, max_new: int | None = None) -> Tracked:
        t = Tracked(index=r.index, prompt=r.prompt, max_new_tokens=max_new or r.max_new_tokens,
                    temperature=r.temperature, top_p=r.top_p, due=due)
        t.handle = Request(request_id=r.index, prompt_tokens=list(r.prompt), max_new_tokens=t.max_new_tokens,
                           temperature=r.temperature, topp=r.top_p, seed=r.seed, eos_token_ids=())
        t.submitted = time.perf_counter()
        engine.submit(t.handle)
        tracked.append(t)
        live.append(t)
        by_handle[id(t.handle)] = t
        return t

    emitted_at: list[tuple[float, int]] = []  # (host time, tokens) of each step's return

    def step() -> None:
        out = engine.step()
        now = time.perf_counter()
        if out:
            emitted_at.append((now, len(out)))
        for req, tok in out:
            t = by_handle[id(req)]
            if t.first is None:
                t.first = now
            t.last = now
            t.served.append(int(tok))
        for t in [t for t in live if t.handle.state.value == "done"]:
            t.finished = True
            live.remove(t)

    n_slots = eng["n_slots"]
    closed = loop["kind"] == "closed"
    pending: traffic.Request | None = None
    prof = None

    def start_profiler() -> None:
        # Starting the profiler stalls the host for seconds: an open loop
        # starts it before its schedule, so that no arrival waits on it.
        nonlocal prof
        ctx.sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if str(ctx.device).startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    if closed:
        for i in range(n_slots):
            r = gen.next()
            submit(r, time.perf_counter(), max(2, math.ceil(r.max_new_tokens * (i + 0.5) / n_slots)))
        for _ in range(loop["backlog"]):
            submit(gen.next(), time.perf_counter())
        step()  # admits every slot
        start = None
    else:
        pre = math.ceil(loop["preroll_s"] / gen.block_seconds) * gen.block_seconds
        skip = pre - loop["preroll_s"]
        pending = gen.next()
        while pending.due_s < skip:
            pending = gen.next()
        if ctx.trace:
            start_profiler()
        start = time.perf_counter() - skip
        sched_open = start + pre

    def feed(now: float) -> None:
        nonlocal pending
        if closed:
            while len(engine.queue) < loop["backlog"]:
                submit(gen.next(), now)
            return
        while pending is not None and start + pending.due_s <= now:
            submit(pending, start + pending.due_s)
            pending = gen.next()

    def span(name: str):
        return torch.profiler.record_function(name) if ctx.trace else contextlib.nullcontext()

    def advance() -> None:
        now = time.perf_counter()
        feed(now)
        if engine.has_work:
            with span("gpubench.step"):
                step()
        elif pending is not None:
            with span("gpubench.wait"):
                time.sleep(max(0.0, min(start + pending.due_s - now, 0.05)))

    if not closed:
        while time.perf_counter() < sched_open:
            advance()

    rec = Recorder() if ctx.trace else None
    if ctx.trace:
        if prof is None:
            start_profiler()
        rec.install(engine)
    stats0 = engine.stats()
    queue_open = len(engine.queue)
    t_open = time.perf_counter()
    deadline = (t_open if closed else sched_open) + ctx.seconds
    with span("gpubench.window"):
        while time.perf_counter() < deadline:
            advance()
        if ctx.trace:
            ctx.sync()
    t_close = time.perf_counter()
    stats1 = engine.stats()
    queue_close = len(engine.queue)
    feed(t_close)  # an arrival due at the close counts
    trace = None
    if ctx.trace:
        prof.__exit__(None, None, None)
        rec.remove()
        trace = prof
    tokens = sum(n for t, n in emitted_at if t_open < t <= t_close)

    if closed:
        counted = [t for t in tracked if t.first is not None and t_open < t.first <= t_close]
    else:
        counted = [t for t in tracked if sched_open + 1e-6 < t.due <= deadline + 1e-6]  # whole blocks
    drain_end = time.perf_counter() + DRAIN_LIMIT_S
    while any(not t.finished for t in counted) and time.perf_counter() < drain_end:
        advance()
    lateness = [t.submitted - t.due for t in counted] if not closed else []
    return {
        "t_open": t_open, "t_close": t_close, "window_s": t_close - t_open, "tokens": tokens,
        "requests": counted, "stats0": stats0, "stats1": stats1, "n_slots": n_slots,
        "calls": rec.calls if rec else [], "profiler": trace,
        "lateness_s": lateness, "submitted": len(tracked), "queue": (queue_open, queue_close),
    }
