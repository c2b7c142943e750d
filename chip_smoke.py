#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``qwen3_rs_tpu_torch``).

    python3 chip_smoke.py                  # every phase, one NVIDIA GPU
    python3 chip_smoke.py --phases build,kernels

Phases, in order; any failure exits non-zero before the final line:

1. ``build``   the card's name and power limit, the CUDA version, the kernel
               build (one ``nvcc`` per source, all in parallel) and the
               device-to-device copy bandwidth on a 1 GiB buffer.
2. ``kernels`` each hand-written kernel against its plain PyTorch version on
               the same inputs at Qwen3-8B shapes (INT8-g64; the paged kernels
               over a page-128 pool with shuffled tables; the decode
               megakernel at full depth, each case with its phase breakdown
               from the kernel's own clock stamps; the Q4 variants of #3, #6, #7 and
               #11 on INT4-g64 codes; #6's column window at the 8B tp=2
               shard shapes, also bit for bit against a full launch's
               columns; #10's plan read back against ``window_units``,
               P1's one-call walk against ``probes.onecall_walk``;
               #4, #5, #9 and #10 at head_dim 256, 384, 512 and 640, and
               #5 and #10 at head_dim 512 with the 8B's 32/8 heads (#5 over
               a fresh 2048-row window, #10 over bf16, INT8 and f32 pools
               at B=8, S=16); #3 by route at 1-256 rows over the four 8B
               projections, the CUDA-core, mma and tensor-core routes side
               by side at 1, 2, 3, 4, 8 and 16 rows and the row kernel at 1,
               the measurement behind ``qmatmul.MMA_MIN_ROWS`` and
               ``TC_MIN_ROWS``; #1 and #2 on the row and mma routes at 1 row
               and the mma route at 8; #4 at B=1 with its two-pass kernel
               beside the one-launch one and the latter's phase stamps), with
               its time,
               the plain version's time, one PyTorch library call's time
               where one computes the same function, and the least time the
               card could take.
3. ``probes``  the four measurement probes (``qwen3_rs_tpu_torch.scripts``)
               through their ``run()`` entry points, the probe kernels'
               path: the launch boundary at 8B ``wo`` and ``w13`` (eager #2
               launches, a CUDA graph of them, one ``boundary_onecall``
               launch; the price of a boundary a layer), the read stream over
               4 GB at blocks of 0.5-4 MB, the classifier's compute path at
               B=8 and 1, the depth-64 int8 question at 2048x4096x24576
               (i8-seg64 against bf16-full); then each probe kernel against
               its plain version with its time, bound and yardsticks.  The
               phase uses only the probes' ``run()`` entry points, wrappers
               and constants and #2, so it runs unchanged when copied into
               the ``git archive`` of an older tree that has the probes.
4. ``e2e``     Qwen3-8B at full width and depth with random weights made on
               the card from a seed, each path driven with the launch counts
               reset just before it and read just after:
               * ``generate()``/``chat()`` on a 200-token prompt, f32 and INT8
                 caches: every decode step is one decode-megakernel launch
                 (all layers and the classifier), two greedy runs agree;
               * the same greedy decode with the megakernel gate patched off
                 (4·L+1 W8A16 matmuls and L flash-decode attentions a step),
                 timed and profiled in the same call;
               * one 8-step decode chunk inside ``utils.profiling.
                 profile_trace``, whose trace file must appear;
               * device sampling (``decode_chunk``): greedy equal to the host
                 stream, ``-t 0.8`` repeatable, a chunk with no host
                 synchronisation before its final copy;
               * a dense decode of 9 rows, which the gate refuses;
               * ``generate()`` on a 3000-token prompt: a fresh 2048-row window
                 (L causal prefill attentions, 4·L row-blocked W8A16 matmuls),
                 a continuation window (4·L row-blocked), then decode steps;
               * a continued 32-row window (4·L #3 launches on its
                 tensor-core route), timed and profiled;
               * ``compute_perplexity`` (eval-ppl) at 4096-row windows, fast
                 (3·L row-blocked, L dequant per window) twice, identical;
               * exact-mode ``generate()`` on a 300-token prompt (4·L W8A8 on
                 the window) and exact eval-ppl (4·L+1 W8A8 per window);
               * INT4 (the INT8 weights freed first): the same b=1 greedy
                 decode, each step 4·L Q4 #3, one INT8 classifier and L
                 flash-decode launches (the JAX default: no megakernel for
                 Q4), profiled; then, in the same call, with the opt-in
                 ``QWEN3_TPU_MEGA_Q4=1``, one Q4 #11 launch a step, profiled,
                 and a sync-free device-sampling chunk on it; the 3000-token
                 prompt (Q4 #6, #5); eval-ppl at one 4096-row window, fast
                 (Q4 #6, Q4 #7) and f32; exact mode raising; the card against
                 the CPU on a one-layer slice, per layer and through Q4 #11.
5. ``serve``   the continuous-batching engine on the same 8B weights cut to
               their first SERVE_LAYERS (18) layers, ctx
               4096, 8 slots, page 128, greedy: 24 requests (prompts of
               16-1024 tokens, 64 new tokens) with host sampling on the paged
               bf16 pool, the INT8 pool and the
               dense slots, then with device
               sampling (the CLI default, 8-step chunks) on the paged bf16
               pool and the dense slots, its streams held to the host
               runs' (a parting only at a near-tie), and on the dense slots
               with the INT4 weights and ``QWEN3_TPU_MEGA_Q4=1`` beside the
               INT8 run, and before it, without the opt-in, 8 requests on the
               INT4 dense slots per layer (Q4 #3 at 8 rows: its mma route);
               every decode step checked for its launches (the pool: 4·L+1
               #1-#3 on the mma route and L paged-decode; the dense slots:
               one decode-megakernel launch, Q4 #11 for INT4); the
               prefix cache (15 hits, each continued window L paged-window
               launches); chunked prefill; the HTTP front end on port 0
               (answers equal to the requests run alone, then a burst of 8).
6. ``spec``    n-gram speculative decoding on the same 8B weights (their
               first SPEC_LAYERS, 18, layers) and on the
               parrot fixture (every layer's scales zeroed, the tied
               classifier repeating its input: drafts accepted): b=1 greedy
               ``generate(spec_k=4)`` for 128 tokens, every round one window
               of 5 rows (4·L + 1 launches of #3's mma route, the classifier
               among them) and one count read, its stream held to plain
               greedy's (#11), ms a round and a token beside the plain chunk's,
               one round under torch.profiler; the paged bf16 8-slot serve
               with ``spec_k=3`` on the serve phase's first 8 requests beside
               ``spec_k=0``, every speculative chunk's rounds checked for
               4·L + 1 tensor-core #3 and L #10 launches, the streams held to
               each other, every page released.
7. ``cli``     a 2-layer 8B-width ``.qtpu`` checkpoint written with numpy,
               run through ``qwen3_rs_tpu_torch.cli.main`` (``inference`` in
               generate, chat, exact mode and with ``--device-sampling``,
               ``eval-ppl`` in three modes,
               ``batch --sampling host`` paged and dense) and ``serve`` with
               its defaults in a process of its own; ``export`` of a
               synthetic dim-512 HF directory to an INT4 ``.qtpu`` and an
               INT8 ``.bin``, ``inference`` on each, ``batch`` with its
               defaults on each (INT4 with ``QWEN3_TPU_MEGA_Q4=1``: Q4 #11
               where the gate admits dim 512) and ``--sampling host`` on the
               INT4 one; the output must equal the API's; the CLI runs' host
               helper calls (the tokenizer's encodes, the loader's
               transposes) counted, none of them zero.
8. ``native``  the port's C++ host helper (``utils.native``, built with the
               host compiler from ``qwen3_rs_tpu_torch/csrc/*.cpp``): loaded
               from the port's build directory, no other helper mapped; its
               BPE encoder equal to the Python encoder on the smoke's
               tokenizer, its transpose equal to numpy's on the 8B's ``w13``
               codes and scales, both timed on the host beside their plain
               versions.
9. ``tp``      tensor-parallel serving: 8B at full width and TP_LAYERS (6) of
               its 36 layers drawn by each of 2 ranks on the one card (gloo), each
               keeping its shard, the serve phase's 24 requests on the paged
               bf16 pool with device sampling; its greedy streams held to a
               tp=1 run of the same weights (a parting only at a near-tie), every rank's streams, launches
               and collectives equal, every decode chunk checked for its
               launches and every window of 512 reference rows or more for
               8·L #6 column windows (wo and w2 in 4 chunks); the
               collectives' share of a decode step; then ``cli.py serve --tp
               2 --device cuda:0,cuda:0`` on the cli phase's dim-512 model
               (two completions equal to the API's, SIGTERM leaves no rank)
               and ``--tp 2`` with one device refused.
10. ``replicas`` two engines (8B, 18 layers each, paged bf16, device
               sampling) on the one card behind ``ReplicatedFrontend`` and the
               HTTP front end: the serve phase's 24 request lengths as text,
               streamed, held to one engine's streams behind the same front
               end (a parting only within MK_TOL_DEEP of the largest logit,
               as tp's), both replicas taking requests; prefix affinity (6
               requests sharing a head: one replica, 5 cache hits); then
               ``cli.py serve --replicas 2`` at ``--tp 1`` (two engines in
               the server) and ``--tp 2`` (four ranks of the card, a ``serve
               --tp 2`` process a replica) on the cli phase's exported 2-layer dim-512 model,
               completions equal to the API's, SIGTERM leaving no process.
11. ``gateway`` two ``cli.py serve`` workers and ``cli.py serve --gateway``
               before them: whole and streamed completions equal to the
               API's; the gateway absent from ``nvidia-smi``'s compute
               processes, no ``/dev/nvidia*`` file open in it.
12. ``pp``     ``pipelined_forward``: 8B at full depth on 2 ranks of the card
               (gloo), 18 layers a rank, B=4 in 2 microbatches, a 128-row
               prefill and 8 greedy steps, held to the one-rank pipeline at
               2e-2·max|logits| and the dense forward (other routes) at
               MK_TOL_DEEP or twice one rounding's move, layer 0's cache
               rows at 1e-2; each rank's #1-#3
               launches the schedule's count, bubbles included; ms a step.
13. ``sp``     ``start_sp_engine``: 8B, 18 layers, 2 ranks of the card, a
               fresh 4096-token prompt on the ring (no #5; each rank 4·L #6
               launches on 2048 rows), held to the one-rank 4096-row window
               (#5 + #6) at 2e-2·max|logits|, then 32 greedy steps (#11) on
               rank 0 against the one-rank stream; ``cli.py inference --sp 2``
               against the API.
14. ``scaling`` ``parallel.scaling_report``: 8B at full width and
               SCALING_LAYERS (4) layers, ctx 1024, one row a replica, 16 and
               4 greedy steps, at device counts [1, 2] with tp 1 (dp 2: #11
               on each replica) and [2, 4] with tp 2 (dp 1 and 2: #1-#3 on
               the row route and #4), the ranks sharing the card over gloo;
               every replica's tokens equal one rank's at tp 1, every rank's
               equal at tp 2 and held to tp 1's (a parting only at a
               near-tie within MK_TOL_DEEP), rank 0's launches the steps'
               count; throughput and efficiency, the path's cost on one card.
15. ``parity``  the 2-layer model on the CPU (plain versions) and on the card
               (kernels): prefill windows and decode steps (the megakernel) in
               fast mode (16-,
               512- and 300-row windows) and exact mode; eval-ppl at 0.6B width;
               the paged forward (a fresh group, a continued window, decode
               steps with a slot masked) over bf16 and INT8 pools; a shape the
               JAX gates refuse (a head_dim-64 Llama) on the plain path with
               no launch of the refused kernels, and shapes they admit that
               the port's kernels once refused (INT4 with 512-row groups, 5
               query heads per kv head) through the kernels; head_dim-256,
               -512 and -640 models through #4, #5, #9 and #10.

Optional phases, run only when named: ``exact`` (exact mode's two paths
alone), ``decode`` (#1-#3 at one row and #4 at B=1 by route, with each
kernel's device time from torch.profiler, and the b=1 per-layer INT8 and
INT4 steps' device time), ``window`` (#10's 8B cases and its head_dim-256
and -640 cases, #4 over an INT8 cache, the one-launch decode kernel's error
over #4's card-test grids, and the prefix-cache path's TTFT and its
continued windows' device time split into #10, the merge glue and the
rest) and ``heads`` (the kernels phase's head_dim rows alone: #4, #5, #9,
#10 at 256-640 and the 32/8-head rows at 512), each for comparing two trees
in one call.

Output: one JSON object per line.  The second-to-last lines hold the kernel
table and the serve, spec, tp, replicas, gateway, pp, sp, scaling, native and
probes phases' numbers (``{"kernels": [...], "serve": {...}, ..., "native":
{...}, "probes": {...}}``)
and the card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PHASES = ("build", "kernels", "probes", "e2e", "serve", "spec", "cli", "native", "tp", "replicas", "gateway", "pp", "sp",
          "scaling", "parity")
OPTIONAL_PHASES = ("exact", "decode", "window", "heads")  # run only when named: subsets for comparing two trees in one call

# Published peaks of one H100 SXM (dense): the denominators of bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
F32_INSTR_PER_S = PEAK_OPS_PER_S["f32"] / 2  # f32 instructions a second (an FMA is one)
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time: keeps the host ahead of the card
SEED = 0
DECODE_TOKENS = 64  # per greedy generate run
LONG_PROMPT_TOKENS = 3000  # one token per character: a fresh 2048-row window and a continuation
LONG_DECODE_TOKENS = 16
EXACT_PROMPT_TOKENS = 300
EXACT_DECODE_TOKENS = 8
SERVE_REQUESTS = 24
SERVE_NEW_TOKENS = 64
SERVE_LAYERS = 18  # the serve phase's depth: half of 8B's, which pays for the replicas, gateway, pp and sp phases
SPEC_LAYERS = 18  # the spec phase's, likewise


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------- timing
def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn(i)`` in ms: CUDA events around each call,
    after a device sleep so that the events bracket the work and not the
    host's enqueue."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(warmup + i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, op_type: str) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes at the memory rate or
    operations at the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def w8a16_key(rows: int, q4: bool = False) -> str:
    """The ``LAUNCHES`` key of the fused W8A16 wrapper's route at ``rows``
    rows (``qmatmul.route``): the row kernel, the mma kernel or the tensor
    cores."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import route

    key = ROUTE_KEYS[route(rows)]
    return key + "_q4" if q4 else key


# ---------------------------------------------------------------------- build
def phase_build(torch, ctx) -> None:
    from qwen3_rs_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    print(smi, flush=True)
    emit({"phase": "build", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})
    t0 = time.perf_counter()
    build.build()
    seconds = time.perf_counter() - t0
    for name in build.SOURCES:
        log = build.build_log(name)
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel_source": name, "ptxas": usage})
    emit({"phase": "build", "build_seconds": seconds})

    n = 1 << 30  # 1 GiB
    src = torch.empty(n, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    ms = device_ms(torch, lambda i: dst.copy_(src), reps=10)
    ctx["copy_gbps"] = 2 * n / (ms * 1e-3) / 1e9  # read + write
    emit({"phase": "build", "copy_bytes": n, "copy_ms": ms, "copy_gb_per_s": ctx["copy_gbps"]})
    del src, dst


# -------------------------------------------------------------------- kernels
def _layers_for(nbytes_per_layer: int, floor: int = 2) -> int:
    """Layers to cycle through so the working set is ~3x the 50 MB L2: every
    launch finds its weights cold, as in a decode step."""
    return max(floor, math.ceil(160e6 / nbytes_per_layer))


def qmatmul_cases(torch, ctx) -> list[dict]:
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16, qmatmul_w8a16_plain
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import padded_vocab, qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    vpad = padded_vocab(c.vocab_size)
    f32, bf16 = torch.float32, torch.bfloat16
    # (case, N, D, prologue, residual, rows, stacked, x dtype), dtypes as in qwen3_forward.
    specs = [
        ("wqkv+rms b=1", dim, ah + 2 * kvd, "rms", False, 1, True, bf16),
        ("wo+residual b=1", ah, dim, None, True, 1, True, f32),
        ("w13+rms b=1", dim, 2 * hid, "rms", False, 1, True, bf16),
        ("w2+swiglu+residual b=1", hid, dim, "swiglu", True, 1, True, f32),
        ("wo stacked b=1", ah, dim, None, False, 1, True, f32),
        ("lm_head b=1", dim, vpad, None, False, 1, False, bf16),
    ]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    out = []
    for case, n, d, prologue, has_res, rows, stacked, xdt in specs:
        layer_bytes = n * d + (n // g) * d * 2
        nl = _layers_for(layer_bytes) if stacked else 1
        shape = (nl, n, d) if stacked else (n, d)
        codes = torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)
        scales = (torch.rand((*shape[:-2], n // g, d), generator=gen, device=DEV) * 0.02).to(bf16)
        w = QuantizedTensor(codes, scales)
        width = 2 * n if prologue == "swiglu" else n
        x = torch.randn(rows, width, generator=gen, device=DEV).to(xdt)
        kw = {}
        if prologue == "rms":
            kw["norm_w"] = 1.0 + 0.02 * torch.randn(nl, n, generator=gen, device=DEV)
        if prologue == "swiglu":
            kw["swiglu"] = True
        if has_res:
            kw["residual"] = torch.randn(rows, d, generator=gen, device=DEV).to(bf16)

        def layer(i):
            return (i % nl) if stacked else None

        ref = qmatmul_w8a16_plain(x, w, layer(1), **kw)
        got = qmatmul_w8a16(x, w, layer(1), **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        # Same bf16 products on both sides; the f32 sums differ in order.  A
        # prologue's f32 result (rsqrt, exp) may differ by an ulp, which can
        # flip the bf16 rounding of an activation: a looser bound there.
        rel = 2e-3 if prologue else 1e-4
        tol = rel * scale
        need(math.isfinite(err) and err <= tol, f"qmatmul {case}: max_abs_err {err} > tol {tol}")

        ms = device_ms(torch, lambda i: qmatmul_w8a16(x, w, layer(i), **kw))
        plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_plain(x, w, layer(i), **kw), reps=5, warmup=1)
        # Library yardstick: one bf16 matmul on weights dequantized beforehand
        # (no prologue, no residual; streams 2 bytes per weight).
        xl = x[:, :n].to(bf16)
        dense = [dequant_weights(QuantizedTensor(codes[l], scales[l]) if stacked else w)
                 for l in range(min(nl, max(2, math.ceil(160e6 / (2 * n * d)))))]
        lib_ms = device_ms(torch, lambda i: torch.matmul(xl, dense[i % len(dense)]))
        del dense
        nbytes = (n * d + (n // g) * d * 2 + x.numel() * x.element_size() + rows * d * 4
                  + (rows * d * 2 if has_res else 0) + (n * 4 if prologue == "rms" else 0))
        b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
        out.append({
            "name": w8a16_key(rows), "case": case, "route": "cuda",
            "source": "qwen3_rs_tpu_torch/csrc/qmatmul_w8a16.cu",
            "replaces": ("qwen3_rs_tpu/ops/pallas/qmatmul.py:469 qmatmul_pallas" if not stacked
                         else "qwen3_rs_tpu/ops/pallas/qmatmul.py:563 qmatmul_pallas_stacked"
                         if prologue is None and not has_res
                         else "qwen3_rs_tpu/ops/pallas/qmatmul.py:761 qmatmul_pallas_stacked_fused"),
            "shape": {"rows": rows, "N": n, "D": d, "g": g},
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_ms_copy_bw": nbytes / (ctx["copy_gbps"] * 1e9) * 1e3,
            "library_ms": lib_ms, "library": "torch.matmul bf16, weights dequantized beforehand",
        })
        emit({"phase": "kernels", **out[-1]})
        del codes, scales, w, x, kw, ref, got
        torch.cuda.empty_cache()
    return out


CROSSOVER_ROWS = (1, 2, 3, 4, 8, 16)  # the routes side by side (the row kernel at 1 row)
ROUTE_ROWS = {8: ((1, "row"),) + tuple((r, rt) for r in CROSSOVER_ROWS for rt in ("mma", "tc"))
                 + ((32, "tc"), (64, "tc"), (128, "tc"), (256, "tc")),
              4: ((8, "mma"), (16, "tc"), (256, "tc"))}
ROUTE_KEYS = {"row": "qmatmul_w8a16", "mma": "qmatmul_w8a16_mma", "tc": "qmatmul_w8a16_tc"}
ROUTE_NAMES = {"row": "row kernel, mma.sync", "mma": "mma.sync", "tc": "tensor cores, wgmma"}


def qmatmul_route_cases(torch, ctx) -> list[dict]:
    """#3 by route at windows of 1-256 rows over the four 8B projections, as
    qwen3_forward calls them (prologue, residual, x dtype): the mma and
    tensor-core kernels side by side at 1, 2, 3, 4, 8 and 16 rows and the row
    kernel at 1 (the measurement that sets ``qmatmul.MMA_MIN_ROWS`` and
    ``TC_MIN_ROWS``), the
    tensor-core kernel at 32-256 rows; INT4 at 8, 16 and 256 rows.  Each
    route is forced by calling its launcher; ``route`` says which the
    wrapper takes."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
        dequant_q4_stacked_plain, qmatmul_w8a16_mma, qmatmul_w8a16_plain, qmatmul_w8a16_row, qmatmul_w8a16_tc,
        route,
    )
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [("wqkv+rms", dim, ah + 2 * kvd, "rms", False, bf16), ("wo+residual", ah, dim, None, True, f32),
             ("w13+rms", dim, 2 * hid, "rms", False, bf16), ("w2+swiglu+residual", hid, dim, "swiglu", True, f32)]
    launchers = {"row": qmatmul_w8a16_row, "mma": qmatmul_w8a16_mma, "tc": qmatmul_w8a16_tc}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9090)
    out, crossover = [], {}
    for bits in (8, 4):
        for proj, n, d, prologue, has_res, xdt in specs:
            wbytes = (n * d // 2 + (n // g) * d * 2) if bits == 4 else n * d + (n // g) * d * 2
            nl = _layers_for(wbytes)
            if bits == 4:
                w = _q4_stacked(torch, gen, nl, n, d, g, bf16)
                dense = [dequant_q4_stacked_plain(w, l) for l in range(2)]
            else:
                w = QuantizedTensor(torch.randint(-127, 128, (nl, n, d), generator=gen, device=DEV, dtype=torch.int8),
                                    (torch.rand(nl, n // g, d, generator=gen, device=DEV) * 0.02).to(bf16))
                dense = [dequant_weights(QuantizedTensor(w.q[l], w.scales[l])) for l in range(2)]
            norm_w = 1.0 + 0.02 * torch.randn(nl, n, generator=gen, device=DEV) if prologue == "rms" else None
            for rows, rt in ROUTE_ROWS[bits]:
                width = 2 * n if prologue == "swiglu" else n
                x = torch.randn(rows, width, generator=gen, device=DEV).to(xdt)
                kw = {"norm_w": norm_w, "swiglu": prologue == "swiglu",
                      "residual": torch.randn(rows, d, generator=gen, device=DEV).to(bf16) if has_res else None}
                launch = launchers[rt]
                ref = qmatmul_w8a16_plain(x, w, 1, **kw)
                got = launch(x, w, 1, **kw)
                torch.cuda.synchronize()
                err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                # f32 sums in another order (the tensor cores' round toward zero); a
                # prologue's f32 result may flip an activation's bf16 rounding.
                tol = (2e-3 if prologue else 1e-4) * scale
                need(math.isfinite(err) and err <= tol, f"#3 {rt} {proj} rows={rows} bits={bits}: {err} > {tol}")
                ms = device_ms(torch, lambda i: launch(x, w, i % nl, **kw))
                plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_plain(x, w, i % nl, **kw), reps=3, warmup=1)
                xl = x[:, :n].to(bf16)
                lib_ms = device_ms(torch, lambda i: torch.matmul(xl, dense[i % 2]))
                nbytes = (wbytes + x.numel() * x.element_size() + rows * d * 4 + (rows * d * 2 if has_res else 0)
                          + (n * 4 if prologue == "rms" else 0))
                b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
                name = ROUTE_KEYS[rt] + ("_q4" if bits == 4 else "")
                out.append(_row(
                    ctx, name, f"{proj} rows={rows} ({ROUTE_NAMES[rt]}{', the route' if route(rows) == rt else ''})",
                    "qwen3_rs_tpu_torch/csrc/qmatmul_w8a16.cu" + (" + w8a16_wgmma.cuh" if rt == "tc" else ""),
                    "qwen3_rs_tpu/ops/pallas/qmatmul.py:761 qmatmul_pallas_stacked_fused"
                    + (" (Q4 tiles, :34 _dequant_tile_q4)" if bits == 4 else ""),
                    {"rows": rows, "N": n, "D": d, "g": g, "bits": bits, "route": rt}, err, tol, ms, plain_ms, nbytes,
                    b_ms, b_by, lib_ms, "torch.matmul bf16, weights dequantized beforehand",
                ))
                if bits == 8 and rows in CROSSOVER_ROWS:
                    crossover.setdefault(rows, {}).setdefault(rt, 0.0)
                    crossover[rows][rt] += ms
                del x, kw, ref, got
            del w, dense, norm_w
            torch.cuda.empty_cache()
    # The routes over the four projections: the fastest at each row count.
    fastest = {r: min(t, key=t.get) for r, t in crossover.items()}
    ctx["crossover"] = {"ms_four_projections": crossover, "fastest": fastest}
    emit({"phase": "kernels", "crossover_ms_four_projections": crossover, "fastest_route_by_rows": fastest,
          "tc_beats_mma_from_rows": min((r for r, t in crossover.items() if t["tc"] < t["mma"]), default=None)})
    return out


def qmatmul_single_route_cases(torch, ctx) -> list[dict]:
    """#1 (the 8B classifier, 2-D weights) and #2 (``wo`` alone, no prologue
    or residual) on the row kernel at 1 row and the mma kernel at 1 and 8
    rows: with the four projections' crossover, whether 1 row keeps the row
    kernel."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16_mma, qmatmul_w8a16_plain, qmatmul_w8a16_row, route
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import padded_vocab, qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    launchers = {"row": qmatmul_w8a16_row, "mma": qmatmul_w8a16_mma}
    out, one_row = [], {}
    for case, n, d, stacked in (("lm_head", c.dim, padded_vocab(c.vocab_size), False),
                                ("wo stacked", c.all_heads_dim, c.dim, True)):
        wbytes = n * d + (n // g) * d * 2
        nl = _layers_for(wbytes) if stacked else 1
        shape = (nl, n, d) if stacked else (n, d)
        w = QuantizedTensor(torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8),
                            (torch.rand((*shape[:-2], n // g, d), generator=gen, device=DEV) * 0.02).to(torch.bfloat16))
        dense = [dequant_weights(QuantizedTensor(w.q[l], w.scales[l]) if stacked else w) for l in range(2 if stacked else 1)]
        layer = (lambda i: i % nl) if stacked else (lambda i: None)
        xdt = torch.float32 if stacked else torch.bfloat16
        for rows in (1, 8):
            x = torch.randn(rows, n, generator=gen, device=DEV).to(xdt)
            ref = qmatmul_w8a16_plain(x, w, layer(1))
            xl = x.to(torch.bfloat16)
            lib_ms = device_ms(torch, lambda i: torch.matmul(xl, dense[i % len(dense)]))
            plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_plain(x, w, layer(i)), reps=3, warmup=1)
            nbytes = wbytes + x.numel() * x.element_size() + rows * d * 4
            b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
            for rt, launch in launchers.items():
                if rt == "row" and rows != 1:
                    continue  # the row kernel takes one row
                got = launch(x, w, layer(1))
                torch.cuda.synchronize()
                err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
                need(math.isfinite(err) and err <= tol, f"#1/#2 {rt} {case} rows={rows}: {err} > {tol}")
                ms = device_ms(torch, lambda i: launch(x, w, layer(i)))
                one_row.setdefault(f"{case} rows={rows}", {})[rt] = ms
                out.append(_row(
                    ctx, ROUTE_KEYS[rt], f"{case} rows={rows} ({ROUTE_NAMES[rt]}{', the route' if route(rows) == rt else ''})",
                    "qwen3_rs_tpu_torch/csrc/qmatmul_w8a16.cu",
                    "qwen3_rs_tpu/ops/pallas/qmatmul.py:469 qmatmul_pallas" if not stacked
                    else "qwen3_rs_tpu/ops/pallas/qmatmul.py:563 qmatmul_pallas_stacked",
                    {"rows": rows, "N": n, "D": d, "g": g, "route": rt}, err, tol, ms, plain_ms, nbytes, b_ms, b_by,
                    lib_ms, "torch.matmul bf16, weights dequantized beforehand",
                ))
                del got
            del x, ref
        del w, dense
        torch.cuda.empty_cache()
    four = ctx["crossover"]["ms_four_projections"][1]
    emit({"phase": "kernels", "one_row_routes_ms": {**one_row, "four projections rows=1": four},
          "row_kernel_fastest_at_1_row_everywhere": four["row"] == min(four.values())
          and all(t["row"] == min(t.values()) for k, t in one_row.items() if k.endswith("rows=1"))})
    return out


def flash_source(hd: int, t_max: int) -> str:
    """The source of the kernel ``flash_decode`` launches at this head_dim
    and cache length."""
    from qwen3_rs_tpu_torch.ops.kernels.flash_attention import one_launch_takes

    return f"qwen3_rs_tpu_torch/csrc/{'paged_decode' if one_launch_takes(hd, t_max) else 'flash_decode'}.cu"


FLASH_SPECS = (("f32", 0), ("f32", 1), ("f32", 257), ("f32", 4095), ("bf16", 2049), ("int8", 2049))


def flash_cases(torch, ctx, specs=FLASH_SPECS, phases: bool = True) -> list[dict]:
    """#4 at the 8B layer (B=1, T=4096) over f32, bf16 and INT8 caches at
    the positions of ``specs``, the wrapper's kernel (the one-launch kernel
    here) beside the two-pass kernel it replaced on these shapes, and (with
    ``phases``) the one-launch kernel's phase stamps."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_decode, flash_decode_phases, flash_decode_plain, flash_decode_two_pass,
    )
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    t_max, n_kv, h, hd = 4096, c.n_kv_heads, c.n_heads, c.head_dim
    kv_mul = h // n_kv
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    out = []
    for cache, p in specs:
        esz = {"f32": 4, "bf16": 2, "int8": 1}[cache]
        per_layer = 2 * n_kv * t_max * hd * esz
        nl = _layers_for(per_layer)
        shape = (nl, 1, n_kv, t_max, hd)
        sc = {}
        if cache == "int8":
            k_all = torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)
            v_all = torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)
            sc = {n_: torch.rand(shape[:-1], generator=gen, device=DEV) * 0.02 + 0.005
                  for n_ in ("k_scale_all", "v_scale_all")}
        else:
            dt = torch.float32 if cache == "f32" else torch.bfloat16
            k_all = torch.randn(shape, generator=gen, device=DEV).to(dt)
            v_all = torch.randn(shape, generator=gen, device=DEV).to(dt)
        q = torch.randn(1, h, hd, generator=gen, device=DEV)
        kn = torch.randn(1, n_kv, hd, generator=gen, device=DEV)
        vn = torch.randn(1, n_kv, hd, generator=gen, device=DEV)
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)

        ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
        got = flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-5  # f32 softmax and sums on both sides; only the order differs
        need(math.isfinite(err) and err <= tol, f"flash_decode {cache} pos={p}: max_abs_err {err} > tol {tol}")
        if p == 0:  # only the self key: the output is v_self, exactly
            need(torch.equal(got, vn.repeat_interleave(kv_mul, dim=1)), "flash_decode pos=0 != v_self")

        two = flash_decode_two_pass(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        parent_err = float((two - ref).abs().max())
        need(math.isfinite(parent_err) and parent_err <= tol, f"flash_decode two-pass {cache} pos={p}: {parent_err}")
        ms = device_ms(torch, lambda i: flash_decode(q, kn, vn, k_all, v_all, pos, i % nl, **sc))
        parent_ms = device_ms(torch, lambda i: flash_decode_two_pass(q, kn, vn, k_all, v_all, pos, i % nl, **sc))
        plain_ms = device_ms(
            torch, lambda i: flash_decode_plain(q, kn, vn, k_all, v_all, pos, i % nl, **sc),
            reps=10, warmup=1,
        )
        if p and phases:
            emit({"phase": "kernels", "flash_decode_phases_us": flash_decode_phases(q, kn, vn, k_all, v_all, pos, 1, **sc),
                  "case": f"{cache} cache B=1 pos={p} T={t_max}"})

        # Library yardstick: SDPA over [self; rows < pos], K/V dequantized and
        # expanded to the query heads beforehand.
        def lib_inputs(l):
            kc, vc = k_all[l, :, :, :p].float(), v_all[l, :, :, :p].float()
            if sc:
                kc = kc * sc["k_scale_all"][l, :, :, :p, None]
                vc = vc * sc["v_scale_all"][l, :, :, :p, None]
            kk = torch.cat([kn[:, :, None], kc], dim=2).repeat_interleave(kv_mul, dim=1)
            vv = torch.cat([vn[:, :, None], vc], dim=2).repeat_interleave(kv_mul, dim=1)
            return kk, vv

        lib = [lib_inputs(l) for l in range(min(nl, 2))]
        q4 = q[:, :, None]
        lib_ms = device_ms(
            torch, lambda i: F.scaled_dot_product_attention(q4, *lib[i % len(lib)])
        )
        del lib
        nbytes = (2 * n_kv * p * hd * esz + (2 * n_kv * p * 4 if sc else 0)
                  + (q.numel() + kn.numel() + vn.numel() + q.numel()) * 4 + 4)
        b_ms, b_by = bound(nbytes, 4.0 * h * (p + 1) * hd, "f32")
        out.append({
            "name": "flash_decode", "case": f"{cache} cache pos={p} T={t_max}", "route": "cuda",
            "source": flash_source(hd, t_max),
            "replaces": "qwen3_rs_tpu/ops/pallas/flash_attention.py:212 flash_gqa_decode_stacked",
            "shape": {"B": 1, "heads": h, "kv_heads": n_kv, "hd": hd, "T": t_max, "pos": p},
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_ms_copy_bw": nbytes / (ctx["copy_gbps"] * 1e9) * 1e3,
            "library_ms": lib_ms, "library": "F.scaled_dot_product_attention, K/V prepared beforehand",
            "parent_ms": parent_ms, "parent_max_abs_err": parent_err,
            "parent": "the two-pass kernel (flash_decode_two_pass, csrc/flash_decode.cu), same inputs",
        })
        emit({"phase": "kernels", **out[-1]})
        del k_all, v_all, sc, ref, got
        torch.cuda.empty_cache()
    return out


def _row(ctx, name, case, source, replaces, shape, err, tol, ms, plain_ms, nbytes, b_ms, b_by,
         lib_ms, library) -> dict:
    row = {
        "name": name, "case": case, "route": "cuda", "source": source, "replaces": replaces,
        "shape": shape, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
        "bound_ms_copy_bw": nbytes / (ctx["copy_gbps"] * 1e9) * 1e3,
        "library_ms": lib_ms, "library": library,
    }
    emit({"phase": "kernels", **row})
    return row


def _stacked_weights(torch, gen, layers, n, d, g, scale_dtype):
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor

    codes = torch.randint(-127, 128, (layers, n, d), generator=gen, device=DEV, dtype=torch.int8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=DEV) * 0.02 + 1e-3).to(scale_dtype)
    return QuantizedTensor(codes, scales)


def rows_cases(torch, ctx) -> list[dict]:
    """Row-blocked W8A16 (#6) at the long windows' shapes: a fresh 2048-row
    window, a ragged continuation, and eval-ppl's 4096-row window."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16_rows, qmatmul_w8a16_rows_plain
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    g, bf16 = c.group_size, torch.bfloat16
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    specs = [("wqkv", dim, ah + 2 * kvd, 2048), ("wo", ah, dim, 2048), ("w13", dim, 2 * hid, 2048),
             ("w2", hid, dim, 2048), ("wqkv", dim, ah + 2 * kvd, 952), ("w13", dim, 2 * hid, 4096),
             ("w2", hid, dim, 4096)]  # at 4096 rows w2 takes #7 + torch.matmul: the two side by side
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5678)
    out = []
    for proj, n, d, rows in specs:
        w = _stacked_weights(torch, gen, 2, n, d, g, bf16)
        x = torch.randn(rows, n, generator=gen, device=DEV).to(bf16)
        ref = qmatmul_w8a16_rows_plain(x, w, 1)
        got = qmatmul_w8a16_rows(x, w, 1)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
        need(math.isfinite(err) and err <= tol, f"qmatmul_w8a16_rows {proj} rows={rows}: {err} > {tol}")
        ms = device_ms(torch, lambda i: qmatmul_w8a16_rows(x, w, i % 2))
        plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_rows_plain(x, w, i % 2), reps=5, warmup=1)
        dense = [dequant_weights(QuantizedTensor(w.q[l], w.scales[l])) for l in range(2)]
        lib_ms = device_ms(torch, lambda i: torch.matmul(x, dense[i % 2]))
        del dense
        nbytes = n * d + (n // g) * d * 2 + rows * n * 2 + rows * d * 4
        b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
        out.append(_row(
            ctx, "qmatmul_w8a16_rows", f"{proj} rows={rows}", "qwen3_rs_tpu_torch/csrc/qmatmul_rows.cu",
            "qwen3_rs_tpu/ops/pallas/qmatmul.py:956 qmatmul_pallas_stacked_rows",
            {"rows": rows, "N": n, "D": d, "g": g}, err, tol, ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
            "torch.matmul bf16, weights dequantized beforehand",
        ))
        del w, x, ref, got
        torch.cuda.empty_cache()
    return out


def rows_cols_cases(torch, ctx) -> list[dict]:
    """#6's column window (``out_cols``, the tensor-parallel chunks of wo and
    w2) at the 8B tp=2 shard shapes: 2048 rows, N = 2048 (wo) and 6144 (w2),
    D = 4096, windows of 1024 columns at 0 and 3072.  Each is held against
    the plain version, and bit for bit against the same columns of a full #6
    launch (an element's k order does not depend on the window)."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16_rows, qmatmul_w8a16_rows_plain
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import qwen3_config, rows_cols_counts

    c = qwen3_config("8b")
    g, bf16, rows, dc = c.group_size, torch.bfloat16, 2048, 1024
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2468)
    out = []
    for proj, n, d in (("wo", c.all_heads_dim // 2, c.dim), ("w2", c.hidden_dim // 2, c.dim)):
        w = _stacked_weights(torch, gen, 2, n, d, g, bf16)
        x = torch.randn(rows, n, generator=gen, device=DEV).to(bf16)
        full = qmatmul_w8a16_rows(x, w, 1)
        for c0 in (0, 3072):
            cols = (c0, dc)
            ref = qmatmul_w8a16_rows_plain(x, w, 1, out_cols=cols)
            got = qmatmul_w8a16_rows(x, w, 1, out_cols=cols)
            torch.cuda.synchronize()
            err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
            need(math.isfinite(err) and err <= tol, f"qmatmul_w8a16_rows out_cols {proj} {cols}: {err} > {tol}")
            need(torch.equal(got, full[:, c0 : c0 + dc]), f"qmatmul_w8a16_rows out_cols {proj} {cols} != full columns")
            ms = device_ms(torch, lambda i: qmatmul_w8a16_rows(x, w, i % 2, out_cols=cols))
            plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_rows_plain(x, w, i % 2, out_cols=cols), reps=5, warmup=1)
            dense = [dequant_weights(QuantizedTensor(w.q[l, :, c0 : c0 + dc], w.scales[l, :, c0 : c0 + dc]))
                     for l in range(2)]
            lib_ms = device_ms(torch, lambda i: torch.matmul(x, dense[i % 2]))
            del dense
            nbytes, ops = rows_cols_counts(rows, n, dc, g)
            b_ms, b_by = bound(nbytes, ops, "bf16")
            out.append(_row(
                ctx, "qmatmul_w8a16_rows_cols", f"{proj} tp=2 shard rows={rows} out_cols={cols}",
                "qwen3_rs_tpu_torch/csrc/qmatmul_rows.cu",
                "qwen3_rs_tpu/ops/pallas/qmatmul.py:956 qmatmul_pallas_stacked_rows(out_cols=) (:888-953)",
                {"rows": rows, "N": n, "D": d, "c0": c0, "dc": dc, "g": g}, err, tol, ms, plain_ms, nbytes, b_ms,
                b_by, lib_ms, "torch.matmul bf16 on the column slice, dequantized beforehand",
            ))
            out[-1]["equal_to_full_columns"] = True
        del w, x, full, ref, got
        torch.cuda.empty_cache()
    return out


def head_dim_cases(torch, ctx) -> list[dict]:
    """#4, #5, #9 and #10 at head_dim 256, 384, 512 and 640 (small shapes: 2 kv
    heads of 4 query heads, 8 requests at mixed positions over a 1024-row
    cache or a page-128 pool; #5 over a fresh 1000-row window), each against
    its plain version with the tolerance of its head_dim-128 cases, then the
    full-width rows of #5, #10, #9 and #4 at head_dim 512
    (``wide_head_dim_cases``).  Past 256: the kernels past 256 of #5, #10
    and #9's decode (which #4 runs too).  Every entry point here is one that
    older trees have too, so that ``--phases build,heads`` times an older
    checkout's kernels at the same cases."""
    return ([row for hd in (256, 384, 512, 640) for row in _head_dim_cases(torch, ctx, hd, (hd,))]
            + wide_head_dim_cases(torch, ctx))


def _head_dim_cases(torch, ctx, hd: int, prefill_hds, labels: bool = True) -> list[dict]:
    """``head_dim_cases`` at one head_dim; ``labels`` False leaves #10's
    source unnamed (the name needs this tree's route function)."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.flash_attention import flash_decode, flash_decode_plain
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        paged_decode, paged_decode_plain, paged_window_partials, paged_window_partials_plain,
    )
    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import (
        causal_prefill_attention, causal_prefill_attention_plain,
    )
    from qwen3_rs_tpu_torch.testing import paged_read_bytes

    n_kv, kv_mul, t = 2, 4, 1024
    h = n_kv * kv_mul
    pos_list = [0, 1, 127, 128, 129, 500, 777, 1023]
    b = len(pos_list)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1000 + hd)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=DEV)
    out = []
    mask_rows = lambda n: (torch.arange(n, device=DEV)[None, :] < pos[:, None].long())[:, None, None, :]

    # #4 over a dense bf16 cache.
    k_all, v_all = (torch.randn(2, b, n_kv, t, hd, generator=gen, device=DEV).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(b, h, hd, generator=gen, device=DEV)
    kn, vn = (torch.randn(b, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
    ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1)
    got = flash_decode(q, kn, vn, k_all, v_all, pos, 1)
    torch.cuda.synchronize()
    err, tol = float((got - ref).abs().max()), 1e-5
    need(math.isfinite(err) and err <= tol, f"flash_decode head_dim {hd}: {err} > {tol}")
    need(torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0)), f"flash_decode head_dim {hd}: pos 0 != v_self")
    ms = device_ms(torch, lambda i: flash_decode(q, kn, vn, k_all, v_all, pos, i % 2))
    plain_ms = device_ms(torch, lambda i: flash_decode_plain(q, kn, vn, k_all, v_all, pos, i % 2), reps=5, warmup=1)
    kk = torch.cat([kn[:, :, None], k_all[1].float()], 2).repeat_interleave(kv_mul, dim=1)
    vv = torch.cat([vn[:, :, None], v_all[1].float()], 2).repeat_interleave(kv_mul, dim=1)
    m = (torch.arange(t + 1, device=DEV)[None, :] <= pos[:, None].long())[:, None, None, :]
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=m))
    nbytes = 2 * n_kv * sum(pos_list) * hd * 2 + (2 * q.numel() + kn.numel() + vn.numel()) * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * h * sum(p + 1 for p in pos_list) * hd, "f32")
    out.append(_row(ctx, "flash_decode", f"head_dim {hd}, bf16 cache B={b} T={t}", flash_source(hd, t),
                    "qwen3_rs_tpu/ops/pallas/flash_attention.py:212 flash_gqa_decode_stacked",
                    {"B": b, "heads": h, "kv_heads": n_kv, "hd": hd, "T": t, "pos": pos_list}, err, tol, ms, plain_ms,
                    nbytes, b_ms, b_by, lib_ms, "F.scaled_dot_product_attention, K/V prepared beforehand"))
    del k_all, v_all, kk, vv

    # #5 over a fresh 1000-row window.
    s = 1000
    for phd in prefill_hds:
        qp = torch.randn(1, s, h, phd, generator=gen, device=DEV).to(torch.bfloat16)
        kp, vp = (torch.randn(1, s, n_kv, phd, generator=gen, device=DEV).to(torch.bfloat16) for _ in range(2))
        got = causal_prefill_attention(qp, kp, vp).float()
        ref = causal_prefill_attention_plain(qp, kp, vp).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        excess = float(((got - ref).abs() - 2.0**-7 * ref.abs()).max())
        need(math.isfinite(err) and excess <= 1e-5,
             f"causal_prefill_attention head_dim {phd}: off by more than a bf16 step")
        ms = device_ms(torch, lambda i: causal_prefill_attention(qp, kp, vp))
        plain_ms = device_ms(torch, lambda i: causal_prefill_attention_plain(qp, kp, vp), reps=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qp, kp, vp))
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * (2 * qp.numel() + kp.numel() + vp.numel())
        b_ms, b_by = bound(nbytes, 4.0 * (s * (s + 1) // 2) * phd * h, "bf16")
        out.append(_row(ctx, "causal_prefill_attention", f"head_dim {phd}, fresh window S={s}",
                        "qwen3_rs_tpu_torch/csrc/prefill_attention.cu",
                        "qwen3_rs_tpu/ops/pallas/prefill_attention.py:87 causal_prefill_attention",
                        {"B": 1, "S": s, "heads": h, "kv_heads": n_kv, "hd": phd}, err,
                        "2^-7 * |ref| + 1e-5 per element", ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
                        "F.scaled_dot_product_attention is_causal, enable_gqa"))
        del qp, kp, vp, qt, kt, vt, got, ref

    # #9 and #10 over a page-128 bf16 pool, shuffled tables.
    page, max_pages = 128, t // 128
    n_pages = 1 + b * max_pages
    kpool, vpool = (torch.randn(2, n_pages, n_kv, page, hd, generator=gen, device=DEV).to(torch.bfloat16)
                    for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device=DEV) + 1).reshape(b, max_pages).to(torch.int32)
    rows_of = lambda l, pool: pool[l][table.long()].permute(0, 2, 1, 3, 4).reshape(b, n_kv, t, hd).float()
    read = paged_read_bytes(pos_list, n_kv, hd, 2) + table.numel() * 4 + b * 4
    ref = paged_decode_plain(q, kn, vn, kpool, vpool, table, pos, 1)
    got = paged_decode(q, kn, vn, kpool, vpool, table, pos, 1)
    torch.cuda.synchronize()
    err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
    need(math.isfinite(err) and err <= tol, f"paged_decode head_dim {hd}: {err} > {tol}")
    need(torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0)), f"paged_decode head_dim {hd}: pos 0 != v_self")
    if labels:
        from qwen3_rs_tpu_torch.ops.kernels.paged_attention import paged_decode_phases, split_kernel_takes

        if split_kernel_takes(hd, page):
            emit({"phase": "kernels", "paged_decode_phases_us": paged_decode_phases(q, kn, vn, kpool, vpool, table,
                                                                                    pos, 1),
                  "case": f"head_dim {hd}, bf16 pool B={b}"})
    ms = device_ms(torch, lambda i: paged_decode(q, kn, vn, kpool, vpool, table, pos, i % 2))
    plain_ms = device_ms(torch, lambda i: paged_decode_plain(q, kn, vn, kpool, vpool, table, pos, i % 2), reps=5, warmup=1)
    kk = torch.cat([kn[:, :, None], rows_of(1, kpool)], 2)
    vv = torch.cat([vn[:, :, None], rows_of(1, vpool)], 2)
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=m, enable_gqa=True))
    nbytes = read + (2 * q.numel() + kn.numel() + vn.numel()) * 4
    b_ms, b_by = bound(nbytes, 4.0 * h * sum(p + 1 for p in pos_list) * hd, "f32")
    out.append(_row(ctx, "paged_decode", f"head_dim {hd}, bf16 pool B={b} pos={pos_list}",
                    paged_decode_source(hd, page),
                    "qwen3_rs_tpu/ops/pallas/paged_attention.py:207 paged_gqa_decode_stacked",
                    {"B": b, "heads": h, "kv_heads": n_kv, "hd": hd, "page": page, "pos": pos_list}, err, tol, ms,
                    plain_ms, nbytes, b_ms, b_by, lib_ms,
                    "F.scaled_dot_product_attention enable_gqa, K/V gathered into dense f32 beforehand"))
    sw = 16
    qw = torch.randn(b, sw, h, hd, generator=gen, device=DEV)
    ref = paged_window_partials_plain(qw, kpool, vpool, table, pos, 1)
    got = paged_window_partials(qw, kpool, vpool, table, pos, 1)
    torch.cuda.synchronize()
    err, tol = 0.0, 0.0
    for a, e in zip(got, ref):
        need(a.shape == e.shape and torch.equal(torch.isneginf(a), torch.isneginf(e)),
             f"paged_window_partials head_dim {hd}: shapes or -inf entries differ")
        fin = torch.isfinite(e)
        d_ = float((a[fin] - e[fin]).abs().max())
        t_ = 1e-4 * float(e[fin].abs().max())
        need(d_ <= t_, f"paged_window_partials head_dim {hd}: off by {d_} > {t_}")
        err, tol = max(err, d_), max(tol, t_)
    if labels:
        from qwen3_rs_tpu_torch.ops.kernels.paged_attention import paged_window_phases, window_split_takes

        if window_split_takes(hd, page, kpool.dtype):
            emit({"phase": "kernels", "paged_window_phases_us": paged_window_phases(qw, kpool, vpool, table, pos, 1),
                  "case": f"head_dim {hd}, bf16 pool B={b} S={sw}"})
    ms = device_ms(torch, lambda i: paged_window_partials(qw, kpool, vpool, table, pos, i % 2))
    plain_ms = device_ms(torch, lambda i: paged_window_partials_plain(qw, kpool, vpool, table, pos, i % 2),
                         reps=5, warmup=1)
    kc, vc = rows_of(1, kpool), rows_of(1, vpool)
    qt = qw.transpose(1, 2)
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask_rows(t), enable_gqa=True))
    r = sw * kv_mul
    nbytes = read + qw.numel() * 4 + b * n_kv * r * (hd + 2) * 4
    b_ms, b_by = bound(nbytes, 4.0 * h * sw * sum(pos_list) * hd, "bf16")  # #10's products: tensor cores
    out.append(_row(ctx, "paged_window_partials", f"head_dim {hd}, bf16 pool B={b} S={sw} (R={r})",
                    paged_window_source(hd, page, torch.bfloat16) if labels else None,
                    "qwen3_rs_tpu/ops/pallas/paged_attention.py:437 paged_gqa_window_stacked (_partials_kernel :287)",
                    {"B": b, "S": sw, "R": r, "heads": h, "kv_heads": n_kv, "hd": hd, "page": page, "pos": pos_list},
                    err, tol, ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
                    "F.scaled_dot_product_attention enable_gqa on the cache rows, gathered into dense f32 beforehand"))
    del kpool, vpool, kk, vv, kc, vc
    torch.cuda.empty_cache()
    return out


def dequant_cases(torch, ctx) -> list[dict]:
    """Dequant (#7) of one w2 layer, the xdot path's weight at 4096-row
    eval-ppl windows: f32 scales (as evaluation keeps them) and bf16."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import dequant_w8_stacked, dequant_w8_stacked_plain
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    n, d, g = c.hidden_dim, c.dim, c.group_size
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8765)
    out = []
    for sdt, sname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        nl = _layers_for(3 * n * d)
        w = _stacked_weights(torch, gen, nl, n, d, g, sdt)
        got = dequant_w8_stacked(w, 1)
        ref = dequant_w8_stacked_plain(w, 1)
        torch.cuda.synchronize()
        need(torch.equal(got, ref), f"dequant_w8_stacked {sname} scales: not bit-exact")
        ms = device_ms(torch, lambda i: dequant_w8_stacked(w, i % nl))
        plain_ms = device_ms(torch, lambda i: dequant_w8_stacked_plain(w, i % nl), reps=5, warmup=1)
        nbytes = n * d + (n // g) * d * w.scales.element_size() + n * d * 2
        b_ms, b_by = bound(nbytes, float(n * d), "f32")
        out.append(_row(
            ctx, "dequant_w8_stacked", f"w2 {sname} scales", "qwen3_rs_tpu_torch/csrc/dequant.cu",
            "qwen3_rs_tpu/ops/pallas/qmatmul.py:1063 dequant_pallas_stacked",
            {"N": n, "D": d, "g": g}, 0.0, 0.0, ms, plain_ms, nbytes, b_ms, b_by, None,
            "none: no one PyTorch call applies grouped scales to int8 codes (it takes a cast, a "
            "broadcast of the scales and a multiply)",
        ))
        del w, got, ref
        torch.cuda.empty_cache()
    return out


def _q4_stacked(torch, gen, layers, n, d, g, scale_dtype):
    """Random INT4 weights: uniform packed bytes (every nibble value, code -8
    included) and scales."""
    from qwen3_rs_tpu_torch.ops.quant import Q4Tensor

    packed = torch.randint(0, 256, (layers, n // 2, d), generator=gen, device=DEV, dtype=torch.uint8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=DEV) * 0.02 + 1e-3).to(scale_dtype)
    return Q4Tensor(packed, scales)


def _q4_bytes(n, d, g) -> int:
    """Packed codes and bf16 scales of one [N, D] INT4 layer."""
    return n * d // 2 + (n // g) * d * 2


def qmatmul_q4_cases(torch, ctx) -> list[dict]:
    """The Q4 variant of #3 (``qmatmul_w8a16`` on a ``Q4Tensor``) at the
    INT4 decode step's shapes."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import dequant_q4_stacked_plain, qmatmul_w8a16, qmatmul_w8a16_plain
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [  # (case, N, D, prologue, residual, rows, x dtype), as qwen3_forward calls it
        ("wqkv+rms b=1", dim, ah + 2 * kvd, "rms", False, 1, bf16),
        ("wo+residual b=1", ah, dim, None, True, 1, f32),
        ("w13+rms b=1", dim, 2 * hid, "rms", False, 1, bf16),
        ("w2+swiglu+residual b=1", hid, dim, "swiglu", True, 1, f32),
    ]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4242)
    out = []
    for case, n, d, prologue, has_res, rows, xdt in specs:
        nl = _layers_for(_q4_bytes(n, d, g))
        w = _q4_stacked(torch, gen, nl, n, d, g, bf16)
        width = 2 * n if prologue == "swiglu" else n
        x = torch.randn(rows, width, generator=gen, device=DEV).to(xdt)
        kw = {}
        if prologue == "rms":
            kw["norm_w"] = 1.0 + 0.02 * torch.randn(nl, n, generator=gen, device=DEV)
        if prologue == "swiglu":
            kw["swiglu"] = True
        if has_res:
            kw["residual"] = torch.randn(rows, d, generator=gen, device=DEV).to(bf16)
        ref = qmatmul_w8a16_plain(x, w, 1, **kw)
        got = qmatmul_w8a16(x, w, 1, **kw)
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        tol = (2e-3 if prologue else 1e-4) * scale  # as the INT8 cases
        need(math.isfinite(err) and err <= tol, f"qmatmul_w8a16_q4 {case}: max_abs_err {err} > tol {tol}")
        ms = device_ms(torch, lambda i: qmatmul_w8a16(x, w, i % nl, **kw))
        plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_plain(x, w, i % nl, **kw), reps=5, warmup=1)
        xl = x[:, :n].to(bf16)
        dense = [dequant_q4_stacked_plain(w, l) for l in range(min(nl, max(2, math.ceil(160e6 / (2 * n * d)))))]
        lib_ms = device_ms(torch, lambda i: torch.matmul(xl, dense[i % len(dense)]))
        del dense
        nbytes = (_q4_bytes(n, d, g) + x.numel() * x.element_size() + rows * d * 4
                  + (rows * d * 2 if has_res else 0) + (n * 4 if prologue == "rms" else 0))
        b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
        out.append(_row(
            ctx, w8a16_key(rows, q4=True), case, "qwen3_rs_tpu_torch/csrc/qmatmul_w8a16.cu",
            "qwen3_rs_tpu/ops/pallas/qmatmul.py:761 qmatmul_pallas_stacked_fused (Q4 tiles, :34 _dequant_tile_q4)",
            {"rows": rows, "N": n, "D": d, "g": g, "bits": 4}, err, tol, ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
            "torch.matmul bf16, weights dequantized beforehand",
        ))
        del w, x, kw, ref, got
        torch.cuda.empty_cache()
    return out


def rows_q4_cases(torch, ctx) -> list[dict]:
    """The Q4 variant of #6 at the INT4 path's long windows: wqkv and w13 at
    a fresh 2048-row window, w2 at eval-ppl's 4096 rows (where the path takes
    #7 + torch.matmul instead: the two side by side)."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
        dequant_q4_stacked_plain,
        qmatmul_w8a16_rows,
        qmatmul_w8a16_rows_plain,
    )
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    g, bf16 = c.group_size, torch.bfloat16
    specs = [("wqkv", c.dim, c.all_heads_dim + 2 * c.kv_dim, 2048), ("w13", c.dim, 2 * c.hidden_dim, 2048),
             ("w2", c.hidden_dim, c.dim, 4096)]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4343)
    out = []
    for proj, n, d, rows in specs:
        w = _q4_stacked(torch, gen, 2, n, d, g, bf16)
        x = torch.randn(rows, n, generator=gen, device=DEV).to(bf16)
        ref = qmatmul_w8a16_rows_plain(x, w, 1)
        got = qmatmul_w8a16_rows(x, w, 1)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
        need(math.isfinite(err) and err <= tol, f"qmatmul_w8a16_rows_q4 {proj} rows={rows}: {err} > {tol}")
        ms = device_ms(torch, lambda i: qmatmul_w8a16_rows(x, w, i % 2))
        plain_ms = device_ms(torch, lambda i: qmatmul_w8a16_rows_plain(x, w, i % 2), reps=5, warmup=1)
        dense = [dequant_q4_stacked_plain(w, l) for l in range(2)]
        lib_ms = device_ms(torch, lambda i: torch.matmul(x, dense[i % 2]))
        del dense
        nbytes = _q4_bytes(n, d, g) + rows * n * 2 + rows * d * 4
        b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, "bf16")
        out.append(_row(
            ctx, "qmatmul_w8a16_rows_q4", f"{proj} rows={rows}", "qwen3_rs_tpu_torch/csrc/qmatmul_rows.cu",
            "qwen3_rs_tpu/ops/pallas/qmatmul.py:956 qmatmul_pallas_stacked_rows (Q4 tiles, :870)",
            {"rows": rows, "N": n, "D": d, "g": g, "bits": 4}, err, tol, ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
            "torch.matmul bf16, weights dequantized beforehand",
        ))
        del w, x, ref, got
        torch.cuda.empty_cache()
    return out


def dequant_q4_cases(torch, ctx) -> list[dict]:
    """The Q4 variant of #7 on one INT4 w2 layer (the xdot path's weight at
    4096-row windows), f32 scales as evaluation keeps them."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import dequant_q4_stacked, dequant_q4_stacked_plain
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    n, d, g = c.hidden_dim, c.dim, c.group_size
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4444)
    nl = _layers_for(n * d // 2 + 2 * n * d)
    w = _q4_stacked(torch, gen, nl, n, d, g, torch.float32)
    got = dequant_q4_stacked(w, 1)
    ref = dequant_q4_stacked_plain(w, 1)
    torch.cuda.synchronize()
    need(torch.equal(got, ref), "dequant_q4_stacked: not bit-exact")
    ms = device_ms(torch, lambda i: dequant_q4_stacked(w, i % nl))
    plain_ms = device_ms(torch, lambda i: dequant_q4_stacked_plain(w, i % nl), reps=5, warmup=1)
    nbytes = n * d // 2 + (n // g) * d * 4 + n * d * 2
    b_ms, b_by = bound(nbytes, float(n * d), "f32")
    row = _row(
        ctx, "dequant_q4_stacked", "w2 f32 scales", "qwen3_rs_tpu_torch/csrc/dequant.cu",
        "qwen3_rs_tpu/ops/pallas/qmatmul.py:1063 dequant_pallas_stacked (Q4 branch, :998)",
        {"N": n, "D": d, "g": g, "bits": 4}, 0.0, 0.0, ms, plain_ms, nbytes, b_ms, b_by, None,
        "none: no one PyTorch call unpacks nibbles and applies grouped scales",
    )
    del w, got, ref
    torch.cuda.empty_cache()
    return [row]


def a8_cases(torch, ctx) -> list[dict]:
    """W8A8 rows (#8) at exact mode's shapes: a ragged prompt window, a
    2048-row window, and eval-ppl's 4096 rows on w2 and on the classifier."""
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul_a8 import qmatmul_w8a8_rows, qmatmul_w8a8_rows_plain
    from qwen3_rs_tpu_torch.ops.quant import quantize_activations
    from qwen3_rs_tpu_torch.testing import padded_vocab, qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    specs = [("wqkv", dim, ah + 2 * kvd, 300, 2), ("w13", dim, 2 * hid, 2048, 2), ("w2", hid, dim, 4096, 2),
             ("lm_head", dim, padded_vocab(c.vocab_size), 4096, 1)]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2468)
    out = []
    for proj, n, d, rows, nl in specs:
        w = _stacked_weights(torch, gen, nl, n, d, g, torch.float32)
        xq = quantize_activations(torch.randn(rows, n, generator=gen, device=DEV), g)
        got = qmatmul_w8a8_rows(xq.q, xq.scales, w, nl - 1)
        ref = qmatmul_w8a8_rows_plain(xq.q, xq.scales, w, nl - 1)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        need(torch.equal(got, ref), f"qmatmul_w8a8_rows {proj} rows={rows}: not bit-exact ({err})")
        del ref, got
        ms = device_ms(torch, lambda i: qmatmul_w8a8_rows(xq.q, xq.scales, w, i % nl), reps=10)
        plain_ms = device_ms(torch, lambda i: qmatmul_w8a8_rows_plain(xq.q, xq.scales, w, i % nl), reps=3, warmup=1)
        groups = n // g
        nbytes = rows * n + rows * groups * 4 + n * d + groups * d * 4 + rows * d * 4
        # int8 products on the tensor cores and the fix-up on the CUDA cores, on
        # separate pipes that may overlap: the larger of the two.  The fix-up is 3
        # rounded f32 operations per output element and group, each one
        # instruction (no FMA), at 128 a clock per SM: F32_INSTR_PER_S, half of
        # PEAK_OPS_PER_S["f32"], which counts an FMA as two operations.
        t_ops = max(2.0 * rows * n * d / PEAK_OPS_PER_S["int8"], 3.0 * rows * d * groups / F32_INSTR_PER_S) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out.append(_row(
            ctx, "qmatmul_w8a8_rows", f"{proj} rows={rows}", "qwen3_rs_tpu_torch/csrc/qmatmul_a8.cu",
            "qwen3_rs_tpu/ops/pallas/qmatmul.py:1287 qmatmul_pallas_stacked_rows_a8",
            {"rows": rows, "N": n, "D": d, "g": g}, err, 0.0, ms, plain_ms, nbytes, b_ms, b_by, None,
            "none: torch._int_mm multiplies int8 matrices but no one call applies per-group activation "
            "and weight scales inside the contraction",
        ))
        del w, xq
        torch.cuda.empty_cache()
    return out


def prefill_attention_cases(torch, ctx) -> list[dict]:
    """Causal prefill attention (#5) over a fresh window at 8B's heads: the
    2048-row window and a ragged one."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import (
        causal_prefill_attention,
        causal_prefill_attention_plain,
    )
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    h, n_kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1357)
    out = []
    for s in (2048, 1000):
        q, k, v = (torch.randn(1, s, heads, hd, generator=gen, device=DEV).to(torch.bfloat16)
                   for heads in (h, n_kv, n_kv))
        got = causal_prefill_attention(q, k, v).float()
        ref = causal_prefill_attention_plain(q, k, v).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # Both round an f32 result to bf16; f32 sums in another order may flip
        # that rounding: one bf16 step of each element, plus 1e-5 of f32 sums of
        # O(1) values for outputs that cancel to near zero.
        excess = float(((got - ref).abs() - 2.0**-7 * ref.abs()).max())
        need(math.isfinite(err) and excess <= 1e-5, f"causal_prefill_attention S={s}: off by more than a bf16 step")
        ms = device_ms(torch, lambda i: causal_prefill_attention(q, k, v))
        plain_ms = device_ms(torch, lambda i: causal_prefill_attention_plain(q, k, v), reps=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(nbytes, 4.0 * (s * (s + 1) // 2) * hd * h, "bf16")
        out.append(_row(
            ctx, "causal_prefill_attention", f"fresh window S={s}", "qwen3_rs_tpu_torch/csrc/prefill_attention.cu",
            "qwen3_rs_tpu/ops/pallas/prefill_attention.py:87 causal_prefill_attention",
            {"B": 1, "S": s, "heads": h, "kv_heads": n_kv, "hd": hd}, err, "2^-7 * |ref| + 1e-5 per element",
            ms, plain_ms, nbytes, b_ms, b_by, lib_ms, "F.scaled_dot_product_attention is_causal, enable_gqa",
        ))
        del q, k, v, qt, kt, vt, got, ref
        torch.cuda.empty_cache()
    return out


def _paged_inputs(torch, gen, pool, pos_list, n_layers_min=2, head_dim=None):
    """An 8B-shaped page pool (page 128, ctx 4096; head_dim ``head_dim``
    where given) with random rows, layers enough that the touched pages of
    each launch are cold in L2, and one shuffled table of disjoint pages per
    request."""
    from qwen3_rs_tpu_torch.testing import paged_read_bytes, qwen3_config

    c = qwen3_config("8b")
    page, max_pages, n_kv, hd = 128, 4096 // 128, c.n_kv_heads, head_dim or c.head_dim
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    esz = {"f32": 4, "bf16": 2, "int8": 1}[pool]
    nl = _layers_for(max(paged_read_bytes(pos_list, n_kv, hd, esz), 1), floor=n_layers_min)
    shape = (nl, n_pages, n_kv, page, hd)
    if pool == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8) for _ in range(2))
        sc = {name: torch.rand(shape[:-1], generator=gen, device=DEV) * 0.02 + 0.005
              for name in ("k_scale_pool", "v_scale_pool")}
    else:
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        k, v = (torch.randn(shape, generator=gen, device=DEV).to(dt) for _ in range(2))
        sc = {}
    ids = torch.randperm(n_pages - 1, generator=gen, device=DEV) + 1
    table = ids.reshape(b, max_pages).to(torch.int32).contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=DEV)
    return c, nl, k, v, sc, table, pos, esz


def _gathered(torch, k, v, sc, table, pos_list, layer):
    """The pool's rows of each request gathered into dense f32 [B, n_kv, T, hd]
    (an INT8 pool's codes times their scales): the library call's input,
    prepared beforehand."""
    from qwen3_rs_tpu_torch.ops.attention import gather_pages

    t = max(max(pos_list), 1)

    def rows(pool):
        return gather_pages(pool[layer], table, 0, -(-t // k.shape[3]))[:, :, :t]

    kc, vc = rows(k).float(), rows(v).float()
    if sc:
        kc = kc * rows(sc["k_scale_pool"])[..., None]
        vc = vc * rows(sc["v_scale_pool"])[..., None]
    return kc, vc


def _sdpa_backend(torch, q, k, v, mask=None) -> str:
    """The backend that ``F.scaled_dot_product_attention(q, k, v,
    is_causal=True)`` (with ``mask``: ``attn_mask=mask``) takes for these
    inputs, by name (torch's own choice, read through its private
    ``_fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, mask is None)).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as e:
        return f"not named ({type(e).__name__})"


def wide_head_dim_cases(torch, ctx) -> list[dict]:
    """#5, #10, #9 and #4 at head_dim 512 with the 8B's head counts (32 query
    heads over 8 kv heads): #5 over a fresh 2048-row window, its library call
    on heads expanded beforehand (the backend torch picks named); #10 at B=8,
    S=16 (R=64 a kv head) at the kernel table's mixed positions over bf16,
    INT8 and f32 pools of page 128 (one layer's bf16 pool ~0.54 GB); #9 and
    #4 as ``wide_decode_cases``."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import (
        causal_prefill_attention,
        causal_prefill_attention_plain,
    )
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    h, n_kv, hd, s = c.n_heads, c.n_kv_heads, 512, 2048
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2468)
    q, k, v = (torch.randn(1, s, heads, hd, generator=gen, device=DEV).to(torch.bfloat16) for heads in (h, n_kv, n_kv))
    got = causal_prefill_attention(q, k, v).float()
    ref = causal_prefill_attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    excess = float(((got - ref).abs() - 2.0**-7 * ref.abs()).max())
    need(math.isfinite(err) and excess <= 1e-5, f"causal_prefill_attention head_dim {hd} S={s}: off by more than a bf16 step")
    ms = device_ms(torch, lambda i: causal_prefill_attention(q, k, v))
    plain_ms = device_ms(torch, lambda i: causal_prefill_attention_plain(q, k, v), reps=5, warmup=1)
    qt = q.transpose(1, 2).contiguous()
    kx, vx = (t.repeat_interleave(h // n_kv, dim=2).transpose(1, 2).contiguous() for t in (k, v))
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True))
    backend = _sdpa_backend(torch, qt, kx, vx)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, 4.0 * (s * (s + 1) // 2) * hd * h, "bf16")
    out = [_row(ctx, "causal_prefill_attention", f"head_dim {hd}, {h}/{n_kv} heads, fresh window S={s}",
                "qwen3_rs_tpu_torch/csrc/prefill_attention.cu",
                "qwen3_rs_tpu/ops/pallas/prefill_attention.py:87 causal_prefill_attention",
                {"B": 1, "S": s, "heads": h, "kv_heads": n_kv, "hd": hd}, err, "2^-7 * |ref| + 1e-5 per element",
                ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
                f"F.scaled_dot_product_attention is_causal on heads expanded beforehand ({backend})")]
    del q, k, v, qt, kx, vx, got, ref
    torch.cuda.empty_cache()
    return (out + paged_window_cases(torch, ctx, plan=False, hd=hd, cases=(("bf16", 16), ("int8", 16), ("f32", 16)),
                                     source=True)
            + wide_decode_cases(torch, ctx, hd))


def wide_decode_cases(torch, ctx, hd: int) -> list[dict]:
    """#9 and #4 at head_dim ``hd`` with the 8B's head counts (32 query heads
    over 8 kv heads): #9 at B=8 at the kernel table's mixed positions to 4095
    over bf16, INT8 and f32 pools of page 128 (one layer's bf16 pool ~0.54
    GB), the one-launch kernel's stamps over the bf16 pool where it takes the
    pool; #4 at B=1, T=4096, pos 4095 over f32 and bf16 caches, the two-pass
    kernel beside it.  Each against its plain version (1e-4·max|ref|, 1e-5·
    max(1, max|ref|)), v_self exactly at pos 0; the library call SDPA on
    heads expanded beforehand (K/V gathered into dense f32, its backend
    named).  Entry points every tree of the port has (``paged_decode``,
    ``flash_decode``, ``flash_decode_two_pass`` and their plain versions)."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa
    from qwen3_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_decode, flash_decode_plain, flash_decode_two_pass,
    )
    from qwen3_rs_tpu_torch.testing import paged_read_bytes, qwen3_config

    c = qwen3_config("8b")
    h, n_kv = c.n_heads, c.n_kv_heads
    kv_mul = h // n_kv
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1357)
    out = []
    pos_list = [0, 1, 127, 128, 129, 1000, 2049, 4095]
    b = len(pos_list)
    for pool in ("bf16", "int8", "f32"):
        _, nl, k, v, sc, table, pos, esz = _paged_inputs(torch, gen, pool, pos_list, head_dim=hd)
        q = torch.randn(b, h, hd, generator=gen, device=DEV)
        kn, vn = (torch.randn(b, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
        ref = pa.paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
        got = pa.paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
        case = f"head_dim {hd}, {h}/{n_kv} heads, {pool} pool B={b} pos={pos_list}"
        need(math.isfinite(err) and err <= tol, f"paged_decode {case}: {err} > {tol}")
        need(torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0)), f"paged_decode {case}: pos 0 != v_self")
        if pool == "bf16" and pa.split_kernel_takes(hd, 128):
            emit({"phase": "kernels", "paged_decode_phases_us": pa.paged_decode_phases(q, kn, vn, k, v, table, pos, 1,
                                                                                       **sc), "case": case})
        ms = device_ms(torch, lambda i: pa.paged_decode(q, kn, vn, k, v, table, pos, i % nl, **sc))
        plain_ms = device_ms(torch, lambda i: pa.paged_decode_plain(q, kn, vn, k, v, table, pos, i % nl, **sc),
                             reps=5, warmup=1)
        lib = []
        for l in range(min(nl, 2)):
            kc, vc = _gathered(torch, k, v, sc, table, pos_list, l)
            kk, vv = (torch.cat([x[:, :, None], y], 2).repeat_interleave(kv_mul, dim=1) for x, y in ((kn, kc), (vn, vc)))
            mask = (torch.arange(kk.shape[2], device=DEV)[None, :] <= pos[:, None].long())[:, None, None, :]
            lib.append((kk, vv, mask))
            del kc, vc
        q4 = q[:, :, None]
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(q4, *lib[i % len(lib)][:2],
                                                                           attn_mask=lib[i % len(lib)][2]))
        backend = _sdpa_backend(torch, q4, *lib[0][:2], lib[0][2])
        del lib
        nbytes = (paged_read_bytes(pos_list, n_kv, hd, esz) + (2 * q.numel() + kn.numel() + vn.numel()) * 4
                  + table.numel() * 4 + b * 4)
        b_ms, b_by = bound(nbytes, 4.0 * h * sum(p + 1 for p in pos_list) * hd, "f32")
        out.append(_row(ctx, "paged_decode", case, paged_decode_source(hd, 128),
                        "qwen3_rs_tpu/ops/pallas/paged_attention.py:207 paged_gqa_decode_stacked",
                        {"B": b, "heads": h, "kv_heads": n_kv, "hd": hd, "page": 128, "pos": pos_list}, err, tol, ms,
                        plain_ms, nbytes, b_ms, b_by, lib_ms,
                        f"F.scaled_dot_product_attention on heads expanded beforehand, K/V gathered into dense f32 "
                        f"({backend})"))
        del k, v, sc, ref, got
        torch.cuda.empty_cache()
    t, p = 4096, 4095
    for cache in ("f32", "bf16"):
        esz = {"f32": 4, "bf16": 2}[cache]
        shape = (_layers_for(2 * n_kv * t * hd * esz), 1, n_kv, t, hd)
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        k_all, v_all = (torch.randn(shape, generator=gen, device=DEV).to(dt) for _ in range(2))
        nl = shape[0]
        q = torch.randn(1, h, hd, generator=gen, device=DEV)
        kn, vn = (torch.randn(1, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1)
        got = flash_decode(q, kn, vn, k_all, v_all, pos, 1)
        two = flash_decode_two_pass(q, kn, vn, k_all, v_all, pos, 1)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), 1e-5 * max(1.0, float(ref.abs().max()))
        case = f"head_dim {hd}, {h}/{n_kv} heads, {cache} cache B=1 pos={p} T={t}"
        need(math.isfinite(err) and err <= tol, f"flash_decode {case}: {err} > {tol}")
        need(float((two - ref).abs().max()) <= tol, f"flash_decode two-pass {case}")
        ms = device_ms(torch, lambda i: flash_decode(q, kn, vn, k_all, v_all, pos, i % nl))
        two_ms = device_ms(torch, lambda i: flash_decode_two_pass(q, kn, vn, k_all, v_all, pos, i % nl))
        plain_ms = device_ms(torch, lambda i: flash_decode_plain(q, kn, vn, k_all, v_all, pos, i % nl), reps=5, warmup=1)
        lib = [tuple(torch.cat([x[:, :, None], y[l, :, :, :p].float()], 2).repeat_interleave(kv_mul, dim=1)
                     for x, y in ((kn, k_all), (vn, v_all))) for l in range(min(nl, 2))]
        q4 = q[:, :, None]
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(q4, *lib[i % len(lib)]))
        backend = _sdpa_backend(torch, q4, *lib[0], None)
        del lib
        nbytes = 2 * n_kv * p * hd * esz + (2 * q.numel() + kn.numel() + vn.numel()) * 4 + 4
        b_ms, b_by = bound(nbytes, 4.0 * h * (p + 1) * hd, "f32")
        row = _row(ctx, "flash_decode", case, flash_source(hd, t),
                   "qwen3_rs_tpu/ops/pallas/flash_attention.py:212 flash_gqa_decode_stacked",
                   {"B": 1, "heads": h, "kv_heads": n_kv, "hd": hd, "T": t, "pos": p}, err, tol, ms, plain_ms, nbytes,
                   b_ms, b_by, lib_ms, f"F.scaled_dot_product_attention on heads expanded beforehand ({backend})")
        row["two_pass_ms"] = two_ms
        emit({"phase": "kernels", "case": case, "two_pass_ms": two_ms})
        out.append(row)
        del k_all, v_all, ref, got, two
        torch.cuda.empty_cache()
    return out


def paged_decode_source(hd: int, page: int) -> str:
    """The source of the kernel ``paged_decode`` launches at this head_dim
    and page size."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import split_kernel_takes

    return f"qwen3_rs_tpu_torch/csrc/{'paged_decode' if split_kernel_takes(hd, page) else 'paged_attention'}.cu"


def paged_decode_cases(torch, ctx) -> list[dict]:
    """Paged decode (#9) at 8B shapes: B = 8 slots at mixed positions over
    bf16, f32 and INT8 pools, and one request at the context's end."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        decode_units,
        paged_decode,
        paged_decode_kernel_plan,
        paged_decode_phases,
        paged_decode_plain,
        split_grid,
    )
    from qwen3_rs_tpu_torch.testing import paged_read_bytes

    gen = torch.Generator(device=DEV)
    gen.manual_seed(9753)
    mixed = [0, 1, 127, 128, 129, 1000, 2049, 4095]
    out = []
    for pool, pos_list in (("bf16", mixed), ("f32", mixed), ("int8", mixed), ("bf16", [4095])):
        c, nl, k, v, sc, table, pos, esz = _paged_inputs(torch, gen, pool, pos_list)
        b, h, n_kv, hd = len(pos_list), c.n_heads, c.n_kv_heads, c.head_dim
        kv_mul = h // n_kv
        q = torch.randn(b, h, hd, generator=gen, device=DEV)
        kn, vn = (torch.randn(b, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
        ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
        got = paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())  # f32 throughout; only the summation order differs
        need(math.isfinite(err) and err <= tol, f"paged_decode {pool} pos={pos_list}: max_abs_err {err} > tol {tol}")
        if pos_list[0] == 0:  # only the self key: the output is v_self, exactly
            need(torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0)), "paged_decode pos=0 != v_self")
        # The plan the kernel's blocks made from the positions, read back, against decode_units.
        grid = split_grid(q.device, k.dtype, hd, b, n_kv, kv_mul)
        plan = paged_decode_kernel_plan(pos, n_kv, kv_mul, 128, table.shape[1], grid)
        need(plan == decode_units(pos_list, n_kv, kv_mul, 128, table.shape[1], grid),
             f"paged_decode {pool} pos={pos_list}: the kernel's plan differs from decode_units")
        ms = device_ms(torch, lambda i: paged_decode(q, kn, vn, k, v, table, pos, i % nl, **sc))
        if pool != "f32":
            emit({"phase": "kernels", "paged_decode_phases_us": paged_decode_phases(q, kn, vn, k, v, table, pos, 1, **sc),
                  "case": f"{pool} pool B={b} pos={pos_list}", "grid": grid, "units": len(plan)})
        prof = profile_calls(torch, lambda i: paged_decode(q, kn, vn, k, v, table, pos, i % nl, **sc), 10)
        emit({"phase": "kernels", "profile": "paged_decode", "case": f"{pool} pool B={b} pos={pos_list}",
              "launches_per_call": prof.get("device_ops_per_step"),
              "kernels": [{k2: t[k2] for k2 in ("kernel", "ms_per_step", "calls_per_step")} for t in prof.get("top", [])]})
        plain_ms = device_ms(torch, lambda i: paged_decode_plain(q, kn, vn, k, v, table, pos, i % nl, **sc),
                             reps=10, warmup=1)
        # Library yardstick: SDPA over [self; rows < pos], the rows gathered
        # into dense f32 beforehand, a position mask.
        lib = []
        for l in range(min(nl, 2)):
            kc, vc = _gathered(torch, k, v, sc, table, pos_list, l)
            kk, vv = torch.cat([kn[:, :, None], kc], 2), torch.cat([vn[:, :, None], vc], 2)
            mask = (torch.arange(kk.shape[2], device=DEV)[None, :] <= pos[:, None].long())[:, None, None, :]
            lib.append((kk, vv, mask))
        q4 = q[:, :, None]
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, lib[i % len(lib)][0], lib[i % len(lib)][1], attn_mask=lib[i % len(lib)][2], enable_gqa=True))
        del lib
        nbytes = (paged_read_bytes(pos_list, n_kv, hd, esz) + (2 * q.numel() + kn.numel() + vn.numel()) * 4
                  + table.numel() * 4 + b * 4)
        b_ms, b_by = bound(nbytes, 4.0 * h * sum(p + 1 for p in pos_list) * hd, "f32")
        out.append(_row(
            ctx, "paged_decode", f"{pool} pool B={b} pos={pos_list}", paged_decode_source(hd, 128),
            "qwen3_rs_tpu/ops/pallas/paged_attention.py:207 paged_gqa_decode_stacked",
            {"B": b, "heads": h, "kv_heads": n_kv, "hd": hd, "page": 128, "pos": pos_list}, err, tol, ms, plain_ms,
            nbytes, b_ms, b_by, lib_ms, "F.scaled_dot_product_attention enable_gqa, K/V gathered into dense f32 beforehand",
        ))
        del k, v, sc, ref, got
        torch.cuda.empty_cache()
    return out


def paged_window_source(hd: int, page: int, dtype) -> str:
    """The source of the kernel ``paged_window_partials`` launches at this
    head_dim, page size and pool type."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import window_split_takes

    return f"qwen3_rs_tpu_torch/csrc/{'paged_decode' if window_split_takes(hd, page, dtype) else 'paged_attention'}.cu"


def paged_window_cases(torch, ctx, plan: bool = True, hd: int | None = None,
                       cases=(("bf16", 32), ("int8", 32), ("bf16", 4), ("int8", 4), ("f32", 32), ("f32", 4)),
                       source: bool | None = None) -> list[dict]:
    """Paged window partials (#10) at 8B shapes: S = 32 (R = 128 query rows
    per kv head) and S = 4 at mixed positions, 0 included, over bf16, INT8
    and f32 pools (or ``cases``, at head_dim ``hd`` with the 8B's heads); with
    ``plan`` (this tree's entry points) the plan the
    window kernel's blocks make, read back against ``window_units``, and
    each row's source (``source``: the source alone, named by
    ``window_split_takes``, which trees with the one-launch window kernel
    have).  The products' bound: bf16 and INT8 pools at 989
    TFLOP/s once; an f32 pool at the rate of the unit its kernel runs them
    on, times their terms (``window_split_takes``: the tensor cores, three
    bf16 terms; else the CUDA cores at 67 TFLOP/s, once)."""
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa
    from qwen3_rs_tpu_torch.testing import paged_read_bytes

    paged_window_partials, paged_window_partials_plain = pa.paged_window_partials, pa.paged_window_partials_plain

    gen = torch.Generator(device=DEV)
    gen.manual_seed(8642)
    pos_list = [0, 1, 127, 128, 512, 1000, 2049, 4064]
    out = []
    for pool, s in cases:
        c, nl, k, v, sc, table, pos, esz = _paged_inputs(torch, gen, pool, pos_list, head_dim=hd)
        b, h, n_kv, hd = len(pos_list), c.n_heads, c.n_kv_heads, k.shape[-1]
        r = s * (h // n_kv)
        q = torch.randn(b, s, h, hd, generator=gen, device=DEV)
        ref = paged_window_partials_plain(q, k, v, table, pos, 1, **sc)
        got = paged_window_partials(q, k, v, table, pos, 1, **sc)
        torch.cuda.synchronize()
        err, tol, worst = 0.0, 0.0, 0.0
        for a, e in zip(got, ref):
            need(a.shape == e.shape and torch.equal(torch.isneginf(a), torch.isneginf(e)),
                 f"paged_window_partials {pool} S={s}: shapes or -inf entries differ")
            fin = torch.isfinite(e)
            one_err = float((a[fin] - e[fin]).abs().max())
            t = 1e-4 * float(e[fin].abs().max())
            need(one_err <= t, f"paged_window_partials {pool} S={s}: off by more than {t}")
            err, tol, worst = max(err, one_err), max(tol, t), max(worst, one_err / t if t else 0.0)
        if pool == "f32":  # the control: the plain window over the pool rounded to bf16 must miss the tolerance
            one = [p[1:2].to(torch.bfloat16).float() for p in (k, v)]
            ctl = paged_window_partials_plain(q, *one, table, pos, 0)
            ratio = max(float((a[fin] - e[fin]).abs().max()) / (1e-4 * float(e[fin].abs().max()))
                        for a, e in zip(ctl, ref) for fin in [torch.isfinite(e)])
            need(ratio > 1.0, f"paged_window_partials {pool} S={s}: the tolerance passes a bf16-rounded pool")
            emit({"phase": "kernels", "paged_window_bf16_control": f"{pool} pool B={b} S={s} (R={r})",
                  "bf16_pool_err_over_tol": ratio, "kernel_err_over_tol": worst})
            del one, ctl
        if plan:  # the plan the window kernel's blocks made from the positions, against window_units
            grid = pa.window_split_grid(q.device, k.dtype, hd, b, n_kv, r)
            units = pa.paged_window_kernel_plan(pos, n_kv, r, 128, table.shape[1], grid, hd)
            need(units == pa.window_units(pos_list, n_kv, r, 128, table.shape[1], grid, hd),
                 f"paged_window_partials {pool} S={s}: the kernel's plan differs from window_units")
            emit({"phase": "kernels", "paged_window_plan": f"{pool} pool B={b} S={s} (R={r})", "grid": grid,
                  "units": len(units), "paged_window_phases_us": pa.paged_window_phases(q, k, v, table, pos, 1, **sc)})
        ms = device_ms(torch, lambda i: paged_window_partials(q, k, v, table, pos, i % nl, **sc))
        plain_ms = device_ms(torch, lambda i: paged_window_partials_plain(q, k, v, table, pos, i % nl, **sc),
                             reps=10, warmup=1)
        lib = []
        for l in range(min(nl, 2)):
            kc, vc = _gathered(torch, k, v, sc, table, pos_list, l)
            mask = (torch.arange(kc.shape[2], device=DEV)[None, :] < pos[:, None].long())[:, None, None, :]
            lib.append((kc, vc, mask))
        qt = q.transpose(1, 2)
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, lib[i % len(lib)][0], lib[i % len(lib)][1], attn_mask=lib[i % len(lib)][2], enable_gqa=True))
        del lib
        nbytes = (paged_read_bytes(pos_list, n_kv, hd, esz) + q.numel() * 4 + b * n_kv * r * (hd + 2) * 4
                  + table.numel() * 4 + b * 4)
        ops = 4.0 * h * s * sum(pos_list) * hd
        if pool != "f32":
            b_ms, b_by = bound(nbytes, ops, "bf16")  # the products on the tensor cores
        elif pa.window_split_takes(hd, 128, k.dtype):
            b_ms, b_by = bound(nbytes, 3 * ops, "bf16")  # three bf16 terms on the tensor cores
        else:
            b_ms, b_by = bound(nbytes, ops, "f32")  # the two-pass kernels' CUDA cores
        out.append(_row(
            ctx, "paged_window_partials", (f"head_dim {hd}, {h}/{n_kv} heads, " if hd != 128 else "")
            + f"{pool} pool B={b} S={s} (R={r})",
            paged_window_source(hd, 128, k.dtype) if (plan if source is None else source) else None,
            "qwen3_rs_tpu/ops/pallas/paged_attention.py:437 paged_gqa_window_stacked (_partials_kernel :287)",
            {"B": b, "S": s, "R": r, "heads": h, "kv_heads": n_kv, "hd": hd, "page": 128, "pos": pos_list},
            err, tol, ms, plain_ms, nbytes, b_ms, b_by, lib_ms,
            "F.scaled_dot_product_attention enable_gqa on the cache rows, gathered into dense f32 beforehand",
        ))
        del k, v, sc, ref, got
        torch.cuda.empty_cache()
    return out


# The decode megakernel against its plain version.  Both round the same
# activations to bf16; an f32 sum in another order now and then flips one of
# those roundings.  Over one layer that moves a row of the stream by < 5e-3 of
# its largest value and the logits by < 1e-2 of theirs (tests/test_torch_
# megakernel.py argues the same bounds), and an INT8 row by one code.  At full
# depth each flip is carried through the later layers of random weights, where
# one activation moved by one or two bf16 steps moves the final stream by about
# 2e-2 of its largest value (each case reports it as "sensitivity": the plain
# version with one norm weight of layer 0 scaled by 1 + 2^-7): the stream and
# the logits are held within MK_TOL_DEEP there.  An error of the algorithm (a layer's weights,
# a residual, a norm, RoPE, a cache row attended or not) moves them by O(1).
MK_TOL_X, MK_TOL_LOGITS, MK_TOL_DEEP = 5e-3, 1e-2, 5e-2


def megakernel_cases(torch, ctx, q4: bool = False) -> list[dict]:
    """The decode megakernel (#11) at Qwen3-8B width, INT8-g64 (the e2e
    phase's weights, bf16 scales): B = 1 over an f32 cache at positions 200
    and 4095, over an INT8 cache, B = 8 over a bf16 cache at mixed positions
    with one slot's write gate off, and the greedy head.  Each case runs over
    the first layer alone and at full depth (timed), against the plain
    version; the cache outside the rows written stays as it was, bit for
    bit.  ``q4``: its Q4 tiles, on the INT4-g64 layers of ``model_8b_q4`` (the
    classifier INT8), at 200 (f32), 2049 (INT8), the B = 8 case and the
    greedy head.  Beside each case: one more launch with stamps, read into
    the phase breakdown (``phases_us``), the share of the launch the mean
    block waits at barriers (``barrier_wait_share``) and the barriers a
    step (ptxas' registers and spills are the build phase's line for its
    source)."""
    import dataclasses

    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales
    from qwen3_rs_tpu_torch.ops.kernels.megakernel import (
        barrier_wait_share,
        barriers_per_step,
        decode_stack_megakernel,
        decode_stack_megakernel_plain,
        launch_grid,
        phase_breakdown,
        phase_names,
        split_plans,
    )
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor, dequantize
    from qwen3_rs_tpu_torch.ops.rope import rope_table
    from qwen3_rs_tpu_torch.testing import megakernel_bytes

    cfg, weights, _ = model_8b(torch, ctx)
    if q4:
        weights = model_8b_q4(torch, ctx)
    w = cast_weight_scales(weights)
    lw = w.layers
    n_l, n_kv, hd, t = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    v_pad = w.lm_head.q.shape[-1]
    cos_t, sin_t = rope_table(t, hd, cfg.rope_theta, torch.device(DEV, 0))
    mixed = ("bf16", [0, 1, 127, 128, 1000, 2049, 3000, t - 1], [1, 1, 1, 0, 1, 1, 1, 1], False)
    specs = [("f32", [200], [1], False), ("f32", [t - 1], [1], False), ("int8", [2049], [1], False), mixed,
             ("f32", [200], [1], True)]
    if q4:
        specs = [specs[0], specs[2], mixed, specs[4]]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(97531)
    params = sum(n * d for n, d in ((cfg.dim, cfg.all_heads_dim + 2 * cfg.kv_dim), (cfg.all_heads_dim, cfg.dim),
                                    (cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim))) * n_l
    out = []
    for cache, pos_list, ok_list, greedy in specs:
        b = len(pos_list)
        shape = (n_l, b, n_kv, t, hd)
        esz = {"f32": 4, "bf16": 2, "int8": 1}[cache]
        if cache == "int8":
            kv = [torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8) for _ in range(2)]
            sc = [torch.rand(shape[:-1], generator=gen, device=DEV) * 0.02 + 0.005 for _ in range(2)]
        else:
            dt = torch.float32 if cache == "f32" else torch.bfloat16
            kv = [torch.randn(shape, generator=gen, device=DEV).to(dt) for _ in range(2)]
            sc = [None, None]
        tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=DEV)
        x = dequantize(QuantizedTensor(w.embed.q[tokens], w.embed.scales[tokens])).to(torch.bfloat16).float()
        pos = torch.tensor(pos_list, dtype=torch.int32, device=DEV)
        ok = torch.tensor(ok_list, dtype=torch.int32, device=DEV)
        rows = pos.long().clamp(max=t - 1)
        bi = torch.arange(b, device=DEV)
        written = ok.bool()
        label = f"megakernel {cache} pos={pos_list}"

        def run(fn, state, depth, greedy_=greedy, rms_att=lw.rms_att, **kw):
            c = cfg if depth == n_l else dataclasses.replace(cfg, n_layers=depth)
            mats = [type(m)(m.q[:depth], m.scales[:depth]) for m in (lw.wqkv, lw.wo, lw.w13, lw.w2)]
            return fn(c, x, rms_att[:depth], lw.rms_ffn[:depth], lw.q_norm[:depth], lw.k_norm[:depth], cos_t[rows],
                      sin_t[rows], *mats, state[0], state[1], pos, w.rms_final, w.lm_head, ok, k_scale=state[2],
                      v_scale=state[3], eps=cfg.norm_eps, greedy=greedy_, **kw)

        def state(depth):
            return [None if a is None else a[:depth].clone() for a in kv + sc]

        def rel(a, b_):
            return float((a.float() - b_.float()).abs().max()) / float(b_.float().abs().max())

        def compare(depth, tol_x, tol_logits):
            """Kernel against plain over ``depth`` layers: (logits max abs
            error, its tolerance, the kernel's state)."""
            got, ref = state(depth), state(depth)
            gx, ghead = run(decode_stack_megakernel, got, depth)
            px, phead = run(decode_stack_megakernel_plain, ref, depth)
            torch.cuda.synchronize()
            for r in range(b):
                need(rel(gx[r], px[r]) <= tol_x, f"{label} depth {depth}: stream row {r} off by {rel(gx[r], px[r])}")
            if greedy:
                # The fused greedy token is the first maximum of the kernel's
                # own logits, and a maximum of the plain logits within their
                # tolerance.
                _, glog = run(decode_stack_megakernel, state(depth), depth, False)
                _, plog = run(decode_stack_megakernel_plain, state(depth), depth, False)
                want = glog[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
                need(torch.equal(ghead, want), f"{label}: greedy {ghead.tolist()} != first max {want.tolist()}")
                gap = float(plog[0, : cfg.vocab_size].max() - plog[0, int(ghead[0])])
                need(gap <= tol_logits * float(plog.abs().max()), f"{label}: greedy token {gap} below the plain max")
                ghead, phead = glog, plog
            tol = tol_logits * float(phead.abs().max())
            err = float((ghead - phead).abs().max())
            need(math.isfinite(err) and err <= tol, f"{label} depth {depth}: logits max_abs_err {err} > tol {tol}")
            for i in range(2):
                # The first layer's rows written depend on the input alone.
                new_g, new_p = got[i][0, bi, :, rows], ref[i][0, bi, :, rows]
                lim = 1 if cache == "int8" else MK_TOL_X * float(new_p.float().abs().max())
                need(float((new_g.float() - new_p.float()).abs().max()) <= lim, f"{label}: layer 0 rows written off")
                if depth > 1:  # the later layers' rows carry the stream's error
                    deq = [s_[i][:, bi, :, rows] * (s_[2 + i][:, bi, :, rows, None] if sc[i] is not None else 1)
                           for s_ in (got, ref)]
                    need(rel(deq[0], deq[1]) <= tol_x, f"{label} depth {depth}: rows written off by {rel(*deq)}")
                # Everything but the rows written is left as it was (the
                # gated-off slot's row too).
                for part in (i, 2 + i) if sc[i] is not None else (i,):
                    base = (kv + sc)[part][:depth]
                    got[part][:, bi[written], :, rows[written]] = base[:, bi[written], :, rows[written]]
                    need(torch.equal(got[part], base), f"{label}: the cache changed outside the rows written")
            return err, tol, got

        err1, tol1, _ = compare(1, MK_TOL_X, MK_TOL_LOGITS)
        err, tol, got_state = compare(n_l, MK_TOL_DEEP, MK_TOL_DEEP)
        # The plain version's own sensitivity: one norm weight of layer 0
        # scaled by 1 + 2^-7.
        rms_moved = lw.rms_att.clone()
        rms_moved[0, 7] *= 1 + 2.0**-7
        sx = [run(decode_stack_megakernel_plain, state(n_l), n_l, False, ra)[0] for ra in (lw.rms_att, rms_moved)]
        sensitivity = max(rel(sx[1][r], sx[0][r]) for r in range(b))
        del sx
        ms = device_ms(torch, lambda i: run(decode_stack_megakernel, got_state, n_l))
        # The phase breakdown: one more launch (warm), each block stamping the
        # device clock as it finishes each phase and leaves the barrier after it.
        names = phase_names(n_l, True, greedy)
        stamps = torch.zeros(launch_grid(cfg.group_size, q4), len(names) + 1, 2, dtype=torch.int64, device=DEV)
        run(decode_stack_megakernel, got_state, n_l, stamps=stamps)
        torch.cuda.synchronize()
        breakdown = phase_breakdown(stamps, names)
        wait_share = barrier_wait_share(stamps, names)
        span_us = float((stamps[:, -1, 0].max() - stamps[:, 0, 0].min()).item()) / 1e3
        emit({"phase": "kernels", "megakernel_breakdown": case_label(cache, b, pos_list, ok_list, greedy),
              "layer_bits": 4 if q4 else 8, "stamped_launch_us": span_us,
              "barriers_per_step": barriers_per_step(n_l, True, greedy), "barrier_wait_share": wait_share,
              "phases_us": breakdown})
        del stamps
        plain_ms = device_ms(torch, lambda i: run(decode_stack_megakernel_plain, got_state, n_l), reps=3, warmup=1)
        nbytes = megakernel_bytes(cfg, pos_list, esz, written=sum(ok_list), v_pad=v_pad, bits=4 if q4 else 8)
        ops = 2.0 * b * (params + cfg.dim * v_pad) + 4.0 * hd * cfg.n_heads * n_l * sum(min(p, t) + 1 for p in pos_list)
        b_ms, b_by = bound(nbytes, ops, "bf16")
        case = case_label(cache, b, pos_list, ok_list, greedy)
        replaces = ("qwen3_rs_tpu/ops/pallas/megakernel.py:528-540 and :711-716 (Q4 tiles of "
                    "decode_stack_megakernel :1110; gate :229-241)" if q4 else
                    "qwen3_rs_tpu/ops/pallas/megakernel.py:1110 decode_stack_megakernel (pallas_call :1441)")
        row = _row(ctx, "decode_megakernel_q4" if q4 else "decode_megakernel", case,
                   "qwen3_rs_tpu_torch/csrc/decode_megakernel.cu", replaces,
                   {"B": b, "layers": n_l, "dim": cfg.dim, "T": t, "pos": pos_list, "v_pad": v_pad,
                    "layer_bits": 4 if q4 else 8,
                    "splits": split_plans(cfg, b, launch_grid(cfg.group_size, q4), v_pad, q4), "depth1_max_abs_err": err1,
                    "depth1_tol": tol1, "sensitivity": sensitivity,
                    "barriers_per_step": barriers_per_step(n_l, True, greedy), "barrier_wait_share": wait_share,
                    "phases_us": breakdown},
                   err, tol, ms, plain_ms, nbytes, b_ms, b_by, None,
                   "none: no one PyTorch call computes a whole decode step")
        out.append(row)
        del kv, sc, got_state
        torch.cuda.empty_cache()
    return out


def case_label(cache, b, pos_list, ok_list, greedy) -> str:
    return f"{cache} cache B={b} pos={pos_list}" + (f" write_ok={ok_list}" if 0 in ok_list else "") + (
        " greedy" if greedy else "")


def megakernel_q4_kernel_cases(torch, ctx) -> list[dict]:
    """#11's Q4 tiles, with the reference's opt-in set for the gate's sake
    (the wrapper itself takes INT4 layers whatever the variable says)."""
    with q4_megakernel_opt_in():
        return megakernel_cases(torch, ctx, q4=True)


@contextlib.contextmanager
def q4_megakernel_opt_in(on: bool = True):
    """``QWEN3_TPU_MEGA_Q4`` set to 1 (or 0) for the block, then restored."""
    import os

    old = os.environ.get("QWEN3_TPU_MEGA_Q4")
    os.environ["QWEN3_TPU_MEGA_Q4"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["QWEN3_TPU_MEGA_Q4"]
        else:
            os.environ["QWEN3_TPU_MEGA_Q4"] = old


def _kernel_ms(prof: dict) -> dict:
    """A ``profile_calls`` result as device ms a call by kernel name (the
    name up to its template arguments)."""
    out: dict = {}
    for t in prof.get("top", []):
        name = t["kernel"].replace("(anonymous namespace)::", "").replace("void ", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1].strip()
        out[name] = out.get(name, 0.0) + t["ms_per_step"]
    return out


def one_row_breakdown(torch, ctx) -> dict:
    """#1-#3 at one activation row (INT8 and INT4, the four 8B projections as
    qwen3_forward calls them, ``wo`` alone and the INT8 classifier) through
    the wrapper's route and the mma kernel on the same inputs: each held to
    the plain version, its CUDA-event time and its device time by kernel
    (torch.profiler over 10 calls)."""
    from qwen3_rs_tpu_torch.ops.kernels import qmatmul as qm
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.testing import padded_vocab, qwen3_config

    c = qwen3_config("8b")
    g = c.group_size
    ah, kvd, dim, hid = c.all_heads_dim, c.kv_dim, c.dim, c.hidden_dim
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [("wqkv+rms", dim, ah + 2 * kvd, "rms", False, bf16), ("wo+residual", ah, dim, None, True, f32),
             ("w13+rms", dim, 2 * hid, "rms", False, bf16), ("w2+swiglu+residual", hid, dim, "swiglu", True, f32),
             ("wo stacked", ah, dim, None, False, f32), ("lm_head", dim, padded_vocab(c.vocab_size), None, False, bf16)]
    launchers = {"wrapper": qm.qmatmul_w8a16, "mma": qm.qmatmul_w8a16_mma}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1313)
    out: dict = {}
    for bits in (8, 4):
        for proj, n, d, prologue, has_res, xdt in specs:
            if bits == 4 and proj == "lm_head":
                continue  # the INT4 checkpoints keep an INT8 classifier
            wbytes = _q4_bytes(n, d, g) if bits == 4 else n * d + (n // g) * d * 2
            stacked = proj != "lm_head"
            nl = _layers_for(wbytes) if stacked else 1
            if bits == 4:
                w = _q4_stacked(torch, gen, nl, n, d, g, bf16)
            else:
                shape = (nl, n, d) if stacked else (n, d)
                w = QuantizedTensor(torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8),
                                    (torch.rand((*shape[:-2], n // g, d), generator=gen, device=DEV) * 0.02).to(bf16))
            layer = (lambda i: i % nl) if stacked else (lambda i: None)
            x = torch.randn(1, 2 * n if prologue == "swiglu" else n, generator=gen, device=DEV).to(xdt)
            kw = {"norm_w": 1.0 + 0.02 * torch.randn(nl, n, generator=gen, device=DEV) if prologue == "rms" else None,
                  "swiglu": prologue == "swiglu",
                  "residual": torch.randn(1, d, generator=gen, device=DEV).to(bf16) if has_res else None}
            ref = qm.qmatmul_w8a16_plain(x, w, layer(1), **kw)
            tol = (2e-3 if prologue else 1e-4) * float(ref.abs().max())
            case = {}
            for rt, launch in launchers.items():
                got = launch(x, w, layer(1), **kw)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                need(math.isfinite(err) and err <= tol, f"one row {rt} {proj} bits={bits}: {err} > {tol}")
                prof = profile_calls(torch, lambda i: launch(x, w, layer(i), **kw), 10)
                case[rt] = {"ms": device_ms(torch, lambda i: launch(x, w, layer(i), **kw)), "max_abs_err": err,
                            "device_ms_by_kernel": _kernel_ms(prof),
                            "device_ops_per_call": prof.get("device_ops_per_step")}
            out[f"{proj} bits={bits}"] = case
            emit({"phase": "decode", "one_row": f"{proj} bits={bits}", "tol": tol, "N": n, "D": d, **case})
            del w, x, kw, ref
            torch.cuda.empty_cache()
    for bits in (8, 4):
        four = {rt: sum(out[f"{p} bits={bits}"][rt]["ms"] for p, *_ in specs[:4]) for rt in launchers}
        out[f"four projections bits={bits}"] = four
        emit({"phase": "decode", "one_row_four_projections_ms": four, "bits": bits})
    return out


def dense_decode_breakdown(torch, ctx) -> dict:
    """#4 at B=1 over the 8B dense layer (T = 4096, 32/8 heads, head_dim 128)
    on the same inputs through ``flash_decode`` (the wrapper's route) and
    ``paged_decode`` over the layer viewed as B pages of T rows with the
    table ``arange(B)[:, None]``, each held to ``flash_decode_plain`` (its
    error recorded against 1e-5) and timed, with the latter's phase stamps."""
    from qwen3_rs_tpu_torch.ops.kernels import flash_attention as fa
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import paged_decode, paged_decode_phases
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    t_max, n_kv, h, hd = 4096, c.n_kv_heads, c.n_heads, c.head_dim
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4444)
    out = {}
    for cache, p in (("f32", 0), ("f32", 257), ("f32", t_max - 1), ("bf16", 2049), ("int8", 2049)):
        esz = {"f32": 4, "bf16": 2, "int8": 1}[cache]
        nl = _layers_for(2 * n_kv * t_max * hd * esz)
        k_all, v_all, sc = _dense_cache(torch, gen, cache, (nl, 1, n_kv, t_max, hd))
        scp = {"k_scale_pool": sc["k_scale_all"], "v_scale_pool": sc["v_scale_all"]} if sc else {}
        q = torch.randn(1, h, hd, generator=gen, device=DEV)
        kn, vn = (torch.randn(1, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        table = torch.zeros(1, 1, dtype=torch.int32, device=DEV)
        ref = fa.flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
        routes = {"flash_decode": lambda i: fa.flash_decode(q, kn, vn, k_all, v_all, pos, i % nl, **sc),
                  "paged_decode_dense": lambda i: paged_decode(q, kn, vn, k_all, v_all, table, pos, i % nl, **scp)}
        case = {}
        for rt, fn in routes.items():
            got = fn(1)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            need(math.isfinite(err), f"#4 {rt} {cache} pos={p}: not finite")
            prof = profile_calls(torch, fn, 10)
            case[rt] = {"ms": device_ms(torch, fn), "max_abs_err": err, "within_1e-5": err <= 1e-5,
                        "device_ms_by_kernel": _kernel_ms(prof), "device_ops_per_call": prof.get("device_ops_per_step")}
        case["paged_decode_dense_phases_us"] = (
            paged_decode_phases(q, kn, vn, k_all, v_all, table, pos, 1, **scp) if p else None)
        out[f"{cache} pos={p}"] = case
        emit({"phase": "decode", "dense_decode": f"{cache} cache pos={p} T={t_max}", **case})
        del k_all, v_all, sc, scp, ref
        torch.cuda.empty_cache()
    return out


def _dense_cache(torch, gen, cache, shape):
    """A dense cache [L, B, n_kv, T, hd] of random rows and its scales
    (INT8: codes and row scales; f32 and bf16: no scales)."""
    if cache == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8) for _ in range(2))
        return k, v, {n_: torch.rand(shape[:-1], generator=gen, device=DEV) * 0.02 + 0.005
                      for n_ in ("k_scale_all", "v_scale_all")}
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    return (*(torch.randn(shape, generator=gen, device=DEV).to(dt) for _ in range(2)), {})


def one_launch_error_grid(torch, ctx) -> dict:
    """The one-launch decode kernel's largest error against
    ``flash_decode_plain`` over the card tests' grids of #4 (T = 208 at
    kv_mul 1-16 and pos 0/1/127/128/129/T; T = 512, kv_mul 4, head_dim
    128/256, B = 1 and 3), each cache type on the same inputs as its test
    (the tests' seeds and order of draws), through ``paged_decode`` on the
    dense layer viewed as pages, and the error of ``flash_decode`` (the
    wrapper's route: the same kernel since every cache type takes it, the
    two-pass kernel on an older tree's INT8 caches) on the same inputs."""
    from qwen3_rs_tpu_torch.ops.kernels import flash_attention as fa
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import paged_decode

    def gen_of(seed):
        g = torch.Generator(device=DEV)
        g.manual_seed(seed)
        return g

    def errors(q, kn, vn, k_all, v_all, sc, pos):
        b = q.shape[0]
        table = torch.arange(b, dtype=torch.int32, device=DEV)[:, None]
        scp = {"k_scale_pool": sc["k_scale_all"], "v_scale_pool": sc["v_scale_all"]} if sc else {}
        ref = fa.flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
        one = paged_decode(q, kn, vn, k_all, v_all, table, pos, 1, **scp)
        wrapped = fa.flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        return float((one - ref).abs().max()), float((wrapped - ref).abs().max()), float(ref.abs().max())

    worst: dict = {}

    def keep(cache, case, e1, e2, scale):
        w = worst.setdefault(cache, {"one_launch": 0.0, "flash_decode": 0.0, "case": None, "max_abs_ref": 0.0})
        if e1 > w["one_launch"]:
            w.update(one_launch=e1, case=case)
        w["flash_decode"], w["max_abs_ref"] = max(w["flash_decode"], e2), max(w["max_abs_ref"], scale)

    for cache in ("f32", "bf16", "int8"):
        for kv_mul in (1, 2, 3, 4, 5, 6, 8, 16):  # test_flash_decode_one_launch_matches_plain
            t, n_kv, hd = 208, 2, 128
            gen = gen_of(kv_mul * 3 + len(cache) + t)
            pos_list = [0, 1, 127, 128, 129, t]
            b = len(pos_list)
            k_all, v_all, sc = _dense_cache(torch, gen, cache, (2, b, n_kv, t, hd))
            q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=DEV)
            kn, vn = (torch.randn(b, n_kv, hd, generator=gen, device=DEV) for _ in range(2))
            pos = torch.tensor(pos_list, dtype=torch.int32, device=DEV)
            keep(cache, f"T={t} kv_mul={kv_mul}", *errors(q, kn, vn, k_all, v_all, sc, pos))
        for hd in (128, 256):  # test_flash_decode_is_one_launch_where_it_takes_the_split_kernel
            gen = gen_of(hd + len(cache))
            t, n_kv, kv_mul = 512, 2, 4
            for pos_list in ([t - 1], [0, 1, 127], [128, 129, t]):
                b = len(pos_list)
                k_all, v_all, sc = _dense_cache(torch, gen, cache, (2, b, n_kv, t, hd))
                q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=DEV)
                kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=DEV)
                pos = torch.tensor(pos_list, dtype=torch.int32, device=DEV)
                keep(cache, f"T={t} hd={hd} pos={pos_list}", *errors(q, kn, vn, k_all, v_all, sc, pos))
    emit({"phase": "decode", "one_launch_error_grid": worst, "tol": 1e-5})
    return worst


def decode_step_profiles(torch, ctx) -> dict:
    """Device time of one b=1 decode step on the per-layer kernels at 8B full
    depth, as the e2e phase profiles it: INT8 with the megakernel gate
    patched off, and INT4 on the JAX default route (no megakernel)."""
    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    cfg = qwen3_config("8b", seq_len=4096)
    prompt_ids = [(7 * i + 3) % 1000 + 10 for i in range(200)]
    out = {}
    for bits in (8, 4):
        weights = random_weights(cfg, seed=SEED, device=DEV, bits=bits)
        engine = Engine(config=cfg, weights=weights, device=DEV)
        with megakernel_gate_off():
            out[f"int{bits}_per_layer"] = profile_decode(torch, engine, prompt_ids, steps=8)
        emit({"phase": "decode", "step_profile": f"INT{bits} b=1 per layer (megakernel gate off)",
              **out[f"int{bits}_per_layer"]})
        del engine, weights
        torch.cuda.empty_cache()
    return out


def phase_decode(torch, ctx) -> None:
    """The b=1 per-layer decode's kernels alone (``--phases build,decode``),
    through entry points that every tree of the port has, so that this file,
    copied into an older checkout, times that checkout's kernels in the same
    call: #1-#3 at one row and #4 at B=1, #9's kernel-table cases, the
    one-launch decode kernel's error over the card tests' grids, and the
    per-layer steps' device time."""
    ctx["decode"] = {"one_row": one_row_breakdown(torch, ctx), "dense_decode": dense_decode_breakdown(torch, ctx),
                     "paged_decode": paged_decode_cases(torch, ctx), "error_grid": one_launch_error_grid(torch, ctx),
                     "step_profiles": decode_step_profiles(torch, ctx)}


def phase_window(torch, ctx) -> None:
    """#10 and #4's INT8 row alone (``--phases build,window``), through
    entry points that every tree of the port has, so that this file, copied
    into an older checkout, times that checkout's kernels in the same call:
    #10's 8B cases and its head_dim-256 and -640 cases (with #4 and #9's
    there), #4 over an INT8 cache at pos 2049, #9's kernel-table cases (its
    INT8 pool's stage shares #4's), the one-launch decode kernel's error
    over #4's card-test grids, and the prefix-cache path's TTFT and its
    continued windows' device time by part."""
    ctx["window"] = {
        "paged_window": paged_window_cases(torch, ctx, plan=False),
        "paged_decode": paged_decode_cases(torch, ctx),
        "head_dims": (_head_dim_cases(torch, ctx, 256, (), labels=False)
                      + _head_dim_cases(torch, ctx, 640, (), labels=False)),
        "flash_int8": flash_cases(torch, ctx, specs=(("int8", 2049),), phases=False),
        "error_grid": one_launch_error_grid(torch, ctx),
    }
    cfg, weights, _ = model_8b(torch, ctx)
    ctx["window"]["prefix_cache"] = serve_prefix_path(torch, ctx, cfg, weights)
    ctx["window"]["prefix_windows"] = prefix_window_breakdown(torch, ctx, cfg, weights)


def phase_heads(torch, ctx) -> None:
    """The attention kernels' head_dim rows alone (``--phases build,heads``):
    ``head_dim_cases`` through entry points every tree of the port has, so
    that this file, copied into an older checkout, times that checkout's
    kernels at the same cases in the same call."""
    ctx["heads"] = head_dim_cases(torch, ctx)


def phase_kernels(torch, ctx) -> None:
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    ctx["kernel_rows"] = (qmatmul_cases(torch, ctx) + qmatmul_route_cases(torch, ctx)
                          + qmatmul_single_route_cases(torch, ctx) + flash_cases(torch, ctx)
                          + prefill_attention_cases(torch, ctx)
                          + rows_cases(torch, ctx) + dequant_cases(torch, ctx) + a8_cases(torch, ctx)
                          + paged_decode_cases(torch, ctx) + paged_window_cases(torch, ctx)
                          + megakernel_cases(torch, ctx) + qmatmul_q4_cases(torch, ctx) + rows_q4_cases(torch, ctx)
                          + dequant_q4_cases(torch, ctx) + megakernel_q4_kernel_cases(torch, ctx)
                          + rows_cols_cases(torch, ctx) + head_dim_cases(torch, ctx))
    onecall_walk_checks(torch, ctx)
    made = {k for k in LAUNCHES if LAUNCHES[k] != before[k]}
    missed = set(LAUNCHES) - made - set(PROBE_KERNELS)  # the probes phase holds the probe kernels
    need(not missed, f"the kernel cases launched no {sorted(missed)}")


def onecall_walk_checks(torch, ctx) -> None:
    """P1's plan read back: the one-call kernel's record of its first rep's
    units equals the Python mirror (``probes.onecall_walk``) at 8B ``wo`` and
    ``w13``, L = 1 and 8 (checks only; the probes phase times the kernel)."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import (
        _onecall_per_sm, _sm_count, boundary_onecall_walk, onecall_plan, onecall_walk,
    )
    from qwen3_rs_tpu_torch.scripts.boundary_probe import matrices

    gen = torch.Generator(device=DEV)
    gen.manual_seed(8005)
    for mat in ("wo", "w13"):
        n, d = matrices(PROBE_MODEL)[mat]
        for layers in (1, 8):
            w = _stacked_weights(torch, gen, layers, n, d, 64, torch.bfloat16)
            x = torch.randn(1, n, generator=gen, device=DEV)
            _, walk = boundary_onecall_walk(x, w)
            plan = onecall_plan(n, d, 64, layers, _sm_count(0), _onecall_per_sm(0, True))
            want = torch.tensor(onecall_walk(n, d, layers, *plan), dtype=torch.int32)
            need(torch.equal(walk.cpu(), want), f"boundary_onecall {mat} L={layers}: the walk is not the plan {plan}")
            emit({"phase": "kernels", "check": "onecall_walk", "mat": mat, "L": layers,
                  "splits_spb_grid": list(plan), "units": int(want.shape[0])})
            del w, x


# --------------------------------------------------------------------- probes
PROBE_KERNELS = ("boundary_onecall", "hbm_stream", "head_a8", "a8_depth")
PROBE_MODEL = "8b"  # the boundary probe's matrices
PROBE_STREAM_GB = 4.0
PROBE_HEAD = (4096, 1536)  # TN, TD
PROBE_DEPTH = (2048, 4096, 24576)  # rows, N, D


def phase_probes(torch, ctx) -> None:
    """The four measurement probes through their entry points
    (``qwen3_rs_tpu_torch.scripts.<probe>.run``), the probes' path: the
    boundary probe at 8B ``wo`` and ``w13`` (L=8; eager, graph and one-call
    arms), the stream over 4 GB at blocks of 0.5-4 MB, the head's compute
    path at B=8 and B=1, the depth probe at 2048x4096x24576.  The probe
    kernels' launch counts are reset just before and read just after.  Then
    each probe kernel against its plain version on the card at those shapes
    (these launches are not counted), with its time, the plain version's, a
    library call's where one computes the same function, and its bound."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_rs_tpu_torch.scripts import a8_depth_probe, boundary_probe, hbm_stream_bench, head_a8_probe

    t0 = time.perf_counter()
    for k in PROBE_KERNELS:
        LAUNCHES[k] = 0  # this path's run starts here
    runs = {"boundary": [boundary_probe.run(PROBE_MODEL, mat) for mat in ("wo", "w13")]}
    torch.cuda.empty_cache()
    runs["stream"] = hbm_stream_bench.run(PROBE_STREAM_GB, (0.5, 1.0, 2.0, 4.0))
    torch.cuda.empty_cache()
    stream_gbps = runs["stream"]["best_gb_per_s"]
    runs["head"] = [head_a8_probe.run(b, *PROBE_HEAD, stream_gb_per_s=stream_gbps) for b in (8, 1)]
    runs["depth"] = a8_depth_probe.run(*PROBE_DEPTH)
    torch.cuda.synchronize()
    ctx["path_launches"]["probes"] = {k: LAUNCHES[k] for k in PROBE_KERNELS}  # and ends here
    need(all(LAUNCHES[k] > 0 for k in PROBE_KERNELS), f"probes: launches {ctx['path_launches']['probes']}")
    for name, found in runs.items():
        for one in found if isinstance(found, list) else [found]:
            emit({"phase": "probes", "run": name, **{k: v for k, v in one.items() if k != "card"}})
    depth_ms = {v: r["ms"] for v, r in runs["depth"]["variants"].items()}
    ctx["probes"] = {
        "boundary_ms_per_layer": {r["mat"]: {a: r["arms"][a]["ms_per_layer"] for a in r["arms"]}
                                  for r in runs["boundary"]},
        # The price of a launch boundary a layer: each per-call arm less the one-call arm.
        "boundary_price_ms_per_layer": {
            r["mat"]: {a: r["arms"][a]["ms_per_layer"] - r["arms"]["onecall"]["ms_per_layer"]
                       for a in ("percall-eager", "percall-graph")} for r in runs["boundary"]},
        # The W8A8-g64 answer: bf16-full's time over i8-seg64's (above 1, the flushed int8 wins).
        "depth_seg64_speedup_over_bf16": depth_ms["bf16-full"] / depth_ms["i8-seg64"],
        "stream_best_gb_per_s": stream_gbps, "stream_best_share_of_peak": runs["stream"]["best_share_of_peak"],
        "stream_library_gb_per_s": runs["stream"]["library_gb_per_s"], "copy_gb_per_s": ctx["copy_gbps"],
        "head_us_per_tile": {f"B={r['B']}": {v: r["variants"][v]["us_per_tile"] for v in r["variants"]}
                             for r in runs["head"]},
        "head_hbm_us_per_tile": runs["head"][0]["hbm_us_per_tile"],
        "depth_tf_per_s": {v: r["tf_per_s"] for v, r in {**runs["depth"]["variants"],
                                                          **runs["depth"]["library"]}.items()},
        "seconds": time.perf_counter() - t0,
    }
    ctx["probes"]["head_us_per_tile_by_timer"] = head_a8_slopes(torch)
    emit({"phase": "probes", "head_us_per_tile_by_timer": ctx["probes"]["head_us_per_tile_by_timer"]})
    rows = boundary_rows(torch, ctx) + stream_rows(torch, ctx) + head_a8_rows(torch, ctx) + a8_depth_rows(torch, ctx)
    ctx.setdefault("kernel_rows", []).extend(rows)


def boundary_rows(torch, ctx) -> list[dict]:
    """P1 at 8B ``wo`` and ``w13``, L=8 layers streamed once (reps=1), against
    its plain version and against #2's launches (1e-4 of the largest value);
    library: one batched bf16 matmul on the layers dequantized beforehand."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import boundary_onecall, boundary_onecall_plain
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16
    from qwen3_rs_tpu_torch.ops.matmul import dequant_weights
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
    from qwen3_rs_tpu_torch.scripts.boundary_probe import LAYERS, matrices

    gen = torch.Generator(device=DEV)
    gen.manual_seed(8001)
    out = []
    for mat in ("wo", "w13"):
        n, d = matrices(PROBE_MODEL)[mat]
        g = 64
        w = _stacked_weights(torch, gen, LAYERS, n, d, g, torch.bfloat16)
        x = torch.randn(1, n, generator=gen, device=DEV)
        got = boundary_onecall(x, w, 1)
        ref = boundary_onecall_plain(x, w)
        kern = torch.cat([qmatmul_w8a16(x, w, l) for l in range(LAYERS)])
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
        need(math.isfinite(err) and err <= tol, f"boundary_onecall {mat}: {err} > {tol}")
        need(float((got - kern).abs().max()) <= tol, f"boundary_onecall {mat}: off #2 by more than {tol}")
        ms = device_ms(torch, lambda i: boundary_onecall(x, w, 1))
        plain_ms = device_ms(torch, lambda i: boundary_onecall_plain(x, w), reps=5, warmup=1)
        dense = torch.stack([dequant_weights(QuantizedTensor(w.q[l], w.scales[l])) for l in range(LAYERS)])
        xb = x.to(torch.bfloat16)
        lib_ms = device_ms(torch, lambda i: torch.matmul(xb, dense))
        del dense
        nbytes = LAYERS * (n * d + (n // g) * d * 2) + n * 4 + LAYERS * d * 4
        b_ms, b_by = bound(nbytes, 2.0 * LAYERS * n * d, "bf16")
        out.append(_row(ctx, "boundary_onecall", f"{PROBE_MODEL} {mat}, L={LAYERS} layers in one launch",
                        "qwen3_rs_tpu_torch/csrc/boundary_probe.cu", "scripts/boundary_probe.py:98 onecall",
                        {"L": LAYERS, "N": n, "D": d, "g": g, "reps": 1}, err, tol, ms, plain_ms, nbytes, b_ms, b_by,
                        lib_ms, "torch.matmul bf16 [1, N] x [L, N, D], layers dequantized beforehand"))
        del w, x, got, ref, kern
        torch.cuda.empty_cache()
    return out


def stream_rows(torch, ctx) -> list[dict]:
    """P2 over the 4 GB array at each block size, bit for bit against the
    plain version; the plain version is the library call itself."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import hbm_stream, hbm_stream_plain
    from qwen3_rs_tpu_torch.scripts.hbm_stream_bench import LANES, geometry

    shapes = {mb: geometry(PROBE_STREAM_GB, mb) for mb in (0.5, 1.0, 2.0, 4.0)}
    n_max = max(arr_rows for _, _, arr_rows in shapes.values()) * LANES
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8002)
    x = torch.empty(n_max, dtype=torch.int8, device=DEV).random_(-128, 128, generator=gen)
    out = []
    for mb, (rows, n_blocks, arr_rows) in shapes.items():
        view = x[: arr_rows * LANES]
        span = rows * LANES
        got, ref = hbm_stream(view, span), hbm_stream_plain(view, span)
        need(torch.equal(got, ref), f"hbm_stream block={mb} MB: {int(got)} != {int(ref)}")
        ms = device_ms(torch, lambda i: hbm_stream(view, span), reps=10)
        plain_ms = device_ms(torch, lambda i: hbm_stream_plain(view, span), reps=10)
        b_ms, b_by = bound(view.numel() + 8, 0.0, "int8")
        out.append(_row(ctx, "hbm_stream", f"{PROBE_STREAM_GB} GB, blocks of {mb} MB", "qwen3_rs_tpu_torch/csrc/hbm_stream_bench.cu",
                        "scripts/hbm_stream_bench.py:57", {"bytes": view.numel(), "span": span, "blocks": n_blocks},
                        0, "bit for bit", ms, plain_ms, view.numel() + 8, b_ms, b_by, plain_ms,
                        "torch.sum(x, dtype=torch.int64) (the plain version)"))
        out[-1]["gb_per_s"] = view.numel() / (ms * 1e-3) / 1e9
    del x
    torch.cuda.empty_cache()
    return out


# P3's instructions on the CUDA cores: deq-dot's dequantization, 5 a pair of codes (a byte permute,
# two logic ops, two bf16x2 FMAs: the row kernel's); the int arms' fixup, an output, group and sweep:
# the conversion and 3 f32 operations (i8-seg) or 2 (i8-seg2).
HEAD_A8_INSTR = {"deq-dot": 2.5, "i8-seg": 4.0, "i8-seg2": 3.0}


def head_a8_slopes(torch) -> dict:
    """P3's slope a tile (µs) at B=8 and B=1 under two timers, from
    ``probes.head_a8`` and the probe's own operands alone, so that an older
    tree's kernel is timed here the same way: the probe's slope (128 against
    32 sweeps, the median of 5 calls after 2) with each call's events
    recorded as the host issues it (``unqueued``) and with each call queued
    behind ``SLEEP_CYCLES`` of device sleep (``queued``, the probe's timer:
    a launch shorter than the host's issue of it is timed at the card's
    pace, not the host's)."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import HEAD_A8_VARIANTS, head_a8
    from qwen3_rs_tpu_torch.scripts.head_a8_probe import N_TILES, inputs

    def median_ms(fn, queued: bool) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    lo, out = N_TILES * 16, {}
    for b in (8, 1):
        ops = inputs(b, *PROBE_HEAD, DEV)
        out[f"B={b}"] = {v: {timer: (median_ms(lambda: head_a8(v, **ops, sweeps=4 * lo), timer == "queued")
                                     - median_ms(lambda: head_a8(v, **ops, sweeps=lo), timer == "queued"))
                                    / (3 * lo) * 1e3 for timer in ("unqueued", "queued")}
                         for v in HEAD_A8_VARIANTS}
        del ops
    return out


def head_a8_rows(torch, ctx) -> list[dict]:
    """P3 at B=8 and B=1 (TN 4096, TD 1536, 2 tiles, 32 sweeps a launch),
    each variant against its plain version (``probes.HEAD_A8_RTOL`` of the
    largest value).  No one PyTorch call computes it.  The bound is the
    largest of the bytes (each tile read once), the products at their peak
    (bf16 or int8) and the dequantization's or fixup's instructions at
    ``F32_INSTR_PER_S`` (``HEAD_A8_INSTR``: per code for deq-dot, per output,
    group and sweep for the int arms)."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import HEAD_A8_RTOL, HEAD_A8_VARIANTS, head_a8, head_a8_plain
    from qwen3_rs_tpu_torch.scripts.head_a8_probe import N_TILES, inputs

    tn, td = PROBE_HEAD
    out = []
    for b in (8, 1):
        ops = inputs(b, tn, td, DEV, seed=8003 + b)
        sweeps = N_TILES * 16
        for v in HEAD_A8_VARIANTS:
            got, ref = head_a8(v, **ops), head_a8_plain(v, **ops)
            torch.cuda.synchronize()
            err, tol = float((got - ref).abs().max()), HEAD_A8_RTOL[v] * float(ref.abs().max())
            need(math.isfinite(err) and err <= tol, f"head_a8 {v} B={b}: {err} > {tol}")
            ms = device_ms(torch, lambda i: head_a8(v, **ops))
            plain_ms = device_ms(torch, lambda i: head_a8_plain(v, **ops), reps=5, warmup=1)
            reads = {"deq-dot": ("x", "w", "s"), "i8-seg": ("xq", "xs", "w", "s"), "i8-seg2": ("xq", "w", "s")}[v]
            nbytes = sum(ops[k].numel() * ops[k].element_size() for k in reads) + b * td * 4
            b_ms, b_by = bound(nbytes, 2.0 * b * tn * td * sweeps, "bf16" if v == "deq-dot" else "int8")
            per = tn * td if v == "deq-dot" else b * td * (tn // 64)  # codes, or outputs × groups, a sweep
            t_instr = HEAD_A8_INSTR[v] * per * sweeps / F32_INSTR_PER_S * 1e3
            if t_instr > b_ms:
                b_ms, b_by = t_instr, "operations"
            out.append(_row(ctx, "head_a8", f"{v} B={b}", "qwen3_rs_tpu_torch/csrc/head_a8_probe.cu",
                            "scripts/head_a8_probe.py:99 make_kernel",
                            {"B": b, "TN": tn, "TD": td, "tiles": N_TILES, "sweeps": sweeps}, err, tol, ms, plain_ms,
                            nbytes, b_ms, b_by, None, "none: no one PyTorch call applies group scales inside a product"))
        del ops
    return out


def a8_depth_rows(torch, ctx) -> list[dict]:
    """P4 at 2048x4096x24576: the int arms bit for bit against their plain
    versions, bf16-full within 1e-4 of the largest value; library:
    ``torch.matmul`` (bf16) and ``torch._int_mm`` (int8) on the same operands.
    The int arms' bound is the larger of their products and their flushes."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import (
        A8_DEPTH_RTOL, A8_DEPTH_VARIANTS, A8_SEG_DEPTH, a8_depth, a8_depth_plain,
    )
    from qwen3_rs_tpu_torch.scripts.a8_depth_probe import inputs

    rows, n, d = PROBE_DEPTH
    ops = inputs(rows, n, d, DEV, seed=8004)
    out = []
    for v in A8_DEPTH_VARIANTS:
        kind = "bf16" if v == "bf16-full" else "int8"
        x, wt = ops[kind]
        got, ref = a8_depth(v, x, wt), a8_depth_plain(v, x, wt)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = A8_DEPTH_RTOL[v] * float(ref.abs().max())
        need(math.isfinite(err) and err <= tol, f"a8_depth {v}: {err} > {tol}")
        del got, ref
        ms = device_ms(torch, lambda i: a8_depth(v, x, wt), reps=10)
        plain_ms = device_ms(torch, lambda i: a8_depth_plain(v, x, wt), reps=3, warmup=1)
        if kind == "bf16":
            lib_ms, lib = device_ms(torch, lambda i: torch.matmul(x, wt.T), reps=10), "torch.matmul bf16 (bf16 out)"
        else:
            lib_ms, lib = device_ms(torch, lambda i: torch._int_mm(x, wt.T), reps=10), "torch._int_mm (int32 out)"
        nbytes = (x.numel() + wt.numel()) * x.element_size() + rows * d * 4
        b_ms, b_by = bound(nbytes, 2.0 * rows * n * d, kind)
        if kind == "int8":
            # The int8 products on the tensor cores and the flush on the CUDA cores, on separate
            # pipes that may overlap: the larger of the two.  A flush is 2 instructions (a
            # conversion and an add) per output element and flush segment, at F32_INSTR_PER_S.
            t_flush = 2.0 * rows * d * -(-n // A8_SEG_DEPTH[v]) / F32_INSTR_PER_S * 1e3
            if t_flush > b_ms:
                b_ms, b_by = t_flush, "operations"
        out.append(_row(ctx, "a8_depth", v, "qwen3_rs_tpu_torch/csrc/a8_depth_probe.cu",
                        "scripts/a8_depth_probe.py:90 make_kernel", {"rows": rows, "N": n, "D": d}, err,
                        tol if kind == "bf16" else "bit for bit", ms, plain_ms, nbytes, b_ms, b_by, lib_ms, lib))
        out[-1]["tf_per_s"] = 2.0 * rows * n * d / (ms * 1e-3) / 1e12
        torch.cuda.empty_cache()
    del ops
    return out


# ------------------------------------------------------------ model helpers
def write_tokenizer(path: Path, vocab_size: int) -> tuple[int, int]:
    """A tokenizer.bin in which every id decodes to distinct bytes: ids < 256
    are single bytes, the rest ``[id]``.  No merges; bos/eos are the last two
    ids.  Returns (bos, eos)."""
    bos, eos = vocab_size - 2, vocab_size - 1
    parts = [struct.pack("<III", 16, bos, eos)]
    for i in range(vocab_size):
        tok = bytes([i]) if i < 256 else f"[{i}]".encode()
        parts.append(struct.pack("<fI", 0.0, len(tok)) + tok)
    path.write_bytes(b"".join(parts))
    return bos, eos


def write_templates(root: Path) -> None:
    (root / "template").write_text("<|im_start|>user\n%s<|im_end|>\n<|im_start|>assistant\n")
    (root / "template.with-system").write_text(
        "<|im_start|>system\n%s<|im_end|>\n<|im_start|>assistant\n"
    )


def write_qtpu(root: Path, config, weights) -> None:
    """The native checkpoint layout (in-major v2) of ``weights`` (unfused,
    f32 scales, shared classifier), written with numpy."""
    import numpy as np

    w = root / "weights"
    w.mkdir(parents=True)
    (root / "config.json").write_text(config.to_native_json())
    (w / "_layout").write_text("in_major_v2")
    c = config
    ah, kvd, hid = c.all_heads_dim, c.kv_dim, c.hidden_dim
    lw = weights.layers

    def save(name, t):
        np.save(w / f"{name}.npy", t.cpu().contiguous().numpy())

    def split(name, qt, lo, hi):
        save(f"{name}.q", qt.q[..., lo:hi])
        save(f"{name}.s", qt.scales[..., lo:hi])

    split("wq", lw.wqkv, 0, ah)
    split("wk", lw.wqkv, ah, ah + kvd)
    split("wv", lw.wqkv, ah + kvd, ah + 2 * kvd)
    split("wo", lw.wo, 0, c.dim)
    split("w1", lw.w13, 0, hid)
    split("w3", lw.w13, hid, 2 * hid)
    split("w2", lw.w2, 0, c.dim)
    save("embed.q", weights.embed.q)
    save("embed.s", weights.embed.scales)
    for name in ("rms_att", "rms_ffn", "q_norm", "k_norm"):
        save(name, getattr(lw, name))
    save("rms_final", weights.rms_final)


def write_hf_model(root: Path, seed: int) -> Path:
    """A synthetic HuggingFace model directory, written with numpy: a Qwen3
    config at dim 512 (2 layers, 4 query and 2 kv heads of 128, hidden 1024,
    vocabulary 1024), f32 safetensors drawn from ``seed``, a byte-level
    ``tokenizer.json`` (every byte a token, no merges) and a Qwen3 chat
    template."""
    import numpy as np

    dim, hidden, layers, heads, kv, hd, vocab = 512, 1024, 2, 4, 2, 128, 1024
    rng = np.random.default_rng(seed)
    t = {"model.embed_tokens.weight": rng.normal(0, 0.05, (vocab, dim)), "model.norm.weight": 1 + 0.02 * rng.normal(size=dim)}
    for l in range(layers):
        pre = f"model.layers.{l}"
        for name, shape in (("input_layernorm", (dim,)), ("post_attention_layernorm", (dim,)),
                            ("self_attn.q_norm", (hd,)), ("self_attn.k_norm", (hd,))):
            t[f"{pre}.{name}.weight"] = 1 + 0.02 * rng.normal(size=shape)
        for name, shape in (("self_attn.q_proj", (heads * hd, dim)), ("self_attn.k_proj", (kv * hd, dim)),
                            ("self_attn.v_proj", (kv * hd, dim)), ("self_attn.o_proj", (dim, heads * hd)),
                            ("mlp.gate_proj", (hidden, dim)), ("mlp.up_proj", (hidden, dim)),
                            ("mlp.down_proj", (dim, hidden))):
            t[f"{pre}.{name}.weight"] = rng.normal(0, 0.05, shape)
    header, blobs, off = {}, [], 0
    for name, arr in t.items():
        raw = np.ascontiguousarray(arr, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    model = root / "hf_model"
    model.mkdir(parents=True)
    hjson = json.dumps(header).encode()
    (model / "model.safetensors").write_bytes(struct.pack("<Q", len(hjson)) + hjson + b"".join(blobs))
    # GPT-2 byte-level characters: printable bytes stand for themselves, the rest from U+0100 on.
    printable = [b for b in range(256) if 33 <= b <= 126 or 161 <= b <= 172 or 174 <= b <= 255]
    chars = {b: chr(b) for b in printable}
    chars.update({b: chr(256 + i) for i, b in enumerate(b for b in range(256) if b not in chars)})
    vocab_map = {chars[b]: b for b in range(256)}
    vocab_map.update({f"w{i}": i for i in range(256, vocab - 2)})
    tok = {"model": {"vocab": vocab_map, "merges": []},
           "added_tokens": [{"id": vocab - 2, "content": "<|im_start|>"}, {"id": vocab - 1, "content": "<|im_end|>"}]}
    (model / "tokenizer.json").write_text(json.dumps(tok))
    (model / "tokenizer_config.json").write_text(json.dumps({"chat_template": (
        "{% for message in messages %}<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
        "{% endfor %}{% if enable_thinking %}{% endif %}{% if messages[0].role == 'system' %}{% endif %}")}))
    (model / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3ForCausalLM"], "hidden_size": dim, "intermediate_size": hidden,
        "num_hidden_layers": layers, "num_attention_heads": heads, "num_key_value_heads": kv, "head_dim": hd,
        "vocab_size": vocab, "max_position_embeddings": 1024, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "bos_token_id": vocab - 2, "eos_token_id": vocab - 1,
    }))
    return model


def prompt_text(n_chars: int) -> str:
    words = "the quick brown fox jumps over the lazy dog while a card streams weights "
    return (words * (n_chars // len(words) + 1))[:n_chars]


# ------------------------------------------------------------------------ e2e
def model_8b(torch, ctx):
    """Qwen3-8B at full width and depth, INT8-g64 random weights drawn on the
    card from the seed (f32 scales, as a checkpoint holds them), and a
    tokenizer whose every id decodes to distinct bytes; made once and shared
    by the e2e and serve phases."""
    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    if "8b" not in ctx:
        cfg = qwen3_config("8b", seq_len=4096)
        t0 = time.perf_counter()
        weights = random_weights(cfg, seed=SEED, device=DEV)
        torch.cuda.synchronize()
        emit({"phase": "model", "model": "qwen3-8b INT8-g64", "layers": cfg.n_layers, "dim": cfg.dim,
              "hidden": cfg.hidden_dim, "vocab": cfg.vocab_size, "ctx": cfg.seq_len,
              "setup_seconds": time.perf_counter() - t0,
              "device_memory_gb": torch.cuda.memory_allocated() / 1e9})
        if "8b_tok" not in ctx:
            tdir = ctx["tmp"] / "tok"
            tdir.mkdir()
            write_tokenizer(tdir / "tokenizer.bin", cfg.vocab_size)
            write_templates(tdir)
            ctx["8b_tok"] = Tokenizer(tdir, cfg.vocab_size)
        ctx["8b"] = (cfg, weights, ctx["8b_tok"])
    return ctx["8b"]


def model_8b_q4(torch, ctx):
    """Qwen3-8B with INT4-g64 linear layers (random packed codes from the
    seed; the embedding and the classifier INT8), drawn once on the card and
    kept until the serve phase's INT4 run frees it."""
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    if "8b_q4" not in ctx:
        cfg = qwen3_config("8b", seq_len=4096)
        t0 = time.perf_counter()
        ctx["8b_q4"] = random_weights(cfg, seed=SEED, device=DEV, bits=4)
        torch.cuda.synchronize()
        emit({"phase": "model", "model": "qwen3-8b INT4-g64 (INT8 embedding and classifier)",
              "setup_seconds": time.perf_counter() - t0, "device_memory_gb": torch.cuda.memory_allocated() / 1e9})
    return ctx["8b_q4"]


def phase_e2e(torch, ctx) -> None:
    from qwen3_rs_tpu_torch import Engine, TokenSampler, chat, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import weight_bytes_per_decode_token

    cfg, weights, tok = model_8b(torch, ctx)  # f32 scales: eval-ppl and exact mode
    engine = Engine(config=cfg, weights=weights, device=DEV)  # bf16 scales, the same codes
    prompt = prompt_text(200)
    per_step = {"decode_megakernel": 1}  # the whole step, classifier included, in one launch
    steps: list[float] = []
    prefills: list[float] = []

    def instrument(eng):
        decode, prefill = eng.decode_step, eng.prefill

        def counted_decode(cache, tokens, pos):
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = decode(cache, tokens, pos)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
            made = {k: LAUNCHES[k] - before[k] for k in per_step}
            need(made == per_step, f"decode step launched {made}, expected {per_step}")
            need(logits.shape == (1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
            return logits, cache

        def timed_prefill(cache, tokens, pos):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = prefill(cache, tokens, pos)
            torch.cuda.synchronize()
            prefills.append((time.perf_counter() - t, tokens.shape[1]))
            need(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
            return logits, cache

        eng.decode_step, eng.prefill = counted_decode, timed_prefill

    instrument(engine)
    reset_launches()  # the main path's run starts here
    runs, run_steps = [], []
    for _ in range(2):
        n0 = len(steps)
        runs.append(generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt,
                             out=io.StringIO(), max_tokens=DECODE_TOKENS))
        run_steps.append(steps[n0:])
    need(len(runs[0]) > 1, "greedy generate stopped before its first decode step")
    need(runs[0] == runs[1], "two greedy runs differ")
    emit({"phase": "e2e", "run": "generate greedy x2", "prompt_tokens": len(tok.encode(prompt)),
          "generated": len(runs[0]), "identical": True,
          "first_window_prefill_ms": prefills[0][0] * 1e3,
          "prefill_rows": prefills[0][1]})

    buf = io.StringIO()
    chat(engine, tok, TokenSampler(0.8, 0.9, 3), prompt_text(60), system_prompt="be brief",
         out=buf, max_tokens=DECODE_TOKENS // 2)
    emit({"phase": "e2e", "run": "chat -t 0.8 -s 3", "chars_out": len(buf.getvalue())})

    engine8 = Engine(config=cfg, weights=engine.weights, cache_dtype="int8", device=DEV)
    instrument(engine8)
    n_before = len(steps)
    ids8 = generate(engine8, tok, TokenSampler(0.0, 0.9, SEED), prompt,
                    out=io.StringIO(), max_tokens=DECODE_TOKENS)
    need(len(ids8) > 0, "kv_int8 generate produced no token")
    int8_steps = steps[n_before:]
    launches = dict(LAUNCHES)  # the main path's run ends here
    for name in per_step:
        need(launches[name] > 0, f"kernel {name} was not launched on the main path")
    ctx["path_launches"]["decode"] = launches

    wbytes = weight_bytes_per_decode_token(cfg, scale_bytes=2)
    # Steady decode: the greedy steps without the first of each run.
    steady = run_steps[0][1:] + run_steps[1][1:]
    step_s = statistics.median(steady)
    ctx["e2e"] = {
        "decode_tok_per_s": 1.0 / step_s, "decode_step_ms": step_s * 1e3,
        "decode_step_ms_p90": statistics.quantiles(steady, n=10)[-1] * 1e3,
        "decode_step_samples": len(steady),
        "weight_gb_per_s": wbytes / step_s / 1e9, "weight_bytes_per_token": wbytes,
        "weight_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3,
        "first_window_prefill_ms": prefills[0][0] * 1e3, "prefill_rows": prefills[0][1],
        "kv_int8_decode_step_ms": statistics.median(int8_steps[1:] or int8_steps) * 1e3,
        "decode_steps": len(steps), "launches": launches,
    }
    emit({"phase": "e2e", **ctx["e2e"], "launches_per_decode_step": per_step,
          "every_step_checked": True})
    ctx["e2e"]["profile"] = profile_decode(torch, engine, prompt_ids=tok.encode(prompt))
    emit({"phase": "e2e", "profile": ctx["e2e"]["profile"]})
    del engine8
    torch.cuda.empty_cache()

    plain_engine = Engine(config=cfg, weights=engine.weights, device=DEV)  # not instrumented
    ctx["e2e"]["profile_trace"] = traced_chunk(torch, ctx, plain_engine, tok, prompt)
    ctx["e2e"]["megakernel_off"] = megakernel_off_path(torch, ctx, cfg, plain_engine, tok, prompt, steady)
    ctx["e2e"]["device_sampling"] = device_sampling_path(torch, ctx, cfg, plain_engine, tok, prompt, runs[0])
    ctx["e2e"]["dense_b9"] = dense_b9_path(torch, ctx, cfg, plain_engine)
    del plain_engine
    torch.cuda.empty_cache()

    ctx["e2e"]["long_prompt"] = long_prompt_path(torch, ctx, cfg, engine, tok)
    ctx["e2e"]["continued_window"] = continued_window_path(torch, ctx, cfg, engine)
    del engine
    torch.cuda.empty_cache()
    ctx["e2e"]["eval_ppl_fast"] = eval_path(torch, ctx, cfg, weights, "fast", windows=2, runs=2)
    ctx["e2e"].update(exact_paths(torch, ctx, cfg, weights, tok))
    del weights
    ctx.pop("8b")  # the INT8 weights make room; the serve phase draws them again from the seed
    torch.cuda.empty_cache()
    ctx["e2e"]["int4"] = int4_path(torch, ctx, cfg, tok)
    torch.cuda.empty_cache()
    e = ctx["e2e"]
    emit({"phase": "e2e", "summary": True, "decode_tok_per_s_b1": e["decode_tok_per_s"],
          "ttft_ms_3000_tokens": e["long_prompt"]["ttft_ms"],
          "fresh_2048_window_ms": e["long_prompt"]["fresh_2048_ttft_ms"],
          "continued_32_row_window_ms": e["continued_window"]["window_ms_median"],
          "eval_ppl_fast_s_per_window": e["eval_ppl_fast"]["seconds_per_window"],
          "int4_ttft_ms_3000_tokens": e["int4"].get("long_prompt", {}).get("ttft_ms")})


def traced_chunk(torch, ctx, engine, tok, prompt) -> dict:
    """One 8-step device-sampling decode chunk inside ``utils.profiling.
    profile_trace``: its trace file must appear under the directory."""
    import numpy as np

    from qwen3_rs_tpu_torch.utils.profiling import profile_trace

    ids = np.asarray([tok.encode(prompt)])
    logits, cache = engine.prefill(engine.new_cache(1), ids, np.zeros(1, np.int64))
    out = ctx["tmp"] / "trace"
    t0 = time.perf_counter()
    with profile_trace(str(out)):
        toks, _ = engine.decode_chunk(cache, int(logits.float().argmax()), ids.shape[1], 8)
    files = list(out.glob("trace_*.json"))
    need(len(files) == 1 and len(toks) == 8, f"profile_trace wrote {files}")
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    res = {"trace_bytes": files[0].stat().st_size, "events": len(events),
           "kernel_events": sum(e.get("cat") == "kernel" for e in events), "seconds": time.perf_counter() - t0}
    emit({"phase": "e2e", "run": "profile_trace around one decode chunk", **res})
    return res


def exact_paths(torch, ctx, cfg, weights, tok) -> dict:
    """Exact mode's two paths at 8B: generate() on a 300-token prompt (its
    window through #8) and eval-ppl at one 4096-row window (#8 throughout)."""
    return {"exact_generate": exact_generate_path(torch, ctx, cfg, weights, tok),
            "eval_ppl_exact": eval_path(torch, ctx, cfg, weights, "exact", windows=1, runs=1)}


def phase_exact(torch, ctx) -> None:
    """Exact mode alone (``--phases build,exact``): the e2e phase's exact
    paths on the same 8B weights, for a comparison of two trees in one call."""
    cfg, weights, tok = model_8b(torch, ctx)
    ctx["e2e"] = exact_paths(torch, ctx, cfg, weights, tok)
    emit({"phase": "exact", "exact_window_ms": ctx["e2e"]["exact_generate"]["window_ms"],
          "eval_ppl_exact_s_per_window": ctx["e2e"]["eval_ppl_exact"]["seconds_per_window"]})
    del weights
    ctx.pop("8b")
    torch.cuda.empty_cache()


def int4_path(torch, ctx, cfg, tok) -> dict:
    """Qwen3-8B with INT4 linear layers (random packed codes from the seed;
    embedding and classifier INT8), on the JAX package's default route: b=1
    greedy decode after a 200-token prompt, each step 4·L Q4 #3 launches, one
    INT8 classifier launch and L flash-decode launches (no megakernel: its
    gate refuses Q4); a 3000-token prompt (#5 and Q4 #6); eval-ppl at one
    4096-row window, fast (Q4 #6 and Q4 #7) and f32; exact mode raises; and
    the card against the CPU on a one-layer slice."""
    import qwen3_rs_tpu_torch.inference.engine as engine_mod
    from qwen3_rs_tpu_torch import Engine, TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import random_weights, weight_bytes_per_decode_token

    n_l = cfg.n_layers
    weights = model_8b_q4(torch, ctx)
    out = {"device_memory_gb": torch.cuda.memory_allocated() / 1e9}
    engine = Engine(config=cfg, weights=weights, device=DEV)
    prompt = prompt_text(200)
    step = {w8a16_key(1, q4=True): 4 * n_l, w8a16_key(1): 1, "flash_decode": n_l}
    recs: list = []
    reset_launches()  # this path's run starts here
    with forward_records(torch, engine_mod, recs):
        ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt, out=io.StringIO(), max_tokens=DECODE_TOKENS)
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["int4_decode"] = launches
    need(len(ids) > 1 and recs[0]["rows"] == len(tok.encode(prompt)), f"INT4 generate: {len(ids)} tokens")
    window = recs[0]["rows"]
    _expect(recs[0], {w8a16_key(window, q4=True): 4 * n_l, w8a16_key(1): 1}, "INT4 prompt window")
    for rec in recs[1:]:
        _expect(rec, step, "INT4 decode step")
    need(launches["decode_megakernel"] == 0, "INT4 decode took the megakernel")
    steady = [r["seconds"] for r in recs[2:]]
    step_s = statistics.median(steady)
    wbytes = weight_bytes_per_decode_token(cfg, scale_bytes=2, bits=4)
    out.update({
        "generated": len(ids), "decode_step_ms": step_s * 1e3, "decode_tok_per_s": 1.0 / step_s,
        "decode_step_ms_p90": statistics.quantiles(steady, n=10)[-1] * 1e3, "decode_step_samples": len(steady),
        "weight_bytes_per_token": wbytes, "weight_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3,
        "launches_per_decode_step": step, "every_step_checked": True, "launches": launches,
    })
    out["profile"] = profile_decode(torch, engine, prompt_ids=tok.encode(prompt))
    emit({"phase": "e2e", "run": "INT4 generate greedy", **out})
    out["megakernel_q4"] = int4_megakernel_path(torch, ctx, cfg, engine, tok, prompt, step_s)
    out["long_prompt"] = long_prompt_path(torch, ctx, cfg, engine, tok, q4=True)
    del engine
    torch.cuda.empty_cache()
    out["eval_ppl_fast"] = eval_path(torch, ctx, cfg, weights, "fast", windows=1, runs=1, q4=True)
    out["eval_ppl_f32"] = eval_path(torch, ctx, cfg, weights, "f32", windows=1, runs=1, q4=True)
    try:
        exact = Engine(config=cfg, weights=weights, mode="exact", device=DEV)
        exact.prefill(exact.new_cache(1), [tok.encode(prompt)], [0])
        raised = None
    except ValueError as e:
        raised = str(e)
    need(raised is not None and "INT4 weights have no reference-exact" in raised, f"INT4 exact mode: {raised}")
    out["exact_mode"] = raised
    del weights, exact
    torch.cuda.empty_cache()
    out["parity_one_layer"] = int4_parity(torch, ctx)
    with q4_megakernel_opt_in():
        out["parity_one_layer_megakernel_q4"] = int4_parity(torch, ctx, megakernel=True)
    return out


def int4_megakernel_path(torch, ctx, cfg, engine, tok, prompt, per_layer_step_s) -> dict:
    """The INT4 b=1 greedy decode with the reference's opt-in to its Q4 tiles
    (``QWEN3_TPU_MEGA_Q4=1``), in the same call as the per-layer INT4 path:
    every decode step one Q4 megakernel launch and no Q4 #3 launch, timed and
    profiled; then ``decode_chunk`` with device sampling on it (greedy equal
    to the host-greedy stream, a chunk with no host synchronisation)."""
    import numpy as np

    import qwen3_rs_tpu_torch.inference.engine as engine_mod
    from qwen3_rs_tpu_torch import TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l = cfg.n_layers
    recs: list = []
    with q4_megakernel_opt_in():
        reset_launches()  # this path's run starts here
        with forward_records(torch, engine_mod, recs):
            ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt, out=io.StringIO(),
                           max_tokens=DECODE_TOKENS)
        launches = dict(LAUNCHES)  # and ends here
        ctx["path_launches"]["int4_megakernel_decode"] = launches
        need(len(ids) > 2, f"INT4 megakernel generate: {len(ids)} tokens")
        _expect(recs[0], {w8a16_key(recs[0]["rows"], q4=True): 4 * n_l, w8a16_key(1): 1}, "INT4 prompt window")
        for rec in recs[1:]:
            _expect(rec, {"decode_megakernel_q4": 1}, "INT4 decode step (Q4 megakernel)")
        steady = [r["seconds"] for r in recs[2:]]
        step_s = statistics.median(steady)
        out = {"generated": len(ids), "decode_step_ms": step_s * 1e3, "decode_tok_per_s": 1.0 / step_s,
               "decode_step_ms_p90": statistics.quantiles(steady, n=10)[-1] * 1e3, "decode_step_samples": len(steady),
               "per_layer_decode_step_ms_same_call": per_layer_step_s * 1e3,
               "launches_per_decode_step": {"decode_megakernel_q4": 1, w8a16_key(1, q4=True): 0},
               "every_step_checked": True, "launches": launches}
        out["profile"] = profile_decode(torch, engine, prompt_ids=tok.encode(prompt))
        # Device sampling on the same route: one chunk, greedy, checked for
        # host synchronisation, against the host-greedy stream.
        pids = np.asarray([tok.encode(prompt)])
        logits, cache = engine.prefill(engine.new_cache(1), pids, np.zeros(1, np.int64))
        first, n = int(logits.float().argmax()), DECODE_TOKENS
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED)
        before = dict(LAUNCHES)
        engine.decode_chunk_device(cache, first, pids.shape[1], 2, generator=gen)  # warm
        logits, cache = engine.prefill(engine.new_cache(1), pids, np.zeros(1, np.int64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, cache = engine.decode_chunk_device(cache, first, pids.shape[1], n, generator=gen)
            end = torch.cuda.Event()
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enqueue_s = time.perf_counter() - t0
        end.synchronize()
        chunk_s = time.perf_counter() - t0
        made = LAUNCHES["decode_megakernel_q4"] - before["decode_megakernel_q4"]
        chunk_ids = [first] + toks.cpu().tolist()
        m = min(len(ids), len(chunk_ids))
        need(made == n + 2 and chunk_ids[:m] == ids[:m], f"INT4 device chunk: {made} launches, tokens {chunk_ids[:m]}")
    out["device_chunk"] = {"steps": n, "enqueue_ms": enqueue_s * 1e3, "ms_per_token": chunk_s * 1e3 / n,
                           "greedy_equals_host": True, "sync_free_chunk": True}
    emit({"phase": "e2e", "run": "INT4 generate greedy through the Q4 megakernel (QWEN3_TPU_MEGA_Q4=1)", **out})
    return out


INT4_PER_LAYER_REQUESTS = 8  # the INT4 dense run without the opt-in: one full wave of slots
INT4_PER_LAYER_NEW_TOKENS = 16


def int4_dense_batch(torch, ctx, cfg, traffic) -> dict:
    """The serve traffic on the INT4 weights' dense slots with device
    sampling (the ``batch`` CLI's defaults) and the Q4 megakernel opted in:
    every chunk step one Q4 megakernel launch.  Before it, the JAX default
    (not opted in) on the first 8 requests, 16 new tokens each: every chunk
    step 4·L Q4 #3 launches at 8 rows (its mma route) and the INT8
    classifier's.  It frees the INT4 weights."""
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine

    _, weights = _first_layers(cfg, model_8b_q4(torch, ctx), cfg.n_layers)
    ctx.pop("8b_q4")  # freed with this run's last reference
    n_l = cfg.n_layers
    with q4_megakernel_opt_in(False):
        engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="dense", sampling="device",
                                          device=DEV)
        engine.warmup()
        short = [(p, INT4_PER_LAYER_NEW_TOKENS) for p, _ in traffic[:INT4_PER_LAYER_REQUESTS]]
        per_layer = _serve_run(torch, ctx, "int4_dense_device_per_layer", engine, short, n_l, profile=False,
                               want={w8a16_key(8, q4=True): 4 * n_l, w8a16_key(8): 1, "flash_decode": n_l})
    ctx["serve"]["int4_dense_device_per_layer"] = per_layer
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with q4_megakernel_opt_in():
        engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="dense", sampling="device",
                                          device=DEV)
        engine.warmup()
        warm = time.perf_counter() - t0
        res = _serve_run(torch, ctx, "int4_dense_device", engine, traffic, cfg.n_layers, profile=False)
    res["setup_and_warmup_s"] = warm
    need(res["launches"]["decode_megakernel_q4"] > 0, f"INT4 dense batch launched {res['launches']}")
    del engine, weights
    torch.cuda.empty_cache()
    return res


def int4_parity(torch, ctx, megakernel: bool = False) -> dict:
    """Card against CPU on a one-layer INT4 slice at 8B width: a fresh
    300-row window (Q4 #6, #5), a continued 16-row window (Q4 #3) and 3
    decode steps (Q4 #3, #4; with ``megakernel``, under the opt-in, Q4 #11)."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.models.qwen3 import weights_to
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    t0 = time.perf_counter()
    cfg = qwen3_config("8b", seq_len=4096, n_layers=1)
    weights = random_weights(cfg, seed=SEED + 7, device=DEV, bits=4)
    card = Engine(config=cfg, weights=weights, device=DEV)
    cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")
    rng = np.random.default_rng(SEED + 7)
    tol_rel = 2e-2  # f32 sums in another order can flip a bf16 rounding of the residual stream
    caches, pos, errs = [card.new_cache(1), cpu.new_cache(1)], 0, []
    for rows in (300, 16):
        prompt = rng.integers(0, cfg.vocab_size, (1, rows))
        lc, caches[0] = card.prefill(caches[0], prompt, [pos])
        lp, caches[1] = cpu.prefill(caches[1], prompt, [pos])
        pos += rows
        errs.append(float((lc.float().cpu() - lp).abs().max()) / float(lp.abs().max()))
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    before = LAUNCHES["decode_megakernel_q4"]
    for i in range(3):
        nxt = int(lp.argmax())
        lc, caches[0] = card.decode_step(caches[0], [nxt], [pos + i])
        lp, caches[1] = cpu.decode_step(caches[1], [nxt], [pos + i])
        errs.append(float((lc.float().cpu() - lp).abs().max()) / float(lp.abs().max()))
    made = LAUNCHES["decode_megakernel_q4"] - before
    need(made == (3 if megakernel else 0), f"INT4 card vs CPU: {made} Q4 megakernel launches")
    need(all(math.isfinite(e) and e <= tol_rel for e in errs), f"INT4 card vs CPU: {errs}")
    res = {"layers": 1, "width": cfg.dim, "windows": [300, 16], "decode_steps": 3, "rel_errs": errs,
           "tol_rel": tol_rel, "megakernel_q4_launches": made, "seconds": time.perf_counter() - t0}
    emit({"phase": "e2e", "run": "INT4 card vs CPU" + (" (Q4 megakernel)" if megakernel else ""), **res})
    return res


@contextlib.contextmanager
def forward_records(torch, module, records: list):
    """Wrap ``module.qwen3_forward``: each call appends its window rows, start
    position, synchronised host seconds and the kernel launches it made."""
    import numpy as np

    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    orig = module.qwen3_forward

    def wrapped(config, weights, tokens, cache, pos, **kw):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(config, weights, tokens, cache, pos, **kw)
        torch.cuda.synchronize()
        records.append({
            "rows": int(np.asarray(tokens).shape[1]), "pos": int(np.asarray(pos).reshape(-1)[0]),
            "start": t, "seconds": time.perf_counter() - t,
            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]},
        })
        return out

    module.qwen3_forward = wrapped
    try:
        yield
    finally:
        module.qwen3_forward = orig


def _expect(rec: dict, want: dict, what: str) -> None:
    want = {k: v for k, v in want.items() if v}
    need(rec["launches"] == want, f"{what} ({rec['rows']} rows at {rec['pos']}) launched {rec['launches']}, expected {want}")


@contextlib.contextmanager
def megakernel_gate_off():
    """The forward's megakernel gate patched to refuse every shape: decode
    steps take the per-layer kernels (4·L+1 W8A16, L flash decode)."""
    import qwen3_rs_tpu_torch.models.qwen3 as mq

    orig = mq.megakernel_route
    mq.megakernel_route = lambda *a, **k: False
    try:
        yield
    finally:
        mq.megakernel_route = orig


def megakernel_off_path(torch, ctx, cfg, engine, tok, prompt, steady_on) -> dict:
    """The b=1 greedy decode of the main path with the megakernel gate
    patched off, in the same call: per-step launches, step time and a
    profile, beside the megakernel's."""
    import qwen3_rs_tpu_torch.inference.engine as engine_mod
    from qwen3_rs_tpu_torch import TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l = cfg.n_layers
    recs: list = []
    reset_launches()  # this path's run starts here
    with megakernel_gate_off(), forward_records(torch, engine_mod, recs):
        ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt, out=io.StringIO(), max_tokens=DECODE_TOKENS)
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["megakernel_off"] = launches
    need(len(ids) > 1, "gate-off generate stopped before its first decode step")
    for rec in recs[1:]:
        _expect(rec, {w8a16_key(1): 4 * n_l + 1, "flash_decode": n_l}, "gate-off decode step")
    steady_off = [r["seconds"] for r in recs[2:]]
    out = {"generated": len(ids), "decode_step_ms": statistics.median(steady_off) * 1e3,
           "decode_tok_per_s": 1.0 / statistics.median(steady_off),
           "decode_step_ms_megakernel_same_call": statistics.median(steady_on) * 1e3, "launches": launches}
    with megakernel_gate_off():
        out["profile"] = profile_decode(torch, engine, prompt_ids=tok.encode(prompt))
    out["profile_megakernel_same_call"] = profile_decode(torch, engine, prompt_ids=tok.encode(prompt))
    emit({"phase": "e2e", "run": "decode with the megakernel gate off", **out})
    return out


def device_sampling_path(torch, ctx, cfg, engine, tok, prompt, host_ids) -> dict:
    """generate with device sampling (decode_chunk: 64-step chunks on the
    device): at -t 0 the host-greedy stream, at -t 0.8 repeatable per seed;
    every chunk step one megakernel launch; a chunk with no host
    synchronisation before its final copy (torch.cuda.set_sync_debug_mode
    "error"), and its time per token."""
    import numpy as np

    from qwen3_rs_tpu_torch import TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l = cfg.n_layers
    reset_launches()  # this path's run starts here
    before = dict(LAUNCHES)
    greedy = generate(engine, tok, TokenSampler(0.0, 0.9, SEED, device=True), prompt, out=io.StringIO(),
                      max_tokens=DECODE_TOKENS)
    made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    need(greedy == host_ids, "device-sampling greedy generate differs from the host-greedy stream")
    window, head = w8a16_key(len(tok.encode(prompt))), w8a16_key(1)
    need(made.get("decode_megakernel", 0) >= len(greedy) - 1
         and set(made) == {window, head, "decode_megakernel"}
         and made[window] == 4 * n_l and made[head] == 1,
         f"device-sampling generate launched {made}")
    sampled = [generate(engine, tok, TokenSampler(0.8, 0.9, 7, device=True), prompt, out=io.StringIO(),
                        max_tokens=DECODE_TOKENS) for _ in range(2)]
    need(sampled[0] == sampled[1] and len(sampled[0]) > 1, "device-sampling -t 0.8 is not repeatable per seed")
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["device_sampling"] = launches

    # One chunk with no host synchronisation, timed; then its tokens on the host.
    ids = np.asarray([tok.encode(prompt)])
    logits, cache = engine.prefill(engine.new_cache(1), ids, np.zeros(1, np.int64))
    first, pos, n = int(logits.float().argmax()), ids.shape[1], DECODE_TOKENS
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    engine.decode_chunk_device(cache, first, pos, 2, temperature=0.8, generator=gen)  # warm
    torch.cuda.synchronize()
    chunks = {}
    for temp in (0.0, 0.8):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, cache = engine.decode_chunk_device(cache, first, pos, n, temperature=temp, topp=0.9, generator=gen)
            end = torch.cuda.Event()
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enqueue_s = time.perf_counter() - t0
        end.synchronize()
        chunks[temp] = {"steps": n, "enqueue_ms": enqueue_s * 1e3,
                        "ms_per_token": (time.perf_counter() - t0) * 1e3 / n, "tokens": len(toks.cpu().tolist())}
    out = {"greedy_equals_host": True, "generated": len(greedy), "t0.8_repeatable": True,
           "chunk_t0": chunks[0.0], "chunk_t0.8": chunks[0.8], "sync_free_chunk": True, "launches": launches}
    emit({"phase": "e2e", "run": "device sampling", **out})
    return out


def dense_b9_path(torch, ctx, cfg, engine) -> dict:
    """A dense decode of 9 rows, which the megakernel gate refuses (B > 8):
    every step keeps the per-layer kernels, 4·L+1 W8A16 (9 rows: #3's
    tensor-core route) and L flash decode."""
    import numpy as np

    from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l, b = cfg.n_layers, 9
    cache = init_kv_cache(cfg, b, dtype=torch.bfloat16, device=DEV)
    rng = np.random.default_rng(SEED + 9)
    pos = np.arange(b) * 100
    seconds = []
    reset_launches()  # this path's run starts here
    for step in range(3):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = qwen3_forward(cfg, engine.weights, rng.integers(0, cfg.vocab_size, (b, 1)), cache, pos + step)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        need(made == {w8a16_key(9): 4 * n_l + 1, "flash_decode": n_l}, f"B=9 decode step launched {made}")
        need(logits.shape == (b, cfg.vocab_size) and bool(torch.isfinite(logits).all()), "B=9 logits malformed")
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["dense_b9"] = launches
    out = {"rows": b, "steps": 3, "step_ms": [x * 1e3 for x in seconds], "launches": launches}
    emit({"phase": "e2e", "run": "dense decode B=9 (gate refuses)", **out})
    del cache
    torch.cuda.empty_cache()
    return out


def long_prompt_path(torch, ctx, cfg, engine, tok, q4: bool = False) -> dict:
    """Fast-mode generate on a ~3000-token prompt: a fresh 2048-row window
    (causal prefill kernel, row-blocked W8A16), a continuation window (split
    attention, row-blocked W8A16), then decode steps (the megakernel); twice,
    greedy, each window profiled.  ``q4``: INT4 weights, once, unprofiled:
    the Q4 row-blocked kernel, and decode steps on the per-layer path."""
    import numpy as np

    import qwen3_rs_tpu_torch.inference.engine as engine_mod
    from qwen3_rs_tpu_torch import TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import prefill_ops

    n_l = cfg.n_layers
    prompt = prompt_text(LONG_PROMPT_TOKENS)
    n_tok = len(tok.encode(prompt))
    w = engine.MAX_PREFILL_WINDOW
    windows = [(off, min(w, n_tok - off)) for off in range(0, n_tok, w)]
    need(len(windows) == 2 and windows[0][1] == 2048, f"prompt of {n_tok} tokens: windows {windows}")
    runs = []
    rows_key = "qmatmul_w8a16_rows_q4" if q4 else "qmatmul_w8a16_rows"
    step = ({w8a16_key(1, q4=True): 4 * n_l, w8a16_key(1): 1, "flash_decode": n_l} if q4
            else {"decode_megakernel": 1})
    reset_launches()  # this path's run starts here
    for _ in range(1 if q4 else 2):
        recs: list = []
        with forward_records(torch, engine_mod, recs):
            t0 = time.perf_counter()
            ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt, out=io.StringIO(),
                           max_tokens=LONG_DECODE_TOKENS)
        runs.append((ids, recs, t0))
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["long_prompt_int4" if q4 else "long_prompt"] = launches
    need(runs[0][0] == runs[-1][0], "two greedy long-prompt runs differ")
    for ids, recs, _ in runs:
        need(len(recs) - len(windows) in (len(ids) - 1, len(ids)), f"{len(recs)} forward calls for {len(ids)} tokens")
        for i, (off, rows) in enumerate(windows):
            need((recs[i]["rows"], recs[i]["pos"]) == (rows, off), f"window {i}: {recs[i]['rows']} rows at {recs[i]['pos']}")
            need(rows > 256, f"window {i} of {rows} rows takes the fused kernel")
            _expect(recs[i], {rows_key: 4 * n_l, "causal_prefill_attention": n_l if off == 0 else 0,
                              w8a16_key(1): 1}, f"prefill window {i}")
        for rec in recs[len(windows):]:
            _expect(rec, step, "decode step")
    ids, recs, t0 = runs[-1]
    bounds = [prefill_ops(cfg, rows, cache_rows=off)["total"] / PEAK_OPS_PER_S["bf16"] * 1e3
              for off, rows in windows]
    win_ms = [recs[i]["seconds"] * 1e3 for i in range(len(windows))]
    steps = [r["seconds"] for r in recs[len(windows) + 1:]]
    out = {
        "prompt_tokens": n_tok, "windows": [rows for _, rows in windows], "generated": len(ids),
        "identical": len(runs) > 1, "window_ms": win_ms,
        "window_ms_first_run": [r["seconds"] * 1e3 for r in runs[0][1][:2]],
        "window_bound_ms": bounds, "window_bound_share": [b / m for b, m in zip(bounds, win_ms)],
        "fresh_2048_ttft_ms": win_ms[0], "prefill_ms": sum(win_ms),
        "prefill_bound_share": sum(bounds) / sum(win_ms),
        "ttft_ms": (recs[len(windows)]["start"] - t0) * 1e3,
        "decode_step_ms": statistics.median(steps) * 1e3, "launches": launches,
    }
    emit({"phase": "e2e", "run": "INT4 long prompt generate greedy" if q4 else "long prompt generate greedy x2",
          **out})
    if q4:
        return out
    # Where a window's time goes (profiled apart from the checked runs).
    ids_all = np.asarray([tok.encode(prompt)])
    for name, (off, rows) in zip(("fresh_window", "continuation_window"), windows):
        cache = engine.new_cache(1)
        if off:
            _, cache = engine.prefill(cache, ids_all[:, :off], np.zeros(1, np.int64))
        out[f"profile_{name}"] = profile_calls(
            torch, lambda i: engine.prefill(cache, ids_all[:, off : off + rows], np.full(1, off)), 1)
        emit({"phase": "e2e", "profile": name, "rows": rows, **out[f"profile_{name}"]})
    return out


def continued_window_path(torch, ctx, cfg, engine) -> dict:
    """A continued 32-row window on the dense cache after a 200-row prompt
    (a chunk of a longer prompt; the paged pool's continued windows run the
    same projections): 4·L #3 launches on its tensor-core route and the
    classifier's one row on its CUDA-core route, the attention in plain
    PyTorch.  Host clock around each synchronised window, three times, then
    one profiled."""
    import numpy as np

    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l = cfg.n_layers
    rng = np.random.default_rng(SEED + 32)
    _, cache = engine.prefill(engine.new_cache(1), rng.integers(0, cfg.vocab_size, (1, 200)), np.zeros(1, np.int64))
    toks, pos = rng.integers(0, cfg.vocab_size, (1, 32)), np.full(1, 200)
    engine.prefill(cache, toks, pos)  # warm: the window rewrites the same cache rows each time
    seconds = []
    reset_launches()  # this path's run starts here
    for _ in range(3):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = engine.prefill(cache, toks, pos)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        need(made == {w8a16_key(32): 4 * n_l, w8a16_key(1): 1}, f"continued 32-row window launched {made}")
        need(bool(torch.isfinite(logits).all()), "continued window logits are not finite")
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["continued_window"] = launches
    out = {"rows": 32, "pos": 200, "window_ms": [x * 1e3 for x in seconds],
           "window_ms_median": statistics.median(seconds) * 1e3, "launches": launches}
    out["profile"] = profile_calls(torch, lambda i: engine.prefill(cache, toks, pos), 1)
    emit({"phase": "e2e", "run": "continued 32-row window", **out})
    return out


def eval_path(torch, ctx, cfg, weights, mode: str, windows: int, runs: int, q4: bool = False) -> dict:
    """eval-ppl at the full 4096-row window, through ``compute_perplexity``:
    fast mode sends wqkv, wo and w13 to the row-blocked kernel and w2 to the
    dequant kernel and one bf16 product (their Q4 variants with ``q4``);
    exact mode every projection and the classifier to the W8A8 kernel; f32
    mode launches no kernel."""
    import numpy as np

    import qwen3_rs_tpu_torch.evaluation as ev
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l, window = cfg.n_layers, cfg.seq_len
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, windows * (window - 1) + 1).tolist()
    want = {
        "fast": {"qmatmul_w8a16_rows_q4": 3 * n_l, "dequant_q4_stacked": n_l} if q4
        else {"qmatmul_w8a16_rows": 3 * n_l, "dequant_w8_stacked": n_l},
        "exact": {"qmatmul_w8a8_rows": 4 * n_l + 1},
        "f32": {},
    }[mode]
    name = f"eval_ppl_{mode}" + ("_int4" if q4 else "")
    results, recs, seconds = [], [], []
    reset_launches()  # this path's run starts here
    with forward_records(torch, ev, recs):
        for _ in range(runs):
            t0 = time.perf_counter()
            results.append(ev.compute_perplexity(cfg, weights, tokens, mode=mode, window=window))
            seconds.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"][name] = launches
    need(len(recs) == windows * runs, f"eval-ppl {mode}: {len(recs)} windows, expected {windows * runs}")
    for rec in recs:
        need(rec["rows"] == window, f"eval-ppl window of {rec['rows']} rows")
        _expect(rec, want, f"eval-ppl {mode} window")
    r = results[0]
    need(math.isfinite(r.perplexity) and r.n_tokens == windows * (window - 1), f"eval-ppl {mode}: {r}")
    need(all(x == r for x in results), f"eval-ppl {mode}: runs differ {results}")
    out = {
        "mode": mode, "window": window, "windows": windows, "runs": runs, "perplexity": r.perplexity,
        "avg_nll": r.avg_nll, "tokens": r.n_tokens, "identical_runs": runs > 1,
        "seconds_per_window": statistics.median(seconds) / windows,
        "forward_seconds_per_window": statistics.median(x["seconds"] for x in recs), "launches": launches,
    }
    emit({"phase": "e2e", "run": f"eval-ppl {mode}" + (" INT4" if q4 else ""), **out})
    if mode == "fast":  # where an eval window's time goes
        out["profile"] = profile_calls(
            torch, lambda i: ev.compute_perplexity(cfg, weights, tokens[:window], mode=mode, window=window), 1)
        emit({"phase": "e2e", "profile": f"eval-ppl {mode} window", **out["profile"]})
    return out


def exact_generate_path(torch, ctx, cfg, weights, tok) -> dict:
    """Exact (W8A8) generate: the prompt window takes the W8A8 kernel (4
    projections per layer), decode steps the reference's group scan."""
    import qwen3_rs_tpu_torch.inference.engine as engine_mod
    from qwen3_rs_tpu_torch import Engine, TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    engine = Engine(config=cfg, weights=weights, mode="exact", device=DEV)
    prompt = prompt_text(EXACT_PROMPT_TOKENS)
    recs: list = []
    reset_launches()  # this path's run starts here
    with forward_records(torch, engine_mod, recs):
        ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED), prompt, out=io.StringIO(),
                       max_tokens=EXACT_DECODE_TOKENS)
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["exact_generate"] = launches
    need(len(ids) > 2 and recs[0]["rows"] == EXACT_PROMPT_TOKENS, f"exact generate: {len(ids)} tokens")
    _expect(recs[0], {"qmatmul_w8a8_rows": 4 * cfg.n_layers}, "exact prompt window")
    for rec in recs[1:]:
        _expect(rec, {}, "exact decode step")  # the group scan: plain PyTorch, as the reference
    step_s = statistics.median(r["seconds"] for r in recs[2:])
    out = {"prompt_tokens": recs[0]["rows"], "generated": len(ids), "window_ms": recs[0]["seconds"] * 1e3,
           "decode_step_ms": step_s * 1e3, "decode_tok_per_s": 1.0 / step_s, "launches": launches}
    emit({"phase": "e2e", "run": "exact generate greedy", **out})
    return out


def profile_decode(torch, engine, prompt_ids, steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over ``steps`` greedy
    decode steps after a prefill."""
    import numpy as np

    cache = engine.new_cache(1)
    logits, cache = engine.prefill(cache, np.asarray([prompt_ids]), np.zeros(1, np.int64))
    pos = len(prompt_ids)
    state = {"logits": logits, "cache": cache}

    def step(i):
        state["logits"], state["cache"] = engine.decode_step(
            state["cache"], [int(state["logits"].argmax())], [pos + i])

    return profile_calls(torch, step, steps)


def profile_calls(torch, fn, calls: int) -> dict:
    """torch.profiler over ``calls`` calls of ``fn(i)``: device busy time
    against wall time per call, and the kernels that take the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms == 0.0:
        return {"device_time": "not measured", "reason": "the profiler recorded no device time",
                "wall_ms_per_step": wall_ms / calls}
    return {
        "steps": calls, "wall_ms_per_step": wall_ms / calls,
        "device_busy_ms_per_step": busy_ms / calls,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": sum(r[1] for r in rows) / calls,
        "top": [{"kernel": k[:90], "ms_per_step": us / 1e3 / calls, "calls_per_step": n / calls}
                for us, n, k in rows[:10]],
    }


# ---------------------------------------------------------------------- serve
def _serve_traffic(cfg) -> list[tuple[list[int], int]]:
    """The serve phase's traffic: 24 requests, prompt lengths uniform over
    16-1024 tokens from seed 1 (random ids), 64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(1)
    lens = rng.integers(16, 1025, SERVE_REQUESTS)
    return [([int(t) for t in rng.integers(3, cfg.vocab_size - 2, n)], SERVE_NEW_TOKENS) for n in lens]


def _instrument_engine(torch, engine, records: list):
    """Wrap the engine's decode step (device sampling: its decode chunk) and
    prefill windows: each call appends its kind, rows, active slots (of a
    chunk: its active mask), steps, synchronised host seconds and the kernel
    launches it made."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    def wrap(kind, fn):
        def call(*args, **kw):
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            active = int(sum(r is not None for r in engine.slot_request))
            if kind == "chunk":  # _decode_chunked(prev_last, fresh, pos0, active, temps, topps, n_steps, ...)
                active = int(sum(args[3]))
            # _prefill_paged(tokens, out_idx, tables, pos): pos None for a fresh window.
            records.append({"kind": kind, "rows": None if kind != "prefill" else int(args[0].shape[1]),
                            "batch": None if kind != "prefill" else int(args[0].shape[0]),
                            "cont": kind == "prefill" and len(args) > 3 and args[3] is not None,
                            "steps": int(args[6]) if kind == "chunk" else 1,
                            "active": active, "seconds": time.perf_counter() - t,
                            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}})
            return out

        return call

    if engine.sampling == "device":
        engine._decode_chunked = wrap("chunk", engine._decode_chunked)
    else:
        engine._decode = wrap("decode", engine._decode)
    if engine.kv_layout == "paged":
        engine._prefill_paged = wrap("prefill", engine._prefill_paged)


def _serve_run(torch, ctx, name, engine, traffic, n_layers, *, profile=True, want=None) -> dict:
    """Submit ``traffic`` at once and run the engine to the end, every
    decode step checked for its launches (``want`` a step, by default the
    pool's per-layer kernels or the dense slots' megakernel); then the
    numbers of the run."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.serving import Request

    from qwen3_rs_tpu_torch.ops.quant import Q4Tensor

    paged = engine.kv_layout == "paged"
    # The pool's decode takes the per-layer kernels; the dense slots' (8 rows)
    # the megakernel, with the idle slots' writes gated off.
    mk = "decode_megakernel_q4" if isinstance(engine.weights.layers.wqkv, Q4Tensor) else "decode_megakernel"
    if want is None:
        want = {w8a16_key(engine.n_slots): 4 * n_layers + 1, "paged_decode": n_layers} if paged else {mk: 1}
    recs: list = []
    _instrument_engine(torch, engine, recs)
    reqs = [Request(i, p, max_new_tokens=n, eos_token_ids=()) for i, (p, n) in enumerate(traffic)]
    reset_launches()  # this path's run starts here
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"][f"serve_{name}"] = launches
    need(len(done) == len(reqs) and all(r.finish_reason == "length" and len(r.generated) == r.max_new_tokens
                                         for r in done), f"serve {name}: not every request completed")
    decodes = [r for r in recs if r["kind"] in ("decode", "chunk")]
    for rec in decodes:
        per = {k: v * rec["steps"] for k, v in want.items()}
        need(rec["launches"] == per, f"serve {name}: a decode {rec['kind']} launched {rec['launches']}, expected {per}")
    if paged:
        need(engine.allocator.free_pages == engine.allocator.n_pages - 1, f"serve {name}: pages still held")
    ttft = sorted(r.ttft for r in done)
    full = [r["seconds"] / r["steps"] for r in decodes if r["active"] == engine.n_slots]
    tokens = sum(len(r.generated) for r in done)
    stats = engine.stats()
    out = {
        "requests": len(done), "generated_tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
        "ttft_p50_ms": statistics.median(ttft) * 1e3, "ttft_p90_ms": statistics.quantiles(ttft, n=10)[-1] * 1e3,
        "decode_steps": stats["decode_steps"], "slot_utilization": stats["slot_utilization"],
        "decode_step_ms_8_active": statistics.median(full) * 1e3 if full else None,
        "decode_steps_8_active": len(full),
        "prefill_windows": [(r["rows"], r["seconds"] * 1e3) for r in recs if r["kind"] == "prefill"],
        "prefill_records": [r for r in recs if r["kind"] == "prefill"],
        "launches": launches, "launches_per_decode_step": want, "every_step_checked": True,
        "sampling": engine.sampling,
        "streams": {r.request_id: r.generated for r in done},
    }
    if profile:
        out["profile_decode_8_active"] = _profile_full_decode(torch, engine, traffic)
    emit({"phase": "serve", "run": name, **{k: v for k, v in out.items()
                                             if k not in ("prefill_windows", "prefill_records", "streams")}})
    return out


def _profile_full_decode(torch, engine, traffic, steps: int = 8) -> dict:
    """Where a decode step with every slot active goes: 8 requests admitted,
    then ``steps`` engine steps (pure decode) under torch.profiler."""
    from qwen3_rs_tpu_torch.serving import Request

    for i in range(engine.n_slots):
        engine.submit(Request(1000 + i, traffic[i][0][:200], max_new_tokens=steps + 4, eos_token_ids=()))
    engine.step()  # admits all of them
    need(engine.active_count == engine.n_slots, "profiled decode: not every slot active")
    prof = profile_calls(torch, lambda i: engine.step(), steps)
    engine.run()
    return prof


def _first_layers(cfg, weights, n: int):
    """The model cut to its first ``n`` layers (views of the stacked weights)."""
    import dataclasses

    lw = weights.layers
    layers = type(lw)(*(type(t)(t.q[:n], t.scales[:n]) if hasattr(t, "scales") else t[:n] for t in lw))
    return dataclasses.replace(cfg, n_layers=n), weights._replace(layers=layers)


def phase_serve(torch, ctx) -> None:
    """Continuous-batching serving at Qwen3-8B full width, SERVE_LAYERS of its
    layers, ctx 4096, 8 slots,
    page 128, greedy host sampling: the same traffic on the paged bf16 pool,
    the INT8 pool and the dense slots; the prefix cache; chunked prefill;
    the HTTP front end."""
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine
    from qwen3_rs_tpu_torch.testing import paged_pool_bytes

    cfg, weights, tok = model_8b(torch, ctx)
    cfg, weights = _first_layers(cfg, weights, SERVE_LAYERS)
    traffic = _serve_traffic(cfg)
    ctx["serve"] = out = {"traffic": {"requests": len(traffic), "prompt_tokens": [len(p) for p, _ in traffic],
                                      "max_new_tokens": SERVE_NEW_TOKENS}}
    runs = (("paged_bf16", {}), ("paged_int8", {"cache_dtype": "int8"}), ("dense_bf16", {"kv_layout": "dense"}),
            ("paged_bf16_device", {"sampling": "device"}), ("dense_bf16_device", {"kv_layout": "dense", "sampling": "device"}))
    for name, kw in runs:
        t0 = time.perf_counter()
        c, w = cfg, weights
        engine = ContinuousBatchingEngine(config=c, weights=w, n_slots=8,
                                          **{"kv_layout": "paged", "page_size": 128, "sampling": "host", **kw},
                                          device=DEV)
        engine.warmup()
        warm = time.perf_counter() - t0
        out[name] = _serve_run(torch, ctx, name, engine, traffic, c.n_layers, profile=kw.get("sampling") != "device")
        out[name]["layers"] = c.n_layers
        if name.endswith("_device"):
            out[name]["greedy_vs_host"] = stream_partings(torch, cfg, weights, traffic,
                                                          out[name[: -len("_device")]]["streams"],
                                                          out[name]["streams"])
        out[name]["setup_and_warmup_s"] = warm
        if engine.allocator is not None:
            out[name]["kv_pages"] = engine.allocator.n_pages - 1
            pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache)
            esz = engine.cache.k.element_size()
            need(pool_bytes == paged_pool_bytes(c, engine.allocator.n_pages, 128, esz),
                 f"serve {name}: the pool holds {pool_bytes} bytes, not the layout's")
            out[name]["kv_pool_gb"] = pool_bytes / 1e9
        del engine
        torch.cuda.empty_cache()
    out["int4_dense_device"] = int4_dense_batch(torch, ctx, cfg, traffic)
    keys = ("tok_per_s", "decode_step_ms_8_active", "ttft_p50_ms", "ttft_p90_ms", "slot_utilization")
    out["int4_vs_int8_dense_device"] = {k: {"int8": out["dense_bf16_device"][k], "int4": out["int4_dense_device"][k]}
                                        for k in keys}
    emit({"phase": "serve", "run": "dense slots, device sampling: INT4 (Q4 #11) beside INT8 (#11), same traffic",
          **out["int4_vs_int8_dense_device"]})
    for run in out.values():
        if isinstance(run, dict):
            run.pop("streams", None)
            run.pop("prefill_records", None)
    out["prefix_cache"] = serve_prefix_path(torch, ctx, cfg, weights)
    out["chunked_prefill"] = serve_chunked_path(torch, ctx, cfg, weights)
    out["http"] = serve_http_path(torch, ctx, cfg, weights, tok)
    torch.cuda.empty_cache()


def stream_partings(torch, cfg, weights, traffic, ref: dict, got: dict, tol: float = 2e-2) -> dict:
    """Where two greedy serving runs' streams part: for each parting, its
    token and both picks' logits on the shared history (a b=1 prefill), the
    top-2 logit gap there, and the forward's sensitivity there (the logits
    moved by one norm weight of layer 0 scaled by 1 + 2^-7, relative to
    their largest).  A parting is held to a near-tie: the two picks' logits
    within ``tol`` of the largest.  ``weights`` None: the 8B weights of the
    seed, drawn at the first parting."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.testing import random_weights

    need(ref.keys() == got.keys(), "the two runs completed different requests")
    engines = None
    parts = []
    for rid in sorted(ref):
        a, b = ref[rid], got[rid]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            need(a == b, f"request {rid}: streams of different lengths")
            continue
        i = diff[0]
        if engines is None:
            w = weights if weights is not None else random_weights(cfg, SEED, DEV)
            lw = w.layers
            nudged = lw.rms_att.clone()
            nudged[0, 0] *= 1 + 2.0**-7
            engines = [Engine(config=cfg, weights=x, cache_dtype=torch.bfloat16, device=DEV)
                       for x in (w, w._replace(layers=lw._replace(rms_att=nudged)))]
        hist = np.asarray([list(traffic[rid][0]) + a[:i]])
        lg, lgn = (e.prefill(e.new_cache(1), hist, np.zeros(1, np.int64))[0][0].float() for e in engines)
        top2 = torch.topk(lg, 2).values
        gap = float((lg[a[i]] - lg[b[i]]).abs())
        parts.append({"request": rid, "token_index": i, "tokens": [a[i], b[i]], "pick_gap": gap,
                      "top2_gap": float(top2[0] - top2[1]), "max_abs_logit": float(lg.abs().max()),
                      "sensitivity": float((lgn - lg).abs().max() / lg.abs().max())})
        need(gap <= tol * float(lg.abs().max()), f"request {rid} parts at token {i} away from a near-tie: {parts[-1]}")
    return {"requests": len(ref), "equal": len(ref) - len(parts), "tol": tol, "partings": parts}


def _prefix_traffic(cfg) -> tuple[list[int], list[list[int]]]:
    """The prefix-cache path's requests: a 512-token prefix, then a 16-token
    suffix and 15 distinct 8-24-token ones (seed SEED + 5)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    prefix = [int(t) for t in rng.integers(3, cfg.vocab_size - 2, 512)]
    return prefix, [[int(t) for t in rng.integers(3, cfg.vocab_size - 2, n)] for n in [16] + list(rng.integers(8, 25, 15))]


def _prefix_engine(cfg, weights):
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="paged", page_size=128,
                                      prefix_cache=True, device=DEV)
    engine.warmup()
    return engine


def _prefix_run(engine, prefix, suffixes) -> list:
    """The first request alone for one step, then the 15 hits; run to the end."""
    from qwen3_rs_tpu_torch.serving import Request

    engine.submit(Request(0, prefix + suffixes[0], max_new_tokens=32, eos_token_ids=()))
    engine.step()
    for i, suf in enumerate(suffixes[1:], 1):
        engine.submit(Request(i, prefix + suf, max_new_tokens=32, eos_token_ids=()))
    return engine.run()


def serve_prefix_path(torch, ctx, cfg, weights) -> dict:
    """One request with a 512-token prefix and a 16-token suffix, one step;
    then 15 with the same prefix and distinct 8-24-token suffixes: every
    later admission adopts the prefix's 4 pages and prefills its suffix in a
    continued window through the paged window kernel (#10)."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    prefix, suffixes = _prefix_traffic(cfg)
    engine = _prefix_engine(cfg, weights)
    recs: list = []
    _instrument_engine(torch, engine, recs)
    n = cfg.n_layers
    reset_launches()  # this path's run starts here
    t0 = time.perf_counter()
    done = _prefix_run(engine, prefix, suffixes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["serve_prefix_cache"] = launches
    stats = engine.stats()
    need(len(done) == 16 and stats["prefix_hits"] == 15, f"prefix cache: {len(done)} done, stats {stats}")
    windows = [r for r in recs if r["kind"] == "prefill"]
    cont = [r for r in windows if r["cont"]]
    need(len(cont) >= 2 and all(r["launches"].get("paged_window_partials") == n for r in cont),
         f"continued windows launched {[r['launches'] for r in cont]}, expected {n} paged_window_partials each")
    for rec in recs:
        if rec["kind"] == "decode":
            need(rec["launches"].get("paged_decode") == n and "flash_decode" not in rec["launches"],
                 f"prefix cache: a decode step launched {rec['launches']}")
    ttft = sorted(r.ttft for r in done[1:])
    res = {"requests": 16, "prefix_hits": stats["prefix_hits"], "prefix_rows_reused": stats["prefix_rows_reused"],
           "continued_windows": [(r["rows"], r["seconds"] * 1e3) for r in cont],
           "first_window": (windows[0]["rows"], windows[0]["seconds"] * 1e3),
           "ttft_p50_ms_hits": statistics.median(ttft) * 1e3,
           "ttft_p90_ms_hits": statistics.quantiles(ttft, n=10)[-1] * 1e3, "wall_s": wall,
           "tok_per_s": sum(len(r.generated) for r in done) / wall, "launches": launches}
    emit({"phase": "serve", "run": "prefix cache", **res})
    del engine
    torch.cuda.empty_cache()
    return res


WINDOW_KERNEL_NAMES = ("paged_window_kernel", "paged_partial_kernel", "window_merge_kernel")  # #10's, any tree


def prefix_window_breakdown(torch, ctx, cfg, weights) -> dict:
    """Where the prefix-cache path's continued windows spend device time:
    ``serve_prefix_path``'s 16 requests on a fresh engine, each continued
    window under torch.profiler on its own, its device time (kernels,
    copies and fills) split into #10 (the window kernel, or the two-pass
    kernels' two passes), the merge glue (what ``_merge_window`` launches)
    and the rest (projections, norms, RoPE, cache writes); through entry
    points every tree has."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    prefix, suffixes = _prefix_traffic(cfg)
    engine = _prefix_engine(cfg, weights)
    merge_fn, prefill_fn = pa._merge_window, engine._prefill_paged
    windows = []

    def merge(*a, **k):
        with record_function("window_merge_glue"):
            return merge_fn(*a, **k)

    def prefill(*a, **k):  # _prefill_paged(tokens, out_idx, tables, pos): pos None for a fresh window
        if len(a) <= 3 or a[3] is None:
            return prefill_fn(*a, **k)
        before = LAUNCHES["paged_window_partials"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = prefill_fn(*a, **k)
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "window_merge_glue"]
        glue = [e for e in events if e.device_type == DeviceType.CPU and e.name == "window_merge_glue"]
        total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        w10 = sum(e.time_range.elapsed_us() for e in dev if any(n in e.name for n in WINDOW_KERNEL_NAMES)) / 1e3
        mg = sum(getattr(e, "device_time_total", 0.0) for e in glue) / 1e3
        windows.append({"rows": int(a[0].shape[1]), "batch": int(a[0].shape[0]), "device_ms": total,
                        "window_kernel_ms": w10, "merge_glue_ms": mg, "rest_ms": total - w10 - mg,
                        "device_ops": len(dev), "paged_window_launches": LAUNCHES["paged_window_partials"] - before})
        return out

    pa._merge_window, engine._prefill_paged = merge, prefill
    try:
        done = _prefix_run(engine, prefix, suffixes)
    finally:
        pa._merge_window = merge_fn
    need(len(done) == 16 and windows and all(w["paged_window_launches"] == cfg.n_layers for w in windows),
         f"prefix windows: {len(done)} done, {[w['paged_window_launches'] for w in windows]} #10 launches a window")
    keys = ("device_ms", "window_kernel_ms", "merge_glue_ms", "rest_ms")
    res = {"windows": windows, "sum": {k: sum(w[k] for w in windows) for k in keys},
           "rows": sum(w["rows"] * w["batch"] for w in windows)}
    emit({"phase": "window", "prefix_windows": res})
    del engine
    torch.cuda.empty_cache()
    return res


def serve_chunked_path(torch, ctx, cfg, weights) -> dict:
    """Chunked prefill (512-row chunks): one 3000-token prompt among 7 short
    ones; its chunks interleave with the short requests' decode steps."""
    import numpy as np

    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(SEED + 6)
    lens = [20, 3000] + [int(n) for n in rng.integers(16, 200, 6)]
    engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="paged", page_size=128,
                                      prefill_chunk=512, device=DEV)
    engine.warmup()
    recs: list = []
    _instrument_engine(torch, engine, recs)
    reset_launches()  # this path's run starts here
    t0 = time.perf_counter()
    for i, n in enumerate(lens):
        engine.submit(Request(i, [int(t) for t in rng.integers(3, cfg.vocab_size - 2, n)], max_new_tokens=32,
                              eos_token_ids=()))
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"]["serve_chunked_prefill"] = launches
    stats = engine.stats()
    need(len(done) == len(lens) and all(len(r.generated) == 32 for r in done) and stats["prefill_waves"] > 0,
         f"chunked prefill: {len(done)} done, stats {stats}")
    long_req = next(r for r in done if r.request_id == 1)
    res = {"prompt_tokens": lens, "prefill_waves": stats["prefill_waves"], "decode_steps": stats["decode_steps"],
           "wall_s": wall, "long_prompt_ttft_ms": long_req.ttft * 1e3,
           "longest_call_ms": max(r["seconds"] for r in recs) * 1e3, "launches": launches}
    emit({"phase": "serve", "run": "chunked prefill", **res})
    del engine
    torch.cuda.empty_cache()
    return res


def serve_http_path(torch, ctx, cfg, weights, tok) -> dict:
    """serve() on 127.0.0.1, port 0, in a thread: a completion, a streaming
    completion and a chat completion one at a time, each equal to the
    engine's tokens for that request alone through run(); then a burst of 8
    concurrent completions."""
    import threading
    import urllib.request

    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request, ServingFrontend, render_chat, serve

    engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="paged", page_size=128,
                                      device=DEV)
    engine.warmup()
    fe = ServingFrontend(engine, tok)
    box, bound = {}, threading.Event()
    thread = threading.Thread(target=serve, args=(fe, "127.0.0.1", 0),
                              kwargs={"ready": lambda h: (box.setdefault("httpd", h), bound.set())}, daemon=True)
    thread.start()
    need(bound.wait(60), "the HTTP server did not start")
    port = box["httpd"].server_address[1]

    def post(path, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    res = {}
    try:
        messages = [{"role": "system", "content": "be brief"}, {"role": "user", "content": prompt_text(80)}]
        cases = [
            ("completion", "/v1/completions", {"prompt": prompt_text(300), "max_tokens": 24}, prompt_text(300)),
            ("stream", "/v1/completions", {"prompt": prompt_text(90), "max_tokens": 24, "stream": True},
             prompt_text(90)),
            ("chat", "/v1/chat/completions", {"messages": messages, "max_tokens": 24}, render_chat(messages, tok)),
        ]
        answers = {}
        for name, path, payload, prompt in cases:
            t0 = time.perf_counter()
            raw = post(path, payload)
            if payload.get("stream"):
                lines = [json.loads(x) for x in raw.decode().splitlines() if x.strip()]
                need(lines[-1].get("done") and "error" not in lines[-1], f"http stream: {lines[-1]}")
                answers[name] = (tok.decode([x["token"] for x in lines if "token" in x]), prompt, payload)
            else:
                body = json.loads(raw)
                answers[name] = (body["message"]["content"] if name == "chat" else body["text"], prompt, payload)
            res[f"{name}_s"] = time.perf_counter() - t0
        stats0 = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=60).read())
        need(json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60).read())
             == {"status": "ok"}, "http /health")
        results = [None] * 8

        def one(i):
            results[i] = json.loads(post("/v1/completions", {"prompt": prompt_text(40 + 50 * i), "max_tokens": 48}))

        t0 = time.perf_counter()
        burst = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(600)
        burst_s = time.perf_counter() - t0
        need(all(r is not None and r["finish_reason"] in ("length", "stop") for r in results),
             f"http burst: {results}")
        need(fe.error is None, f"the serving worker failed: {fe.error}")
        res.update({"stats_after_three": stats0, "burst_requests": 8, "burst_s": burst_s,
                    "burst_tok_per_s": sum(r["tokens"] for r in results) / burst_s,
                    "burst_finish_reasons": sorted({r["finish_reason"] for r in results})})
    finally:
        box["httpd"].shutdown()
        thread.join(60)
    # Each of the three answers against the same request alone through run().
    for name, (text, prompt, payload) in answers.items():
        engine.submit(Request(0, tok.encode(prompt), max_new_tokens=payload["max_tokens"],
                              eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
        solo = engine.run()[-1]
        need(tok.decode(solo.generated) == text, f"http {name}: the answer differs from the request run alone")
    res["equal_to_run_alone"] = True
    emit({"phase": "serve", "run": "http", **res})
    del engine, fe
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------- spec
SPEC_K = 4  # b=1 generate: drafts a round
SPEC_NEW_TOKENS = 128
SPEC_SERVE_K = 3  # the paged 8-slot serving run: drafts a round
SPEC_SERVE_REQUESTS = 8


def parrot_weights(torch, weights):
    """``bench.py``'s parrot fixture (``BENCH_PARROT=1``): every layer's
    scales zeroed, so the residual stream is the token's embedding and the
    tied classifier's argmax repeats the input token, while the kernels
    stream the same bytes; greedy continuations repeat, and drafts are
    accepted."""
    lw = weights.layers
    zero = lambda t: t._replace(scales=torch.zeros_like(t.scales))  # noqa: E731
    return weights._replace(layers=lw._replace(wqkv=zero(lw.wqkv), wo=zero(lw.wo), w13=zero(lw.w13), w2=zero(lw.w2)))


def phase_spec(torch, ctx) -> None:
    """N-gram speculative decoding at Qwen3-8B full width, SPEC_LAYERS of its
    layers (INT8-g64,
    ctx 4096) on two fixtures, the random weights (drafts rarely accepted)
    and the parrot (drafts accepted): b=1 greedy ``generate(spec_k=4)``
    beside the plain greedy chunk (#11), and the paged bf16 8-slot serve with
    ``spec_k=3`` beside ``spec_k=0``."""
    cfg, weights, tok = model_8b(torch, ctx)
    cfg, weights = _first_layers(cfg, weights, SPEC_LAYERS)
    out = ctx["spec"] = {}
    for name, w in (("random", weights), ("parrot", parrot_weights(torch, weights))):
        out[name] = {"generate": spec_generate_path(torch, ctx, cfg, w, tok, name),
                     "serve": spec_serve_path(torch, ctx, cfg, w, name)}
        torch.cuda.empty_cache()
    emit({"phase": "spec", "summary": True, **{
        name: {"tokens_per_round": r["generate"]["tokens_per_round"], "ms_per_round": r["generate"]["ms_per_round"],
               "ms_per_token_spec": r["generate"]["ms_per_token_spec"],
               "ms_per_token_plain": r["generate"]["ms_per_token_plain"],
               "serve_tok_per_s_spec": r["serve"]["spec"]["tok_per_s"],
               "serve_tok_per_s_plain": r["serve"]["plain"]["tok_per_s"],
               "serve_spec_accept_ewma": r["serve"]["spec"]["stats"]["spec_accept_ewma"]}
        for name, r in out.items()}})


def _first_parting(torch, engine, prompt_ids, ref: list, got: list, tol: float = 2e-2) -> dict:
    """Two greedy streams of one prompt held to each other: equal up to the
    shorter's end, or parted once at a near-tie (both picks' logits within
    ``tol`` of the largest on the shared history; the streams are not
    compared past it)."""
    import numpy as np

    diff = [i for i, (x, y) in enumerate(zip(ref, got)) if x != y]
    if not diff:
        return {"equal": True, "compared": min(len(ref), len(got))}
    i = diff[0]
    lg = engine.prefill(engine.new_cache(1), np.asarray([list(prompt_ids) + ref[:i]]), np.zeros(1, np.int64))[0][0]
    lg = lg.float()
    gap = float((lg[ref[i]] - lg[got[i]]).abs())
    part = {"equal": False, "token_index": i, "tokens": [ref[i], got[i]], "pick_gap": gap,
            "max_abs_logit": float(lg.abs().max()), "tol": tol}
    need(gap <= tol * float(lg.abs().max()), f"spec: the stream parts at token {i} away from a near-tie: {part}")
    return part


def spec_generate_path(torch, ctx, cfg, weights, tok, name) -> dict:
    """b=1 greedy ``generate(spec_k=SPEC_K)``, SPEC_NEW_TOKENS new tokens:
    each round (drafted on the device, verified by a window of k + 1 rows:
    4·L + 1 launches of #3's mma route, the classifier (#1) among them,
    and the plain split attention) timed on the host clock, synchronised;
    its count read to the host once; the stream held to plain greedy's
    (``decode_chunk``, #11); ms a token of both in the same call; one round
    under torch.profiler."""
    import numpy as np

    import qwen3_rs_tpu_torch.inference.speculative as spec_mod
    from qwen3_rs_tpu_torch import Engine, TokenSampler, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n_l, k, n = cfg.n_layers, SPEC_K, SPEC_NEW_TOKENS
    engine = Engine(config=cfg, weights=weights, device=DEV)
    prompt = prompt_text(200)
    prompt_ids = tok.encode(prompt)
    window = w8a16_key(k + 1)
    per_round = {window: 4 * n_l + 1}
    rounds: list = []
    real = spec_mod.spec_round

    def timed_round(forward, carry, k_):
        before, reads = dict(LAUNCHES), spec_mod.HOST_READS["counts"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        carry, (preds, count) = real(forward, carry, k_)
        torch.cuda.synchronize()
        rounds.append({"seconds": time.perf_counter() - t, "count": count,
                       "reads": spec_mod.HOST_READS["counts"] - reads,
                       "launches": {x: LAUNCHES[x] - before[x] for x in LAUNCHES if LAUNCHES[x] != before[x]}})
        return carry, (preds, count)

    # Plain greedy reference, and its chunk's ms a token (#11, device sampling).
    plain_ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED, device=True), prompt, out=io.StringIO(),
                         max_tokens=n)
    logits, cache = engine.prefill(engine.new_cache(1), np.asarray([prompt_ids]), np.zeros(1, np.int64))
    first, pos = int(logits.float().argmax()), len(prompt_ids)
    engine.decode_chunk(cache, first, pos, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_chunk(cache, first, pos, n)
    torch.cuda.synchronize()
    plain_ms_tok = (time.perf_counter() - t0) * 1e3 / n

    spec_mod.spec_round = timed_round
    reset_launches()  # the main path's run starts here
    try:
        t0 = time.perf_counter()
        ids = generate(engine, tok, TokenSampler(0.0, 0.9, SEED, device=True), prompt, out=io.StringIO(),
                       max_tokens=n, spec_k=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        spec_mod.spec_round = real
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"][f"spec_generate_{name}"] = launches
    need(len(ids) == n and rounds, f"spec {name}: generate gave {len(ids)} tokens in {len(rounds)} rounds")
    for r in rounds:
        need(r["launches"] == per_round, f"spec {name}: a round launched {r['launches']}, expected {per_round}")
        need(r["reads"] == 1, f"spec {name}: a round read its count {r['reads']} times")
    parting = _first_parting(torch, engine, prompt_ids, plain_ids, ids)
    counts = [r["count"] for r in rounds]
    round_s = [r["seconds"] for r in rounds]
    res = {
        "k": k, "generated": len(ids), "rounds": len(rounds), "tokens_per_round": sum(counts) / len(counts),
        "ms_per_round": statistics.median(round_s) * 1e3, "ms_per_round_max": max(round_s) * 1e3,
        "count_reads": sum(r["reads"] for r in rounds),
        "ms_per_token_spec": sum(round_s) * 1e3 / sum(counts), "ms_per_token_plain": plain_ms_tok,
        "generate_wall_s": wall, "launches_per_round": per_round, "every_round_checked": True,
        "stream_vs_plain_greedy": parting,
    }
    if name == "parrot":
        need(res["tokens_per_round"] > 1.0, f"spec parrot: {res['tokens_per_round']} tokens a round")
    # One round under the profiler: device time and idle share.
    logits, cache = engine.prefill(engine.new_cache(1), np.asarray([prompt_ids]), np.zeros(1, np.int64))
    res["profile_one_round"] = profile_calls(
        torch, lambda i: engine.decode_chunk_spec(cache, first, pos, 1, k, prompt_ids + [first]), 1)
    emit({"phase": "spec", "fixture": name, "run": f"b=1 generate greedy spec_k={k}", **res, "launches": launches})
    del engine
    return res


def spec_serve_path(torch, ctx, cfg, weights, name) -> dict:
    """The serve phase's traffic cut to SPEC_SERVE_REQUESTS requests (64 new
    tokens each) on the paged bf16 pool, 8 slots, device sampling, greedy:
    ``spec_k=SPEC_SERVE_K`` (every round of a speculative chunk one window
    of 8·(k + 1) rows: 4·L + 1 launches of #3's tensor-core route and L of
    #10) beside ``spec_k=0``; streams held to each other, every page
    released."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

    n_l, k = cfg.n_layers, SPEC_SERVE_K
    traffic = _serve_traffic(cfg)[:SPEC_SERVE_REQUESTS]
    per_round = {w8a16_key(8 * (k + 1)): 4 * n_l + 1, "paged_window_partials": n_l}
    res = {}
    for run, spec_k in (("plain", 0), ("spec", k)):
        engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="paged", page_size=128,
                                          sampling="device", spec_k=spec_k, device=DEV)
        engine.warmup()
        chunks: list = []
        if spec_k:
            real = engine._decode_spec

            def timed(*a, **kw):
                before = dict(LAUNCHES)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real(*a, **kw)
                torch.cuda.synchronize()
                chunks.append({"rounds": len(out[1]), "seconds": time.perf_counter() - t,
                               "launches": {x: LAUNCHES[x] - before[x] for x in LAUNCHES if LAUNCHES[x] != before[x]}})
                return out

            engine._decode_spec = timed
        reqs = [Request(i, p, max_new_tokens=m, eos_token_ids=()) for i, (p, m) in enumerate(traffic)]
        reset_launches()  # this path's run starts here
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)  # and ends here
        ctx["path_launches"][f"spec_serve_{name}_{run}"] = launches
        need(len(done) == len(reqs) and all(len(r.generated) == r.max_new_tokens for r in done),
             f"spec serve {name} {run}: not every request completed")
        need(engine.allocator.free_pages == engine.allocator.n_pages - 1, f"spec serve {name} {run}: pages held")
        tokens = sum(len(r.generated) for r in done)
        res[run] = {"requests": len(done), "generated_tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
                    "stats": engine.stats(), "streams": {r.request_id: r.generated for r in done},
                    "launches": {x: v for x, v in launches.items() if v}}
        if spec_k:
            need(chunks, f"spec serve {name}: no speculative chunk ran")
            for c in chunks:
                want = {x: v * c["rounds"] for x, v in per_round.items()}
                need(c["launches"] == want, f"spec serve {name}: a chunk launched {c['launches']}, expected {want}")
            res[run].update({"spec_chunks": len(chunks), "spec_rounds": sum(c["rounds"] for c in chunks),
                             "ms_per_round": sum(c["seconds"] for c in chunks) * 1e3 / sum(c["rounds"] for c in chunks),
                             "launches_per_round": per_round, "every_chunk_checked": True})
            need(launches["paged_window_partials"] > 0 and launches[w8a16_key(8 * (k + 1))] > 0,
                 f"spec serve {name}: the verify windows launched {launches}")
        del engine
        torch.cuda.empty_cache()
    # A verify window's projections take #3's tensor-core route (32 rows), a
    # plain step's its mma route (8 rows): the f32 summation order of every
    # product differs, and random weights at full depth carry a flipped
    # rounding to ~3.6% of the largest logit (the sensitivity this check
    # reports), so a parting is held to MK_TOL_DEEP, as the tp phase holds
    # its own; the parrot's margins leave its streams equal.
    partings = stream_partings(torch, cfg, weights, traffic, res["plain"].pop("streams"), res["spec"].pop("streams"),
                               tol=MK_TOL_DEEP)
    need(name != "parrot" or not partings["partings"], f"spec serve parrot: streams part {partings['partings']}")
    res["spec_vs_plain"] = partings
    emit({"phase": "spec", "fixture": name, "run": f"paged bf16 8 slots spec_k={k} beside spec_k=0", **res})
    return res


# ------------------------------------------------------------------------- tp
TP_DEVICES = ["cuda:0", "cuda:0"]  # two ranks on the one card: the gloo backend
TP_LAYERS = 6  # the tp phase's depth: a sixth of 8B's, which pays for the spec, replicas, gateway, pp and sp phases (PERF.md §4)


def _rank_children(pid: int) -> list[int]:
    """The processes whose parent is ``pid``."""
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if int((d / "stat").read_text().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(d.name))
            except (OSError, IndexError, ValueError):
                pass
    return out


def _tp_breakdown(torch, engine, traffic, chunks: int = 2) -> dict:
    """Where a tp decode chunk with every slot active goes, on rank 0: 8
    requests admitted, then ``chunks`` engine steps (8 decode steps each)
    under torch.profiler, then as many with each collective bracketed by
    synchronisations (``ops.collectives.TIMING``)."""
    from qwen3_rs_tpu_torch.ops import collectives
    from qwen3_rs_tpu_torch.serving import Request

    for i in range(engine.n_slots):
        engine.submit(Request(2000 + i, traffic[i % len(traffic)][0][:200], max_new_tokens=2 * chunks * engine.decode_chunk_steps + 8,
                              eos_token_ids=()))
    engine.step()  # admits all of them
    need(engine.active_count == engine.n_slots, "tp breakdown: not every slot active")
    prof = profile_calls(torch, lambda i: engine.step(), chunks)
    collectives.TIMING.update(on=True, seconds=0.0)
    n0 = dict(collectives.COUNTS)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        collectives.TIMING["on"] = False
    engine.run()
    tokens = chunks * engine.decode_chunk_steps
    out = {"chunks": chunks, "decode_steps": tokens, "step_ms_synced": wall / tokens * 1e3,
           "collective_ms_per_step": collectives.TIMING["seconds"] / tokens * 1e3,
           "collective_share": collectives.TIMING["seconds"] / wall,
           "all_reduces_per_step": (collectives.COUNTS["all_reduce"] - n0["all_reduce"]) / tokens,
           "all_gathers_per_step": (collectives.COUNTS["all_gather"] - n0["all_gather"]) / tokens,
           "profile_rank0": prof}
    if "device_busy_ms_per_step" in prof:
        # Rank 0's trace holds its own kernels only; rank 1 launches the same
        # kernels on the same shapes (equal launch counts), so the card is
        # busy about twice as long.
        out["device_idle_share_rank0_kernels"] = prof["device_idle_share"]
        out["device_idle_share_both_ranks_est"] = 1.0 - 2 * prof["device_busy_ms_per_step"] / prof["wall_ms_per_step"]
    return out


def _tp_logits_vs_tp1(torch, engine, cfg, histories) -> list[float]:
    """The tp engine's logits for each history (a fresh admission of one
    request, read from its prefill on rank 0) against the tp=1 forward's on
    the same history: max |difference| over the largest |logit|."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.serving import Request
    from qwen3_rs_tpu_torch.testing import random_weights

    seen, real = [], engine._prefill_paged

    def keep(*a, **k):
        out = real(*a, **k)
        seen.append(out[0].float())
        return out

    engine._prefill_paged = keep
    try:
        for j, hist in enumerate(histories):
            engine.submit(Request(3000 + j, list(hist), max_new_tokens=1, eos_token_ids=()))
            engine.run()
    finally:
        engine._prefill_paged = real
    one = Engine(config=cfg, weights=random_weights(cfg, SEED, DEV), cache_dtype=torch.bfloat16, device=DEV)
    errs = []
    for hist, got in zip(histories, seen):
        ref = one.prefill(one.new_cache(1), np.asarray([hist]), np.zeros(1, np.int64))[0][0].float()
        errs.append(float((got - ref).abs().max() / ref.abs().max()))
    del one
    torch.cuda.empty_cache()
    return errs


def phase_tp(torch, ctx) -> None:
    """Tensor-parallel serving: Qwen3-8B INT8 at full width and TP_LAYERS of
    its 36 layers on 2 ranks of the one card (each 16/4 heads, 6144 hidden
    columns, half the vocabulary), the paged bf16 pool, device sampling, the
    serve phase's 24 requests, held to a tp=1 run of the same weights; then
    ``cli.py serve --tp 2``."""
    import functools

    from qwen3_rs_tpu_torch.models.qwen3 import reference_rows
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine
    from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_model

    cfg = qwen3_config("8b", seq_len=4096, n_layers=TP_LAYERS)
    traffic = _serve_traffic(cfg)
    kw = dict(n_slots=8, kv_layout="paged", page_size=128, sampling="device")
    ctx.pop("8b", None)  # the tp=1 reference and the tp ranks draw the cut model from the seed
    torch.cuda.empty_cache()
    c1, w1 = random_model(cfg, seed=SEED, device=DEV)
    engine = ContinuousBatchingEngine(config=c1, weights=w1, device=DEV, **kw)
    engine.warmup()
    ref = _serve_run(torch, ctx, "paged_bf16_device_tp1", engine, traffic, cfg.n_layers, profile=False)["streams"]
    del engine, w1
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = start_tp_engine(functools.partial(random_model, cfg, seed=SEED, device=DEV), TP_DEVICES, **kw)
    start_s = time.perf_counter() - t0
    workers = [p.pid for p in engine.mesh.workers.procs]
    engine.warmup()
    warm_s = time.perf_counter() - t0 - start_s
    mem_gb = torch.cuda.memory_allocated() / 1e9
    try:
        engine.reset_counters()  # every rank's counts start here
        run = _serve_run(torch, ctx, "tp2_paged_bf16_device", engine, traffic, cfg.n_layers, profile=False)
        reports = engine.rank_reports()  # and end here
        n = cfg.n_layers
        for rec in run.pop("prefill_records"):
            ref_rows = rec["batch"] * reference_rows(rec["rows"])
            want = 2 * 4 * n if ref_rows >= 512 else 0  # wo and w2 in 4 column chunks each
            got = rec["launches"].get("qmatmul_w8a16_rows_cols", 0)
            need(got == want, f"tp: a window of {ref_rows} reference rows launched {got} #6 column windows, not {want}")
        streams = run.pop("streams")
        need([r["rank"] for r in reports] == [0, 1], f"tp: rank reports {[r['rank'] for r in reports]}")
        need(all(r["streams"] == streams for r in reports), "tp: the ranks emitted different streams")
        need(reports[0]["launches"] == reports[1]["launches"] and reports[0]["collectives"] == reports[1]["collectives"],
             "tp: the ranks launched different kernels or collectives")
        ctx["path_launches"].pop("serve_tp2_paged_bf16_device")  # rank 0's, counted per rank below
        for r in reports:
            ctx["path_launches"][f"tp_rank{r['rank']}"] = r["launches"]
        # tp changes the f32 summation order of every wo and w2 product (two
        # partial sums, then the all-reduce), so each rounding flip is carried
        # through the later layers of random weights: at depth the two runs'
        # logits part by about the forward's sensitivity (~2e-2 of the
        # largest, reported per parting), as the megakernel's do (MK_TOL_DEEP).
        # tp_cli holds tp=2 to tp=1 at 2e-2 on a 2-layer model.
        run["greedy_vs_tp1"] = stream_partings(torch, cfg, None, traffic, ref, streams, tol=MK_TOL_DEEP)
        # The logits themselves, on the histories where the first streams
        # part: within the same bound (an error of the algorithm moves them
        # by O(1)).
        parted = run["greedy_vs_tp1"]["partings"][:2]
        hists = [list(traffic[p_["request"]][0]) + ref[p_["request"]][: p_["token_index"]] for p_ in parted]
        errs = _tp_logits_vs_tp1(torch, engine, cfg, hists or [traffic[0][0]])
        need(all(math.isfinite(e) and e <= MK_TOL_DEEP for e in errs), f"tp: logits against tp=1 rel errs {errs}")
        run["logits_vs_tp1_rel_errs"] = errs
        run["breakdown_8_active"] = _tp_breakdown(torch, engine, traffic)
    finally:
        engine.close()
    need(not any(Path(f"/proc/{pid}").exists() for pid in workers), "tp: a worker rank outlived close()")
    run.update({"backend": engine.mesh.backend, "devices": TP_DEVICES, "ranks": 2, "start_s": start_s,
                "warmup_s": warm_s, "rank0_device_memory_gb": mem_gb,
                "per_rank": [{"rank": r["rank"], "launches": {k: v for k, v in r["launches"].items() if v},
                              "collectives": r["collectives"]} for r in reports]})
    emit({"phase": "tp", "run": "8b tp=2 paged bf16 device sampling", **{k: v for k, v in run.items() if k != "launches"}})
    ctx["tp"] = {k: v for k, v in run.items() if k != "prefill_windows"}
    torch.cuda.empty_cache()
    tp_cli(torch, ctx)


def tp_cli(torch, ctx) -> None:
    """``cli.py serve --tp 2 --device cuda:0,cuda:0`` on the cli phase's
    exported dim-512 INT8 model, in a process of its own: two completions
    equal to the API's (the same tp engine through the library), whose
    prefill logits are held to the tp=1 engine's; SIGTERM stops the server
    and its worker rank.
    ``--tp 2`` with one device fails with the JAX package's message."""
    import functools
    import signal
    import urllib.request

    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.cli import main as cli_main
    from qwen3_rs_tpu_torch.parallel.distributed import free_port
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request
    from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine

    ckpt = _cli_checkpoint(ctx)
    try:
        cli_main(["serve", str(ckpt), "--tp", "2", "--device", "cuda:0"])
        need(False, "serve --tp 2 with one device did not fail")
    except SystemExit as e:
        need("needs 2 devices, have 1" in str(e), f"serve --tp 2 with one device: {e}")
    port = free_port()
    t0 = time.perf_counter()
    log = open(ctx["tmp"] / "serve_tp.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(ckpt), "--port", str(port),
                             "--slots", "4", "--tp", "2", "--device", ",".join(TP_DEVICES)],
                            cwd=ROOT, stdout=log, stderr=log)
    prompts = [prompt_text(150), prompt_text(40)]
    bodies, ranks = [], []
    try:
        ready_s = _wait_health(proc, port, ctx["tmp"] / "serve_tp.log", "cli serve --tp 2")
        for prompt in prompts:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                         data=json.dumps({"prompt": prompt, "max_tokens": 16}).encode(),
                                         headers={"Content-Type": "application/json"})
            bodies.append(json.loads(urllib.request.urlopen(req, timeout=300).read()))
        ranks = _rank_children(proc.pid)
        need(len(ranks) >= 1, "cli serve --tp 2 runs no worker rank")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()
    need(rc == 0, f"cli serve --tp 2 exited {rc} on SIGTERM: {(ctx['tmp'] / 'serve_tp.log').read_text()[-2000:]}")
    for _ in range(100):
        if not any(Path(f"/proc/{pid}").exists() for pid in ranks):
            break
        time.sleep(0.1)
    need(not any(Path(f"/proc/{pid}").exists() for pid in ranks), "cli serve --tp 2 left a worker rank behind")
    # The API's counterpart: the same tp engine through the library; each of
    # its prefill windows' logits held to the tp=1 engine's at 2e-2 of the
    # largest (2 layers: no depth to carry a rounding flip far).
    cfg, weights = load_checkpoint(ckpt)
    tok = Tokenizer(ckpt, cfg.vocab_size)
    kw = dict(n_slots=4, kv_layout="paged", sampling="device")
    engines = [start_tp_engine(functools.partial(load_checkpoint, ckpt), TP_DEVICES, **kw),
               ContinuousBatchingEngine(config=cfg, weights=weights, device=DEV, **kw)]
    seen = [[], []]
    for e, box in zip(engines, seen):
        def keep(*a, _real=e._prefill_paged, _box=box, **k):
            out = _real(*a, **k)
            _box.append(out.float().cpu())
            return out

        e._prefill_paged = keep
    try:
        for prompt, body in zip(prompts, bodies):
            for e in engines:
                e.submit(Request(0, tok.encode(prompt), max_new_tokens=16,
                                 eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
            solo = engines[0].run()[-1]
            engines[1].run()
            need(body["text"] == tok.decode(solo.generated) and body["tokens"] == len(solo.generated),
                 "cli serve --tp 2: a completion differs from the API's")
    finally:
        engines[0].close()
    errs = [float((a[:1] - b[:1]).abs().max() / b[:1].abs().max()) for a, b in zip(*seen)]
    need(len(errs) == len(prompts) and all(math.isfinite(e) and e <= 2e-2 for e in errs),
         f"tp=2 against tp=1 at 2 layers: prefill logits rel errs {errs}")
    emit({"phase": "tp", "mode": "cli serve --tp 2", "devices": TP_DEVICES, "ready_s": ready_s,
          "completions": len(bodies), "equal_to_api": True, "worker_ranks_stopped": len(ranks),
          "tp2_vs_tp1_prefill_rel_errs_2_layers": errs,
          "one_device_refused": True, "seconds": time.perf_counter() - t0})


# -------------------------------------------------- replicas, gateway, pp, sp
REPLICA_LAYERS = 18  # the replicas phase's depth, as the tp phase's: two engines on the one card


def _descendants(pid: int) -> list[int]:
    """Every process below ``pid`` (children, their children, ...)."""
    out, todo = [], [pid]
    while todo:
        kids = _rank_children(todo.pop())
        out += kids
        todo += kids
    return out


def _gone(pids) -> bool:
    for _ in range(150):
        if not any(Path(f"/proc/{p}").exists() for p in pids):
            return True
        time.sleep(0.1)
    return False


def _wait_health(proc, port: int, log: Path, what: str) -> float:
    import urllib.request

    t0 = time.perf_counter()
    for _ in range(1200):
        need(proc.poll() is None, f"{what} exited {proc.returncode}: {log.read_text()[-3000:]}")
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5).read()
            return time.perf_counter() - t0
        except OSError:
            time.sleep(0.5)
    need(False, f"{what} did not answer /health")


def _http(port: int, payload: dict) -> dict:
    """One completion over HTTP: the body, or for a streamed one its token
    ids, text and closing chunk."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    raw = urllib.request.urlopen(req, timeout=900).read().decode()
    if not payload.get("stream"):
        return json.loads(raw)
    lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
    need(lines and lines[-1].get("done") and "error" not in lines[-1], f"stream ended with {lines[-1:]}")
    return {"tokens": [x["token"] for x in lines if "token" in x], "text": "".join(x["text"] for x in lines[:-1]),
            "finish_reason": lines[-1]["finish_reason"]}


def _cli_checkpoint(ctx) -> Path:
    """The cli phase's exported 2-layer dim-512 INT8 ``.bin`` (2 kv heads, so
    that tp=2 splits them), exported here if that phase did not run."""
    from qwen3_rs_tpu_torch.cli import main as cli_main

    ckpt = ctx["tmp"] / "m8.bin"
    if not ckpt.exists():
        model = write_hf_model(ctx["tmp"] / "hf_small", SEED + 8)
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            need(cli_main(["export", str(model), str(ckpt), "-g", "64", "--format", "legacy"]) == 0, "cli export")
    return ckpt


def _api_completions(torch, ckpt, prompts: list[str], max_tokens: int, devices=None) -> list[list[int]]:
    """Each request through the library, one after the other, each alone: a
    paged device-sampling engine on ``ckpt`` (over ``devices`` with tp, one
    rank each)."""
    import functools

    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request
    from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine

    kw = dict(n_slots=4, kv_layout="paged", sampling="device")
    cfg, weights = load_checkpoint(ckpt)
    tok = Tokenizer(ckpt, cfg.vocab_size)
    engine = (start_tp_engine(functools.partial(load_checkpoint, ckpt), devices, **kw) if devices
              else ContinuousBatchingEngine(config=cfg, weights=weights, device=DEV, **kw))
    try:
        out = []
        for i, prompt in enumerate(prompts):
            engine.submit(Request(i, tok.encode(prompt), max_new_tokens=max_tokens,
                                  eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
            out.append(engine.run()[-1].generated)
        return out
    finally:
        engine.close()
        del engine
        torch.cuda.empty_cache()


def _serve_process(ctx, ckpt, flags, name):
    """``cli.py serve`` in a process of its own on a free port: (process,
    port, log path)."""
    from qwen3_rs_tpu_torch.parallel.distributed import free_port

    port = free_port()
    log = ctx["tmp"] / f"{name}.log"
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(ckpt), "--port", str(port),
                             "--slots", "4", *flags], cwd=ROOT, stdout=open(log, "w"), stderr=subprocess.STDOUT)
    return proc, port, log


def _stop(proc, what: str, log: Path, plain: bool = False) -> int:
    """SIGTERM a server; every process below it must be gone after.  A
    ``plain`` server (one engine in its process) dies of the signal; the
    others stop their engines, ranks or replicas and exit 0."""
    import signal

    below = _descendants(proc.pid)
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(180)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        need(False, f"{what} did not stop on SIGTERM: {log.read_text()[-2000:]}")
    need(rc in ((0, -signal.SIGTERM) if plain else (0,)), f"{what} exited {rc} on SIGTERM: {log.read_text()[-2000:]}")
    need(_gone(below), f"{what} left processes behind: {[p for p in below if Path(f'/proc/{p}').exists()]}")
    return len(below)


def _replica_traffic(cfg):
    """The serve phase's 24 requests as text (the HTTP front end takes text):
    the same prompt lengths (16-1024 tokens, one a byte) and 64 new tokens,
    each prompt distinct."""
    words = prompt_text(2200)
    return [(words[i * 37 % 900:][: len(p)], n) for i, (p, n) in enumerate(_serve_traffic(cfg))]


def phase_replicas(torch, ctx) -> None:
    """Replicated serving: Qwen3-8B at full width and REPLICA_LAYERS of its
    layers, two ``ContinuousBatchingEngine``s on the one card (paged bf16 pool,
    device sampling) behind ``ReplicatedFrontend`` and the HTTP front end on
    port 0: the serve phase's 24 requests, streamed, held to one engine's
    streams on the same weights behind the same front end; the prefix
    cache's affinity; then ``cli.py
    serve --replicas 2`` at tp 1 and 2 on the cli phase's exported 2-layer model."""
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, ReplicatedFrontend, ServingFrontend
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_model

    cfg = qwen3_config("8b", seq_len=4096, n_layers=REPLICA_LAYERS)
    tok = model_tokenizer(ctx, cfg)
    traffic = _replica_traffic(cfg)
    ids = [(tok.encode(p), n) for p, n in traffic]
    need([len(t) for t, _ in ids] == [len(p) for p, _ in _serve_traffic(cfg)], "replicas: the prompts' lengths")
    kw = dict(n_slots=8, kv_layout="paged", page_size=128, sampling="device")
    ctx.pop("8b", None)
    torch.cuda.empty_cache()
    _, weights = random_model(cfg, seed=SEED, device=DEV)
    out = ctx["replicas"] = {"layers": cfg.n_layers, "requests": len(traffic)}

    one = ContinuousBatchingEngine(config=cfg, weights=weights, device=DEV, **kw)
    one.warmup()
    ref_got, one_s, _ = _http_run(ServingFrontend(one, tok), traffic)
    ref = {i: g["tokens"] for i, g in enumerate(ref_got)}
    weights = one.weights  # the bf16-scale copy on the card: both replicas share it
    del one
    torch.cuda.empty_cache()

    engines = [ContinuousBatchingEngine(config=cfg, weights=weights, device=DEV, **kw) for _ in range(2)]
    for e in engines:
        e.warmup()
    reset_launches()  # this path's run starts here
    got, wall, stats = _http_run(ReplicatedFrontend([ServingFrontend(e, tok) for e in engines]), traffic)
    ctx["path_launches"]["replicas"] = dict(LAUNCHES)  # and ends here
    need(all(g["finish_reason"] in ("length", "stop") for g in got + ref_got), "replicas: not every request completed")
    per = [s["completed"] for s in stats["per_replica"]]
    need(len(per) == 2 and all(c > 0 for c in per) and sum(per) == len(traffic), f"replicas: completed {per}")
    streams = {i: g["tokens"] for i, g in enumerate(got)}
    # The replicas admit other groups than one engine does, whose windows take
    # other routes (#3's tensor cores or #6 by the group's rows): their
    # roundings, carried through 18 layers of random weights, part greedy
    # streams by about the forward's sensitivity (~2.5%, reported per
    # parting), as the tp phase's do: MK_TOL_DEEP.
    partings = stream_partings(torch, cfg, weights, ids, ref, streams, tol=MK_TOL_DEEP)
    tokens = sum(len(s) for s in streams.values())
    out.update({"per_replica_completed": per, "wall_s": wall, "tok_per_s": tokens / wall,
                "one_engine_tok_per_s": sum(len(r) for r in ref.values()) / one_s, "one_engine_wall_s": one_s,
                "greedy_vs_one_engine": partings,
                "launches": {k: v for k, v in LAUNCHES.items() if v}})
    emit({"phase": "replicas", "run": "2 x 8b/18 layers, paged bf16, device sampling, HTTP",
          **{k: v for k, v in out.items() if k != "launches"}})
    del engines
    torch.cuda.empty_cache()
    out["prefix_affinity"] = replicas_prefix_path(torch, cfg, weights, tok)
    del weights
    torch.cuda.empty_cache()
    out["cli"] = replicas_cli(torch, ctx)


def _http_run(frontend, traffic) -> tuple[list, float, dict]:
    """``traffic`` (text prompts, new tokens) posted at once, streamed, to
    ``serve(frontend)`` on port 0: each request's ids and closing chunk, the
    wall time and the front end's stats; the server is stopped after."""
    import threading

    from qwen3_rs_tpu_torch.serving import serve

    box, bound = {}, threading.Event()
    thread = threading.Thread(target=serve, args=(frontend, "127.0.0.1", 0),
                              kwargs={"ready": lambda h: (box.setdefault("httpd", h), bound.set())}, daemon=True)
    thread.start()
    need(bound.wait(60), "the HTTP server did not start")
    port = box["httpd"].server_address[1]
    got = [None] * len(traffic)

    def post(i):
        prompt, n = traffic[i]
        got[i] = _http(port, {"prompt": prompt, "max_tokens": n, "stream": True})

    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(len(traffic))]
        for t in posts:
            t.start()
        for t in posts:
            t.join(900)
        wall = time.perf_counter() - t0
        stats = frontend.stats()
    finally:
        box["httpd"].shutdown()
        thread.join(60)
    need(all(g is not None for g in got), "a request got no answer")
    return got, wall, stats


def model_tokenizer(ctx, cfg):
    """The 8B vocabulary's tokenizer (every id distinct bytes), made once."""
    from qwen3_rs_tpu_torch import Tokenizer

    if "8b_tok" not in ctx:
        tdir = ctx["tmp"] / "tok"
        tdir.mkdir(exist_ok=True)
        write_tokenizer(tdir / "tokenizer.bin", cfg.vocab_size)
        write_templates(tdir)
        ctx["8b_tok"] = Tokenizer(tdir, cfg.vocab_size)
    return ctx["8b_tok"]


def replicas_prefix_path(torch, cfg, weights, tok) -> dict:
    """Two prefix-caching replicas: 6 requests sharing a 700-character head,
    one after the other, all go to the replica that computed the head first
    and hit its cache (5 hits), none to the other."""
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, ReplicatedFrontend, ServingFrontend

    engines = [ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=8, kv_layout="paged", page_size=128,
                                        sampling="device", prefix_cache=True, device=DEV) for _ in range(2)]
    router = ReplicatedFrontend([ServingFrontend(e, tok) for e in engines])
    head = prompt_text(700)
    try:
        for i in range(6):
            p = router.submit(head + f" question {i}", max_tokens=8)
            need(p.done.wait(600) and p.error is None, f"replicas prefix: request {i} failed: {p.error}")
        done = [e.stats()["completed"] for e in engines]
        hits = [e.stats()["prefix_hits"] for e in engines]
    finally:
        router.shutdown()
    need(sorted(done) == [0, 6] and sorted(hits) == [0, 5], f"replicas prefix: completed {done}, hits {hits}")
    res = {"completed": done, "prefix_hits": hits, "head_chars": len(head)}
    emit({"phase": "replicas", "run": "prefix affinity", **res})
    return res


def replicas_cli(torch, ctx) -> dict:
    """``cli.py serve --replicas 2 --device cuda:0,cuda:0`` (two engines in
    the server's process) and ``--replicas 2 --tp 2`` over four ranks of the
    card (a ``serve --tp 2`` process a replica) on the cli phase's exported 2-layer model:
    a completion each equal to the API's; SIGTERM leaves no process."""
    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.configuration import read_config

    ckpt = _cli_checkpoint(ctx)
    tok = Tokenizer(ckpt, read_config(ckpt).vocab_size)
    prompt = prompt_text(150)
    res = {}
    for tp in (1, 2):
        t0 = time.perf_counter()
        devices = [TP_DEVICES[0]] * (2 * tp)
        proc, port, log = _serve_process(ctx, ckpt, ["--replicas", "2", "--tp", str(tp), "--device", ",".join(devices)],
                                         f"replicas_tp{tp}")
        try:
            ready = _wait_health(proc, port, log, f"serve --replicas 2 --tp {tp}")
            bodies = [_http(port, {"prompt": prompt, "max_tokens": 16}) for _ in range(2)]
            stopped = _stop(proc, f"serve --replicas 2 --tp {tp}", log)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        want = _api_completions(torch, ckpt, [prompt], 16, devices[:tp] if tp > 1 else None)[0]
        need(all(b["text"] == tok.decode(want) and b["tokens"] == len(want) for b in bodies),
             f"serve --replicas 2 --tp {tp}: a completion differs from the API's")
        need(stopped >= (4 if tp > 1 else 0), f"serve --replicas 2 --tp {tp} ran {stopped} processes below it")
        res[f"tp{tp}"] = {"ready_s": ready, "completions": len(bodies), "equal_to_api": True,
                          "processes_stopped": stopped, "seconds": time.perf_counter() - t0}
    emit({"phase": "replicas", "mode": "cli serve --replicas 2", **res})
    return res


def _cuda_pids() -> list[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _opens_card(pid: int) -> bool:
    """Whether the process holds the card's device files (``/dev/nvidia*``,
    which a CUDA context opens and maps; loading a CUDA library does not)."""
    try:
        fds = [os.readlink(f) for f in Path(f"/proc/{pid}/fd").iterdir()]
        return any(f.startswith("/dev/nvidia") for f in fds) or "/dev/nvidia" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def phase_gateway(torch, ctx) -> None:
    """The cross-host gateway: two ``cli.py serve`` workers on the card (the
    cli phase's exported 2-layer model) and ``cli.py serve --gateway URL,URL`` in front of
    them: whole and streamed completions equal the API's; the gateway never
    touched the card (absent from ``nvidia-smi``'s compute processes, no
    ``/dev/nvidia*`` file open or mapped, as each worker has); SIGTERM stops
    each."""
    import threading
    import urllib.request

    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.configuration import read_config

    ckpt = _cli_checkpoint(ctx)
    tok = Tokenizer(ckpt, read_config(ckpt).vocab_size)
    t0 = time.perf_counter()
    workers = [_serve_process(ctx, ckpt, ["--device", DEV], f"worker{i}") for i in range(2)]
    gw = None
    try:
        for i, (proc, port, log) in enumerate(workers):
            _wait_health(proc, port, log, f"worker {i}")
        urls = ",".join(f"http://127.0.0.1:{port}" for _, port, _ in workers)
        gw = _serve_process(ctx, ckpt, ["--gateway", urls], "gateway")
        ready = _wait_health(gw[0], gw[1], gw[2], "the gateway")
        prompts = [prompt_text(150), prompt_text(60), prompt_text(333), prompt_text(90)]
        bodies = [None] * len(prompts)

        def post(i):  # at once, so that the router spreads them
            bodies[i] = _http(gw[1], {"prompt": prompts[i], "max_tokens": 16, "stream": i % 2 == 1})

        posts = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
        for t in posts:
            t.start()
        for t in posts:
            t.join(600)
        need(all(b is not None for b in bodies), "gateway: a request got no answer")
        stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{gw[1]}/v1/stats", timeout=60).read())
        listed = _cuda_pids()
        gw_listed, gw_opens = gw[0].pid in listed, _opens_card(gw[0].pid)
        workers_listed = [p.pid in listed for p, _, _ in workers]
        workers_open = [_opens_card(p.pid) for p, _, _ in workers]
        _stop(gw[0], "the gateway", gw[2])
        for i, (proc, _, log) in enumerate(workers):
            _stop(proc, f"worker {i}", log, plain=True)
    finally:
        for proc, _, _ in workers + ([gw] if gw else []):
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    need(not gw_listed and not gw_opens, f"the gateway process is on the card (nvidia-smi {gw_listed}, "
                                         f"device files {gw_opens})")
    need(all(workers_open), "a worker holds no device file: the gateway's check would be blind")
    need(stats.get("replicas") == 2 and sum(stats["per_replica"][i]["completed"] for i in range(2)) == len(prompts),
         f"gateway stats {stats}")
    for body, want in zip(bodies, _api_completions(torch, ckpt, prompts, 16)):
        if isinstance(body["tokens"], list):  # streamed: the ids (a trailing partial UTF-8 piece is never sent)
            same = body["tokens"] == want and tok.decode(want).startswith(body["text"])
        else:
            same = body["tokens"] == len(want) and body["text"] == tok.decode(want)
        need(same, f"gateway: a completion differs from the API's: {body} against {want}")
    need(all(s["completed"] > 0 for s in stats["per_replica"]), f"gateway: a worker took no request: {stats}")
    res = {"workers": 2, "ready_s": ready, "completions": len(bodies), "streamed": 2, "equal_to_api": True,
           "gateway_in_nvidia_smi": False, "gateway_device_files": False, "workers_in_nvidia_smi": workers_listed,
           "workers_device_files": workers_open,
           "per_worker_completed": [s["completed"] for s in stats["per_replica"]],
           "seconds": time.perf_counter() - t0}
    ctx["gateway"] = res
    emit({"phase": "gateway", **res})


PP_RANKS_LAYERS = 36  # the pp phase: 8B at full depth, half a rank
PP_BATCH, PP_MICRO, PP_PROMPT, PP_STEPS = 4, 2, 128, 8


def _pp_run(mesh, cfg, seed: int, steps: int, picks=None):
    """The pp phase's calls on this rank (every rank of the group runs it):
    the weights of ``seed`` drawn on the card (bf16 scales, as the fast
    engine keeps them), a fresh 128-row prefill of ``PP_BATCH`` requests and
    ``steps`` greedy decode steps through ``pipelined_forward`` (``picks``:
    each step's tokens given, not the argmax); returns the logits of each
    call on the host, each call's synchronised host seconds and this rank's
    launches (gathered to rank 0 over a group)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.parallel import pipelined_forward
    from qwen3_rs_tpu_torch.testing import random_weights

    dev = mesh.device
    weights = cast_weight_scales(random_weights(cfg, seed, device=dev))
    tokens = np.random.default_rng(seed + 3).integers(3, cfg.vocab_size - 2, (PP_BATCH, PP_PROMPT))
    cache = init_kv_cache(cfg, PP_BATCH, dtype=torch.bfloat16, device=dev)
    leaves = [t for leaf in (*weights.layers, weights.embed, weights.lm_head, *cache)
              for t in (leaf if isinstance(leaf, tuple) else (leaf,))]
    need(all(t.device == dev for t in leaves), f"pp rank {mesh.rank}: a tensor is not on {dev}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    reset_launches()
    logits, seconds, pos = [], [], np.zeros(PP_BATCH, np.int64)
    for i in range(steps + 1):
        t0 = time.perf_counter()
        lg, _ = pipelined_forward(cfg, weights, tokens, cache, pos, mesh, n_microbatches=PP_MICRO)
        sync()
        seconds.append(time.perf_counter() - t0)
        logits.append(lg.float().cpu())
        pos = pos + tokens.shape[1]
        tokens = (lg.argmax(-1).cpu().numpy() if picks is None else picks[i])[:, None]
    counts = [dict(LAUNCHES)]
    if len(mesh.devices) > 1:
        counts = [None] * len(mesh.devices) if mesh.rank == 0 else None
        dist.gather_object(dict(LAUNCHES), counts, dst=0)
    return logits, seconds, counts, (cache.k[0].cpu(), cache.v[0].cpu())  # rank 0's first layer: the model's


def phase_pp(torch, ctx) -> None:
    """Pipeline parallelism: Qwen3-8B at full depth, 2 ranks on the one card
    (gloo), 18 layers a rank, fast mode, B=4 in 2 microbatches: a fresh
    128-row prefill and 8 greedy decode steps, held to ``pipelined_forward``
    at pp=1 on one rank (the same routes) within 2e-2·max|logits| and to the
    dense ``qwen3_forward`` (the engine's routes: #6, the megakernel): layer
    0's cache rows within 1e-2, the logits within MK_TOL_DEEP or twice their
    move under one rounding, greedy tokens equal but at a near-tie; each rank's #1-#3 launches the
    schedule's count, bubble ticks included; ms a pipelined step beside the
    one-rank step."""
    import numpy as np

    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache, qwen3_forward
    from qwen3_rs_tpu_torch.parallel import create_pp_mesh, launch
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    cfg = qwen3_config("8b", seq_len=4096, n_layers=PP_RANKS_LAYERS)
    ctx.pop("8b", None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = launch(TP_DEVICES, _pp_run, cfg, SEED, PP_STEPS, axis="pp")
    try:
        need(mesh.backend == "gloo" and mesh.shape == {"pp": 2} and mesh.devices == tuple(map(torch.device, TP_DEVICES)),
             f"pp mesh {mesh.devices} {mesh.shape} {mesh.backend}")
        got, got_s, counts, kv0 = _pp_run(mesh, cfg, SEED, PP_STEPS)
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    picks = [g.argmax(-1).numpy() for g in got]  # the pipeline's picks: every reference call sees its history
    one, one_s, _, _ = _pp_run(create_pp_mesh(1, TP_DEVICES[:1]), cfg, SEED, PP_STEPS, picks)
    # The schedule: 3 ticks (2 microbatches over 2 stages) × 18 layers × 4
    # projections at the microbatch's rows, and the classifier at B rows.
    ticks, l_loc = PP_MICRO + 2 - 1, cfg.n_layers // 2
    want = {}
    for rows in [PP_PROMPT * PP_BATCH // PP_MICRO] + [PP_BATCH // PP_MICRO] * PP_STEPS:
        want[w8a16_key(rows)] = want.get(w8a16_key(rows), 0) + ticks * l_loc * 4
        want[w8a16_key(PP_BATCH)] = want.get(w8a16_key(PP_BATCH), 0) + 1
    for r, c in enumerate(counts):
        made = {k: v for k, v in c.items() if v}
        need(made == want, f"pp rank {r} launched {made}, the schedule's count is {want}")
        ctx["path_launches"][f"pp_rank{r}"] = c
    # Against pp=1 and the dense forward, on the same tokens.
    weights = cast_weight_scales(random_weights(cfg, SEED, device=DEV))
    tokens = np.random.default_rng(SEED + 3).integers(3, cfg.vocab_size - 2, (PP_BATCH, PP_PROMPT))
    cache = init_kv_cache(cfg, PP_BATCH, dtype=torch.bfloat16, device=DEV)
    dense, pos = [], np.zeros(PP_BATCH, np.int64)
    for i in range(PP_STEPS + 1):
        lg, cache = qwen3_forward(cfg, weights, tokens, cache, pos, fresh_prefill=i == 0)
        dense.append(lg.float().cpu())
        pos = pos + tokens.shape[1]
        tokens = picks[i][:, None]
    # Layer 0's K/V rows come from the same math on the same rows (no
    # attention before them): the pipeline wrote them where the dense
    # forward does.
    rows = PP_PROMPT + PP_STEPS
    kv0_err = max(float((a[..., :rows, :].float() - b[0, ..., :rows, :].float().cpu()).abs().max()
                        / b[0, ..., :rows, :].float().abs().max()) for a, b in zip(kv0, (cache.k, cache.v)))
    need(kv0_err <= 1e-2, f"pp cache rows of layer 0 against the dense forward: rel err {kv0_err}")
    # How far a rounding moves these logits: one norm weight of layer 0 scaled
    # by 1 + 2^-7 in the dense prefill.
    lw = weights.layers
    nudged = lw.rms_att.clone()
    nudged[0, 0] *= 1 + 2.0**-7
    tokens = np.random.default_rng(SEED + 3).integers(3, cfg.vocab_size - 2, (PP_BATCH, PP_PROMPT))
    lg_n, _ = qwen3_forward(cfg, weights._replace(layers=lw._replace(rms_att=nudged)), tokens,
                            init_kv_cache(cfg, PP_BATCH, dtype=torch.bfloat16, device=DEV), np.zeros(PP_BATCH, np.int64),
                            fresh_prefill=True)
    sensitivity = float((lg_n.float().cpu() - dense[0]).abs().max() / dense[0].abs().max())
    del weights, cache, nudged, lg_n
    torch.cuda.empty_cache()
    # pp=1 takes the same routes on the same microbatches: 2e-2 (it is bit for
    # bit on the CPU).  The dense forward takes others (#6 at 512 rows, the
    # fused glue or #11), whose f32 sums round otherwise, carried through 36
    # layers of random weights: MK_TOL_DEEP, as the megakernel's and tp's deep
    # checks, or twice the logits' move under one rounding (``sensitivity``)
    # where that is larger; a fault of the schedule moves them by O(1).
    deep = max(MK_TOL_DEEP, 2 * sensitivity)
    errs = {"vs_pp1": [], "vs_dense": []}
    ties = []
    for i, (g, o, d) in enumerate(zip(got, one, dense)):
        for name, ref in (("vs_pp1", o), ("vs_dense", d)):
            tol = deep if name == "vs_dense" else 2e-2
            err = float((g - ref).abs().max() / ref.abs().max())
            errs[name].append(err)
            need(math.isfinite(err) and err <= tol, f"pp call {i} {name}: rel err {err} (limit {tol})")
            a, b = g.argmax(-1), ref.argmax(-1)
            for row in (a != b).nonzero().flatten().tolist():
                gap = float((ref[row, a[row]] - ref[row, b[row]]).abs() / ref[row].abs().max())
                ties.append({"call": i, "row": row, name: gap})
                need(gap <= tol, f"pp call {i} row {row} {name}: greedy picks part {gap} away from a near-tie")
    res = {"layers": cfg.n_layers, "ranks": 2, "devices": TP_DEVICES, "backend": "gloo", "batch": PP_BATCH,
           "microbatches": PP_MICRO, "prompt_rows": PP_PROMPT, "decode_steps": PP_STEPS,
           "launches_per_rank": want, "rel_err_max": {k: max(v) for k, v in errs.items()},
           "prefill_rel_err_vs_dense": errs["vs_dense"][0], "dense_sensitivity": sensitivity, "deep_tol": deep,
           "layer0_kv_rel_err_vs_dense": kv0_err, "greedy_partings": ties,
           "prefill_ms": {"pp2": got_s[0] * 1e3, "pp1": one_s[0] * 1e3},
           "decode_step_ms": {"pp2": statistics.median(got_s[1:]) * 1e3, "pp1": statistics.median(one_s[1:]) * 1e3},
           "seconds": time.perf_counter() - t0}
    ctx["pp"] = res
    emit({"phase": "pp", **res})


SP_LAYERS, SP_PROMPT, SP_STEPS = 18, 4096, 32


def phase_sp(torch, ctx) -> None:
    """Sequence parallelism: Qwen3-8B at full width and 18 layers, 2 ranks on
    the one card (gloo), ``sp_threshold=4096``, a fresh 4096-token prompt:
    the ring's window (no #5 launch; each rank 4·L #6 launches on its 2048
    rows) held to the one-rank 4096-row window (#5 + #6): layer 0's cache
    rows within 1e-2, the logits within MK_TOL_DEEP·max|logits| or twice their
    move under one rounding; 32 greedy decode steps from the sp-built cache (rank 0,
    #11) held to the one-rank stream but at a near-tie; then ``cli.py
    inference --sp 2``."""
    import functools

    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.inference.engine import start_sp_engine
    from qwen3_rs_tpu_torch.models.qwen3 import qwen3_forward
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_model

    # Room for the decode steps, the cache a multiple of 128 rows as the
    # megakernel's gate asks.
    cfg = qwen3_config("8b", seq_len=SP_PROMPT + 128, n_layers=SP_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = start_sp_engine(functools.partial(random_model, cfg, seed=SEED, device=DEV), TP_DEVICES,
                             sp_threshold=SP_PROMPT, cache_dtype=torch.bfloat16)
    prompt = np.random.default_rng(SEED + 4).integers(3, cfg.vocab_size - 2, (1, SP_PROMPT))
    try:
        need(engine.sp_mesh.backend == "gloo", f"sp backend {engine.sp_mesh.backend}")
        need(all(t.device.type == "cuda" for t in (engine.weights.embed.q, engine.weights.layers.wqkv.q)),
             "sp: the weights are not on the card")
        times = []
        for i in range(3):  # the first builds and warms; the last two are timed
            engine.reset_counters()  # every rank's counts start here
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = engine.prefill(engine.new_cache(), prompt, np.zeros(1, np.int64))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            reports = engine.rank_reports()  # and end here
        for r in reports:
            made = {k: v for k, v in r["launches"].items() if v}
            want = {"qmatmul_w8a16_rows": 4 * cfg.n_layers, **({w8a16_key(1): 1} if r["rank"] == 0 else {})}
            need(made == want, f"sp rank {r['rank']} launched {made}, expected {want}")
            ctx["path_launches"][f"sp_rank{r['rank']}"] = r["launches"]
        reset_launches()
        ids = [int(logits.float().argmax())]
        dec = []
        for i in range(SP_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = engine.decode_step(cache, [ids[-1]], [SP_PROMPT + i])
            ids.append(int(lg.float().argmax()))
            dec.append(time.perf_counter() - t1)
        need(LAUNCHES["decode_megakernel"] == SP_STEPS, f"sp decode: {LAUNCHES['decode_megakernel']} #11 launches")
        ctx["path_launches"]["sp_decode"] = dict(LAUNCHES)

        one = Engine(config=cfg, weights=engine.weights, cache_dtype=torch.bfloat16, device=DEV)
        one_times = []
        for i in range(3):
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref, rcache = qwen3_forward(cfg, one.weights, prompt, one.new_cache(), [0], fresh_prefill=True)
            torch.cuda.synchronize()
            one_times.append(time.perf_counter() - t1)
        need(LAUNCHES["causal_prefill_attention"] == cfg.n_layers, "the one-rank window took no #5")
        # Layer 0's K/V rows come from the same kernels on the same rows: the
        # gather wrote them where the one-rank window does.  The logits
        # differ by the attention's roundings (the ring in f32, #5 on bf16
        # products), carried through 18 layers of random weights: MK_TOL_DEEP,
        # or twice their move under one rounding (one norm weight of layer 0
        # scaled by 1 + 2^-7) where that is larger.
        kv0 = max(float((a[0, :, :, :SP_PROMPT].float() - b[0, :, :, :SP_PROMPT].float()).abs().max()
                        / b[0, :, :, :SP_PROMPT].float().abs().max())
                  for a, b in ((cache.k, rcache.k), (cache.v, rcache.v)))  # the decode steps wrote past the prompt
        need(kv0 <= 1e-2, f"sp cache rows of layer 0 against one rank: rel err {kv0}")
        lw = one.weights.layers
        nudged = lw.rms_att.clone()
        nudged[0, 0] *= 1 + 2.0**-7
        ref_n, _ = qwen3_forward(cfg, one.weights._replace(layers=lw._replace(rms_att=nudged)), prompt,
                                 one.new_cache(), [0], fresh_prefill=True)
        sensitivity = float((ref_n.float() - ref.float()).abs().max() / ref.float().abs().max())
        deep = max(MK_TOL_DEEP, 2 * sensitivity)
        del ref_n, nudged
        err = float((logits.float() - ref.float()).abs().max() / ref.float().abs().max())
        need(math.isfinite(err) and err <= deep, f"sp window logits against one rank: rel err {err} (limit {deep})")
        ref_ids = [int(ref.float().argmax())]
        for i in range(SP_STEPS):
            lg, rcache = one.decode_step(rcache, [ref_ids[-1]], [SP_PROMPT + i])
            ref_ids.append(int(lg.float().argmax()))
        parting = None
        if ids != ref_ids:
            i = next(j for j, (a, b) in enumerate(zip(ids, ref_ids)) if a != b)
            hist = np.concatenate([prompt[0], ref_ids[:i]])[None]
            lg = one.prefill(one.new_cache(), hist, np.zeros(1, np.int64))[0][0].float()
            gap = float((lg[ids[i]] - lg[ref_ids[i]]).abs() / lg.abs().max())
            parting = {"token_index": i, "pick_gap": gap}
            need(gap <= 2e-2, f"sp decode parts from one rank at token {i}, {gap} away from a near-tie")
        del one
    finally:
        engine.close()
    torch.cuda.empty_cache()
    res = {"layers": cfg.n_layers, "ranks": 2, "devices": TP_DEVICES, "backend": "gloo", "prompt_rows": SP_PROMPT,
           "rows_a_rank": SP_PROMPT // 2, "launches_per_rank": [{k: v for k, v in r["launches"].items() if v}
                                                               for r in reports],
           "exchanges_per_rank": [r["collectives"]["exchange"] for r in reports],
           "prefill_ms": {"sp2": statistics.median(times[1:]) * 1e3, "one_rank": statistics.median(one_times[1:]) * 1e3},
           "logits_rel_err": err, "sensitivity": sensitivity, "deep_tol": deep, "layer0_kv_rel_err": kv0,
           "decode_steps": SP_STEPS, "decode_step_ms": statistics.median(dec) * 1e3,
           "greedy_equal": ids == ref_ids, "parting": parting, "seconds": time.perf_counter() - t0}
    emit({"phase": "sp", **res})
    res["cli"] = sp_cli(torch, ctx)
    ctx["sp"] = res


def sp_cli(torch, ctx) -> dict:
    """``cli.py inference --sp 2 --sp-threshold 256 --device cuda:0,cuda:0``
    on the cli phase's exported 2-layer model in a process of its own: its text equals the
    API's (``start_sp_engine`` and ``generate`` on the same ranks), and
    ``--sp 2`` with one device is refused."""
    import functools

    from qwen3_rs_tpu_torch import Tokenizer, TokenSampler, generate
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.configuration import read_config
    from qwen3_rs_tpu_torch.inference.engine import start_sp_engine

    ckpt = _cli_checkpoint(ctx)
    prompt = prompt_text(300)
    flags = ["-m", "generate", "-i", prompt, "-t", "0", "-s", "5", "-c", "1024", "--sp", "2",
             "--sp-threshold", "256"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "inference", str(ckpt), *flags,
                          "--device", ",".join(TP_DEVICES)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    need(run.returncode == 0, f"cli inference --sp 2 exited {run.returncode}: {run.stderr[-2000:]}")
    cli_s = time.perf_counter() - t0
    one_dev = subprocess.run([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "inference", str(ckpt), *flags,
                              "--device", TP_DEVICES[0]], cwd=ROOT, capture_output=True, text=True, timeout=300)
    need(one_dev.returncode != 0 and "--sp 2 needs 2 devices, have 1" in one_dev.stderr,
         f"--sp 2 with one device: {one_dev.stderr[-500:]}")
    engine = start_sp_engine(functools.partial(load_checkpoint, ckpt), TP_DEVICES, ctx_length=1024,
                             sp_threshold=256)
    seen = []
    real = engine._sync

    def sync(op, payload=None):
        seen.append(op)
        return real(op, payload)

    engine._sync = sync
    try:
        api = io.StringIO()
        generate(engine, Tokenizer(ckpt, read_config(ckpt).vocab_size), TokenSampler(0.0, 0.9, 5), prompt, out=api)
    finally:
        engine.close()
    need("prefill" in seen, "the API's prompt did not take the sp window")
    need(run.stdout == api.getvalue() and len(run.stdout) > len(prompt), "cli inference --sp 2 differs from the API's")
    res = {"prompt_chars": len(prompt), "chars_out": len(run.stdout), "equal_to_api": True, "seconds": cli_s,
           "one_device_refused": True}
    emit({"phase": "sp", "mode": "cli inference --sp 2", **res})
    return res


# -------------------------------------------------------------------- scaling
SCALING_LAYERS = 4  # the scaling phase's depth: 8B at full width, a ninth of its 36 layers
SCALING_SEQ, SCALING_STEPS = 1024, 16
SCALING_CASES = ((1, (1, 2)), (2, (2, 4)))  # (tp_per_group, device counts): dp 2 at tp 1; tp 2 at dp 1 and 2


def phase_scaling(torch, ctx) -> None:
    """``parallel.scaling_report``: Qwen3-8B INT8-g64 at full width and
    SCALING_LAYERS (4) layers, ctx 1024, one row a replica, greedy fast-mode
    decode of SCALING_STEPS (16) and 4 steps, at device counts [1, 2] with
    tp 1 (dp 2) and [2, 4] with tp 2 (dp 1 and dp 2 × tp 2: the one case
    whose tp subgroup is not the whole group), the ranks sharing the card
    over gloo, each drawing the seed's weights and keeping its shard.  Each
    measurement (``distributed.decode_run``) is recorded with every rank's
    tokens and rank 0's launches: at tp 1 every replica's tokens equal the
    one-rank tokens and each step is one #11 launch; at tp 2 every rank's
    tokens are equal, each step is 4·L + 1 #1-#3 launches on the row route
    and L #4 launches, and the tokens are held to tp 1's (equal, or parted
    once at a near-tie within MK_TOL_DEEP).  Throughput and efficiency are
    the path's cost on one card over gloo, not the value of dp or tp."""
    import functools

    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.parallel import distributed
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    cfg = qwen3_config("8b", seq_len=SCALING_SEQ, n_layers=SCALING_LAYERS)
    ctx.pop("8b", None)
    torch.cuda.empty_cache()
    rank_dev = "cpu" if DEV == "cpu" else "cuda:0"
    source = functools.partial(random_weights, cfg, SEED, DEV)  # drawn on each rank, not pickled to it
    runs = {}
    real = distributed.decode_run

    def recorded(config, weights, devices, *, tp, **kw):
        reset_launches()
        t0 = time.perf_counter()
        out = real(config, weights, devices, tp=tp, **kw)
        runs[(tp, len(devices))] = dict(out, launches={k: v for k, v in LAUNCHES.items() if v},
                                        wall_seconds=time.perf_counter() - t0)
        return out

    t_all = time.perf_counter()
    reports = {}
    distributed.decode_run = recorded
    try:
        for tp, counts in SCALING_CASES:
            reports[tp] = distributed.scaling_report(cfg, source, device_counts=list(counts), tp_per_group=tp,
                                                     batch_per_dp=1, steps=SCALING_STEPS,
                                                     devices=[rank_dev] * max(counts))
    finally:
        distributed.decode_run = real
    steps_all = 3 * (SCALING_STEPS + max(SCALING_STEPS // 4, 1))  # a warm and two timed runs at each length
    L = cfg.n_layers
    ref = runs[(1, 1)]["tokens"][0][0].tolist()
    cases = []
    for (tp, n), run in sorted(runs.items()):
        toks = [t[0].tolist() for t in run["tokens"]]
        need(len(toks) == n and all(len(t) == SCALING_STEPS for t in toks), f"scaling tp={tp} n={n}: tokens {toks}")
        if tp == 1:
            need(all(t == ref for t in toks), f"scaling dp={n}: a replica's tokens differ from one rank's: {toks}, {ref}")
            want = {"decode_megakernel": steps_all}
        else:
            need(all(t == toks[0] for t in toks), f"scaling tp=2 n={n}: the ranks' tokens differ: {toks}")
            want = {w8a16_key(1): steps_all * (4 * L + 1), "flash_decode": steps_all * L}
        need(run["launches"] == want, f"scaling tp={tp} n={n}: rank 0 launched {run['launches']}, want {want}")
        ctx["path_launches"][f"scaling_tp{tp}_n{n}"] = run["launches"]
        cases.append({"tp": tp, "dp": n // tp, "ranks": n, "tokens_rank0": toks[0], "launches_rank0": want,
                      "seconds_long_short": run["seconds"], "wall_seconds": run["wall_seconds"]})
    # tp 2 against tp 1: the first step's logits, and the streams.
    tp2 = runs[(2, 2)]
    lg1, lg2 = runs[(1, 1)]["logits"][0], tp2["logits"][0]
    logit_err = float(np.abs(lg2 - lg1).max() / np.abs(lg1).max())
    need(math.isfinite(logit_err) and logit_err <= MK_TOL_DEEP, f"scaling tp=2 first-step logits vs tp=1: {logit_err}")
    got = tp2["tokens"][0][0].tolist()
    if got == ref:
        parting = {"equal": True, "compared": len(ref)}
    else:
        engine = Engine(config=cfg, weights=random_weights(cfg, SEED, DEV), cache_dtype=torch.bfloat16, device=DEV)
        parting = _first_parting(torch, engine, [1], ref, got, tol=MK_TOL_DEEP)
        del engine
        torch.cuda.empty_cache()
    label = "ranks sharing one card over gloo: the path's cost on one card, not the value of dp or tp"
    for tp, rep in reports.items():
        emit({"phase": "scaling", "tp_per_group": tp, "throughput_tok_s": rep["throughput"],
              "efficiency": rep["efficiency"], "what": label})
    res = {"layers": L, "seq_len": SCALING_SEQ, "steps": SCALING_STEPS, "batch_per_dp": 1, "devices": rank_dev,
           "backend": "gloo", "what": label,
           "reports": {str(tp): {k: {str(n): v for n, v in r.items()} for k, r in rep.items()}
                       for tp, rep in reports.items()},
           "cases": cases, "tp2_vs_tp1": {"first_logits_rel_err": logit_err, "tol": MK_TOL_DEEP, **parting},
           "seconds": time.perf_counter() - t_all}
    ctx["scaling"] = res
    emit({"phase": "scaling", **res})


# --------------------------------------------------------------------- native
NATIVE_W13 = (24576, 4096)  # the 8B's w13 as a checkpoint stores it: [out, in] codes, [out, in / 64] scales


def _host_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native(torch, ctx) -> None:
    """The port's C++ host helper (``utils.native``, built with the host
    compiler from ``qwen3_rs_tpu_torch/csrc/*.cpp``): loaded from the port's
    build directory (no other host helper mapped), its BPE encoder equal to
    the Python encoder on the smoke's tokenizer, its transpose equal to
    numpy's on the 8B's ``w13`` codes and scales; the host times of both
    beside their plain versions (median of 5, the host's CPU count beside)."""
    import numpy as np

    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.testing import qwen3_config
    from qwen3_rs_tpu_torch.utils import native

    t0 = time.perf_counter()
    need(native.load_library() is not None, "the port's host helper did not load (no C++ compiler?)")
    maps = Path("/proc/self/maps").read_text()
    need(str(native.lib_path()) in maps, f"{native.lib_path()} is not mapped")
    need(str(ROOT / "csrc") + "/" not in maps, "a library of the repo root's csrc/ (not the port's) is mapped")
    cfg = qwen3_config("8b")
    root = ctx["tmp"] / "native"
    root.mkdir(exist_ok=True)
    write_tokenizer(root / "tokenizer.bin", cfg.vocab_size)
    tok = Tokenizer(root, cfg.vocab_size)
    need(tok._native_encoder() is not None, "the tokenizer did not take the native encoder")
    texts = [prompt_text(n) for n in (0, 40, 200, 3000)] + ["<|im_start|>user\nhi<|im_end|>", "é [300] <x> é"]
    for t in texts:
        need(tok.encode(t) == tok._encode_py(t), f"native encode differs from Python's on {t[:40]!r}")
    long = prompt_text(3000)
    encode = {"chars": len(long), "native_ms": _host_ms(lambda: tok.encode(long)),
              "python_ms": _host_ms(lambda: tok._encode_py(long))}
    rng = np.random.default_rng(SEED)
    out_dim, in_dim = NATIVE_W13
    arrays = {"codes": rng.integers(-128, 128, NATIVE_W13, dtype=np.int8),
              "scales": rng.random((out_dim, in_dim // 64), dtype=np.float32)}
    transpose = {}
    for name, a in arrays.items():
        want = np.ascontiguousarray(np.swapaxes(a, -1, -2))
        need(np.array_equal(native.native_transpose(a), want), f"the native transpose of w13's {name} differs from numpy's")
        transpose[name] = {"shape": list(a.shape), "dtype": str(a.dtype), "bytes": a.nbytes,
                           "native_ms": _host_ms(lambda: native.native_transpose(a)),
                           "numpy_ms": _host_ms(lambda: np.ascontiguousarray(np.swapaxes(a, -1, -2)))}
    res = {"library": native.lib_path().name, "host_cpus": os.cpu_count(), "encode": encode, "transpose_w13": transpose,
           "calls": dict(native.CALLS), "seconds": time.perf_counter() - t0}
    ctx["native"] = res
    emit({"phase": "native", **res})


# ------------------------------------------------------------------ cli/parity
def small_model(ctx):
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    if "small" not in ctx:
        cfg = qwen3_config("8b", seq_len=4096, n_layers=2)
        ctx["small"] = (cfg, random_weights(cfg, seed=SEED + 1, device=DEV))
    return ctx["small"]


def phase_cli(torch, ctx) -> None:
    from qwen3_rs_tpu_torch import Engine, Tokenizer, TokenSampler, chat, generate
    from qwen3_rs_tpu_torch.cli import main as cli_main
    from qwen3_rs_tpu_torch.utils import native as host_helper

    cfg, weights = small_model(ctx)
    root = ctx["tmp"] / "m.qtpu"
    t0 = time.perf_counter()
    write_qtpu(root, cfg, weights)
    write_tokenizer(root / "tokenizer.bin", cfg.vocab_size)
    write_templates(root)
    emit({"phase": "cli", "checkpoint_write_seconds": time.perf_counter() - t0})
    # (case, ctx, prompt, flags, engine mode)
    cases = [
        ("generate", 128, prompt_text(40), ["-m", "generate", "-t", "0", "-s", "5"], "fast"),
        ("chat", 128, prompt_text(20), ["-m", "chat", "-y", "sys", "-t", "0.8", "-s", "3"], "fast"),
        ("generate exact", 512, prompt_text(200),
         ["-m", "generate", "-t", "0", "-s", "5", "--engine-mode", "exact"], "exact"),
        ("generate device-sampling", 128, prompt_text(40),
         ["-m", "generate", "-t", "0", "-s", "5", "--device-sampling"], "fast"),
    ]
    host_calls = dict.fromkeys(host_helper.CALLS, 0)  # the host helper's calls inside the CLI runs
    for case, ctx_len, prompt, flags, mode in cases:
        buf = io.StringIO()
        t0 = time.perf_counter()
        before = dict(host_helper.CALLS)
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["inference", str(root), "-c", str(ctx_len), "-i", prompt, *flags])
        need(rc == 0, f"cli {case} exited {rc}")
        for k in host_calls:
            host_calls[k] += host_helper.CALLS[k] - before[k]
        cli_out = buf.getvalue()
        # The same run through the API on the same weights.
        eng = Engine(config=cfg, weights=weights, ctx_length=ctx_len, mode=mode, device=DEV)
        tok = Tokenizer(root, cfg.vocab_size)
        api = io.StringIO()
        if case.startswith("generate"):
            generate(eng, tok, TokenSampler(0.0, 0.9, 5), prompt, out=api)
        else:
            chat(eng, tok, TokenSampler(0.8, 0.9, 3), prompt, "sys", out=api)
        need(cli_out == api.getvalue(), f"cli {case} output differs from the API's")
        emit({"phase": "cli", "mode": case, "chars_out": len(cli_out),
              "equal_to_api": True, "seconds": time.perf_counter() - t0})
    # The CLI's tokenizer and loader (the classifier's transpose) took the host helper.
    need(host_calls["encode"] > 0 and host_calls["transpose"] > 0, f"cli: host helper calls {host_calls}")
    emit({"phase": "cli", "host_helper_calls": host_calls})

    # eval-ppl through the CLI against the API, at a 600-row window.
    import numpy as np

    from qwen3_rs_tpu_torch import evaluate_checkpoint

    text = ctx["tmp"] / "eval.txt"
    text.write_text(prompt_text(1500))
    modes = "fast,exact,f32"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["eval-ppl", str(root), "-f", str(text), "--modes", modes, "-w", "600"])
    need(rc == 0, f"cli eval-ppl exited {rc}")
    got = json.loads(buf.getvalue())
    api = evaluate_checkpoint(root, text=text.read_text(), modes=tuple(modes.split(",")), window=600)
    for m, r in api.items():
        need(got[m]["tokens"] == r.n_tokens and np.isclose(got[m]["perplexity"], r.perplexity, rtol=1e-6, atol=0),
             f"cli eval-ppl {m}: {got[m]} != {r}")
    need(set(got["fast"]) == {"perplexity", "avg_nll", "tokens", "ppl_delta_vs_f32"}, f"eval-ppl keys {got}")
    emit({"phase": "cli", "mode": "eval-ppl", "window": 600, "result": got, "equal_to_api_rtol": 1e-6,
          "seconds": time.perf_counter() - t0})
    cli_batch(torch, ctx, root, cfg, weights)
    cli_serve(torch, ctx, root, cfg, weights)
    cli_export(torch, ctx)


def cli_export(torch, ctx) -> None:
    """``export`` of a synthetic HF directory to an INT4 ``.qtpu`` and an
    INT8 legacy ``.bin``; ``inference -m generate`` on each, its output equal
    to the API's (the INT4 one through the Q4 kernels); ``batch`` once on the
    INT4 checkpoint."""
    from qwen3_rs_tpu_torch import Engine, Tokenizer, TokenSampler, generate
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.cli import main as cli_main
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    model = write_hf_model(ctx["tmp"] / "hf", SEED + 8)
    prompt = prompt_text(60)
    for name, flags, q4 in (("q4.qtpu", ["--bits", "4"], True), ("m8.bin", ["--format", "legacy"], False)):
        ckpt = ctx["tmp"] / name
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["export", str(model), str(ckpt), "-g", "64", *flags])
        need(rc == 0, f"cli export {name} exited {rc}")
        export_s = time.perf_counter() - t0
        buf = io.StringIO()
        reset_launches()  # this path's run starts here
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["inference", str(ckpt), "-m", "generate", "-i", prompt, "-t", "0", "-s", "5"])
        launches = dict(LAUNCHES)  # and ends here
        ctx["path_launches"][f"cli_export_{name}"] = launches
        need(rc == 0, f"cli inference on the exported {name} exited {rc}")
        key = w8a16_key(1, q4)
        need(launches[key] > 0 and (launches[w8a16_key(1, True)] == 0) == (not q4), f"cli {name}: launched {launches}")
        cfg, weights = load_checkpoint(ckpt)
        need(cfg.weight_bits == (4 if q4 else 8), f"{name}: weight_bits {cfg.weight_bits}")
        api = io.StringIO()
        generate(Engine(checkpoint=ckpt, device=DEV), Tokenizer(ckpt, cfg.vocab_size), TokenSampler(0.0, 0.9, 5),
                 prompt, out=api)
        need(buf.getvalue() == api.getvalue() and len(api.getvalue()) > len(prompt),
             f"cli inference on the exported {name} differs from the API's")
        emit({"phase": "cli", "mode": f"export {' '.join(flags)} + inference generate", "checkpoint": name,
              "export_s": export_s, "chars_out": len(api.getvalue()), "equal_to_api": True, "launches": launches})
        if q4:
            cli_batch(torch, ctx, ckpt, cfg, weights, kvs=("paged",))
        # ``batch`` with its defaults (device sampling, dense slots); the INT4
        # twin with the Q4 megakernel opted in.
        with q4_megakernel_opt_in(q4):
            cli_batch(torch, ctx, ckpt, cfg, weights, kvs=("dense",), sampling=None)


def cli_batch(torch, ctx, root, cfg, weights, kvs=("paged", "dense"), sampling="host") -> None:
    """``batch --sampling host`` (``sampling`` None: no flag, the default
    device sampling) on the paged pool and on the dense slots: its JSON lines
    equal the API's on the same requests, and the dense decode steps take
    the megakernel where its gate admits the shapes."""
    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.cli import main as cli_main
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.ops.kernels.megakernel import megakernel_supported
    from qwen3_rs_tpu_torch.ops.quant import Q4Tensor
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

    prompts = [prompt_text(n) for n in (30, 200, 5, 700, 90)]
    pfile = ctx["tmp"] / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n")
    tok = Tokenizer(root, cfg.vocab_size)
    q4 = isinstance(weights.layers.wqkv, Q4Tensor)
    flags = [] if sampling is None else ["--sampling", sampling]
    for kv in kvs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        reset_launches()  # this path's run starts here
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["batch", str(root), "-f", str(pfile), "-n", "12", "-s", "3", *flags,
                           "--slots", "4", "--kv", kv])
        launches = dict(LAUNCHES)  # and ends here
        need(rc == 0, f"cli batch --kv {kv} exited {rc}")
        gate = kv == "dense" and megakernel_supported(cfg, cfg.seq_len, torch.bfloat16, 4, q4=q4)
        mk = "decode_megakernel_q4" if q4 else "decode_megakernel"
        need((launches[mk] > 0) == gate, f"cli batch --kv {kv}: gate {gate}, launched {launches}")
        engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=4, kv_layout=kv, device=DEV,
                                          sampling=sampling or "device", seed=3)
        for i, p in enumerate(prompts):
            engine.submit(Request(i, tok.encode(p), max_new_tokens=12, seed=3 + i,
                                  eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
        done = sorted(engine.run(), key=lambda r: r.request_id)
        api = "".join(json.dumps({"id": r.request_id, "prompt": prompts[r.request_id],
                                  "completion": tok.decode(r.generated), "tokens": len(r.generated),
                                  "finish_reason": r.finish_reason}) + "\n" for r in done)
        need(buf.getvalue() == api, f"cli batch --kv {kv}: output differs from the API's")
        ctx["path_launches"][f"cli_batch_{root.name}_{kv}_{sampling or 'default'}"] = launches
        emit({"phase": "cli", "mode": f"batch --kv {kv} " + (" ".join(flags) or "(default sampling: device)"),
              "checkpoint": root.name, "dim": cfg.dim, "megakernel_gate": gate, "requests": len(done),
              "equal_to_api": True, "launches": launches, "seconds": time.perf_counter() - t0})


def cli_serve(torch, ctx, root, cfg, weights) -> None:
    """``serve`` with its defaults (device sampling, the paged pool) in a
    process of its own: a completion over HTTP equals the API's run of the
    same request; the process is stopped."""
    import urllib.request

    from qwen3_rs_tpu_torch import Tokenizer
    from qwen3_rs_tpu_torch.parallel.distributed import free_port
    from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

    port = free_port()
    t0 = time.perf_counter()
    log = open(ctx["tmp"] / "serve.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(root),
                             "--port", str(port), "--slots", "4"], cwd=ROOT, stdout=log, stderr=log)
    try:
        ready_s = _wait_health(proc, port, ctx["tmp"] / "serve.log", "cli serve")
        prompt = prompt_text(150)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                     data=json.dumps({"prompt": prompt, "max_tokens": 16}).encode(),
                                     headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=300).read())
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        log.close()
    tok = Tokenizer(root, cfg.vocab_size)
    engine = ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=4, kv_layout="paged", sampling="device",
                                      device=DEV)
    engine.submit(Request(0, tok.encode(prompt), max_new_tokens=16, eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
    solo = engine.run()[0]
    need(body["text"] == tok.decode(solo.generated) and body["tokens"] == len(solo.generated),
         "cli serve: the completion differs from the API's")
    emit({"phase": "cli", "mode": "serve", "ready_s": ready_s, "tokens": body["tokens"], "equal_to_api": True,
          "seconds": time.perf_counter() - t0})


def phase_parity(torch, ctx) -> None:
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.models.qwen3 import weights_to

    cfg, weights = small_model(ctx)
    t0 = time.perf_counter()
    card = Engine(config=cfg, weights=weights, device=DEV)
    cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, 16))
    tol_rel = 2e-2  # f32 sums in another order can flip a bf16 rounding of the residual stream
    caches = [card.new_cache(1), cpu.new_cache(1)]
    lc, caches[0] = card.prefill(caches[0], prompt, np.zeros(1, np.int64))
    lp, caches[1] = cpu.prefill(caches[1], prompt, np.zeros(1, np.int64))
    errs, agree = [], 0
    pos = prompt.shape[1]
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    mk_before = LAUNCHES["decode_megakernel"]
    for step in range(9):
        a, b = lc.float().cpu(), lp.float()
        need(a.shape == b.shape == (1, cfg.vocab_size) and bool(torch.isfinite(a).all()),
             "card logits malformed")
        err = float((a - b).abs().max()) / float(b.abs().max())
        errs.append(err)
        need(err <= tol_rel, f"card vs CPU step {step}: rel err {err} > {tol_rel}")
        nxt = int(b.argmax())
        agree += int(a.argmax()) == nxt
        if step == 8:
            break
        lc, caches[0] = card.decode_step(caches[0], [nxt], [pos])
        lp, caches[1] = cpu.decode_step(caches[1], [nxt], [pos])
        pos += 1
    need(LAUNCHES["decode_megakernel"] - mk_before == 8, "card decode steps did not take the megakernel")
    emit({"phase": "parity", "layers": cfg.n_layers, "width": cfg.dim, "steps": 1 + 8, "decode_via": "megakernel",
          "max_rel_err": max(errs), "tol_rel": tol_rel, "argmax_agree": agree,
          "seconds": time.perf_counter() - t0})
    parity_long_windows(torch, ctx)
    parity_eval(torch, ctx)
    parity_paged(torch, ctx)
    parity_gated_shapes(torch, ctx)
    for hd in (256, 512, 640):
        parity_head_dim(torch, ctx, hd)


def parity_gated_shapes(torch, ctx) -> None:
    """Card against CPU on shapes at the JAX gates' edges, each 2 layers at
    small widths (a 300-row fresh window, a 20-row window and two decode
    steps): a head_dim-64 Llama, which the gates refuse, on the plain path
    with no launch of the refused kernels (flash decode, causal prefill, the
    megakernel); and shapes they admit that the port's kernels once refused,
    through the kernels: INT4 with 512-row groups (Q4 #3; not the Q4
    megakernel, whose gate refuses the group, opted in or not) and 5 query
    heads per kv head (#4 and #5)."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.configuration import ModelConfig
    from qwen3_rs_tpu_torch.models.qwen3 import weights_to
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import random_weights

    common = dict(n_layers=2, seq_len=512, vocab_size=4096)
    cases = (
        ("head_dim 64 (Llama)", ModelConfig(architecture_id=2, dim=256, hidden_dim=768, n_heads=4, n_kv_heads=2,
                                           head_dim=64, group_size=64, shared_classifier=False, use_qk_norm=False,
                                           **common), 8,
         {"flash_decode": False, "causal_prefill_attention": False, "decode_megakernel": False}),
        ("INT4 g512", ModelConfig(architecture_id=1, dim=1024, hidden_dim=3072, n_heads=4, n_kv_heads=2, head_dim=128,
                                  group_size=512, shared_classifier=True, **common), 4,
         {w8a16_key(1, True): True, "decode_megakernel_q4": False}),
        ("kv_mul 5", ModelConfig(architecture_id=1, dim=1024, hidden_dim=3072, n_heads=10, n_kv_heads=2, head_dim=128,
                                 group_size=64, shared_classifier=True, **common), 8,
         {"flash_decode": True, "causal_prefill_attention": True}),
    )
    for name, cfg, bits, want in cases:
        t0 = time.perf_counter()
        weights = random_weights(cfg, seed=SEED + 11, device=DEV, bits=bits)
        engines = [Engine(config=cfg, weights=weights, device=DEV),
                   Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")]
        caches = [e.new_cache() for e in engines]
        rng = np.random.default_rng(SEED + 11)
        errs, pos = [], 0
        with q4_megakernel_opt_in():
            reset_launches()  # this path's run starts here
            for rows in (300, 20, 1, 1):
                toks = rng.integers(0, cfg.vocab_size, (1, rows))
                lc, caches[0] = engines[0].prefill(caches[0], toks, [pos])
                lp, caches[1] = engines[1].prefill(caches[1], toks, [pos])
                errs.append(float((lc.float().cpu() - lp.float()).abs().max()) / float(lp.float().abs().max()))
                pos += rows
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)  # and ends here
        ctx["path_launches"][f"gated {name}"] = launches
        need({k: launches[k] > 0 for k in want} == want, f"{name}: launches {launches}, expected {want}")
        need(all(math.isfinite(e) and e <= 2e-2 for e in errs), f"{name}: card vs CPU rel errs {errs}")
        emit({"phase": "parity", "run": f"gated shapes: {name}", "rel_errs": errs, "tol_rel": 2e-2,
              "expected_launched": want, "launches": {k: v for k, v in launches.items() if v},
              "seconds": time.perf_counter() - t0})


def parity_head_dim(torch, ctx, hd: int) -> None:
    """Card against CPU on a 2-layer model of head_dim ``hd`` (256, 512 for
    #5's wide kernel, 640 for the column-blocked and streaming kernels past
    512; dim 1024, 8 query and 4 kv heads), within 2e-2 of
    the largest logit: on the dense cache a 300-row fresh window (#5) and two
    decode steps (#4); on a page pool a fresh group window, a continued 8-row
    window (#10) and two decode steps (#9).  Each of the four kernels must
    launch."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.configuration import ModelConfig
    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, qwen3_forward, weights_to
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache
    from qwen3_rs_tpu_torch.testing import random_weights

    t0 = time.perf_counter()
    cfg = ModelConfig(architecture_id=1, dim=1024, hidden_dim=3072, n_layers=2, n_heads=8, n_kv_heads=4,
                      head_dim=hd, seq_len=1024, vocab_size=4096, group_size=64, shared_classifier=True)
    weights = random_weights(cfg, seed=SEED + 13, device=DEV)
    cpu_weights = weights_to(weights, "cpu")
    rng = np.random.default_rng(SEED + 13)
    errs = []
    reset_launches()  # this path's run starts here
    engines = [Engine(config=cfg, weights=weights, device=DEV), Engine(config=cfg, weights=cpu_weights, device="cpu")]
    caches = [e.new_cache() for e in engines]
    pos = 0
    for rows in (300, 1, 1):
        toks = rng.integers(0, cfg.vocab_size, (1, rows))
        (lc, caches[0]), (lp, caches[1]) = (e.prefill(c, toks, [pos]) for e, c in zip(engines, caches))
        errs.append(float((lc.float().cpu() - lp.float()).abs().max()) / float(lp.float().abs().max()))
        pos += rows
    ws = [cast_weight_scales(weights), cast_weight_scales(cpu_weights)]
    pools = [init_paged_cache(cfg, 9, 128, device=d) for d in (DEV, "cpu")]
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    pos = np.array([0, 0])
    for rows, fresh in ((40, True), (8, False), (1, False), (1, False)):
        toks = rng.integers(0, cfg.vocab_size, (2, rows))
        lc, lp = (qwen3_forward(cfg, w, toks, pool, pos, page_table=table, fresh_prefill=fresh)[0]
                  for w, pool in zip(ws, pools))
        errs.append(float((lc.float().cpu() - lp).abs().max()) / float(lp.abs().max()))
        pos = pos + rows
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)  # and ends here
    ctx["path_launches"][f"parity head_dim {hd}"] = launches
    want = ("flash_decode", "causal_prefill_attention", "paged_decode", "paged_window_partials")
    need(all(launches[k] > 0 for k in want), f"head_dim {hd}: launches {launches}")
    need(all(math.isfinite(e) and e <= 2e-2 for e in errs), f"head_dim {hd}: card vs CPU rel errs {errs}")
    emit({"phase": "parity", "run": f"head_dim {hd}", "layers": cfg.n_layers, "width": cfg.dim, "rel_errs": errs,
          "tol_rel": 2e-2, "launches": {k: launches[k] for k in want}, "seconds": time.perf_counter() - t0})


def parity_paged(torch, ctx) -> None:
    """Card against CPU on the 2-layer 8B-width model over a shuffled page
    pool (bf16 and INT8): a fresh group prefill of 3 requests (300, 200 and
    a padding row), a continued 32-row window (the paged window kernel on
    the card), 3 decode steps (the paged decode kernel) with one slot idle."""
    import numpy as np

    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, qwen3_forward, weights_to
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache

    cfg, weights = small_model(ctx)
    card_w = cast_weight_scales(weights)
    cpu_w = weights_to(card_w, "cpu")
    tol_rel = 2e-2  # f32 sums in another order can flip a bf16 rounding of the residual stream
    for pool_dtype in (torch.bfloat16, "int8"):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 4)
        pools = [init_paged_cache(cfg, 1 + 3 * 32, 128, dtype=pool_dtype, device=d) for d in (DEV, "cpu")]
        table = np.zeros((3, 32), np.int32)
        table[:2] = rng.permutation(np.arange(1, 1 + 3 * 32))[:64].reshape(2, 32)
        errs, made = [], {}

        def both(tokens, pos, mask, **kw):
            before = dict(LAUNCHES)
            lc, _ = qwen3_forward(cfg, card_w, tokens, pools[0], pos, page_table=table, write_mask=mask, **kw)
            torch.cuda.synchronize()
            made.update({k: made.get(k, 0) + LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]})
            lp, _ = qwen3_forward(cfg, cpu_w, tokens, pools[1], pos, page_table=table, write_mask=mask, **kw)
            a, b = lc.float().cpu()[:2], lp.float()[:2]
            need(bool(torch.isfinite(a).all()), "paged parity: card logits are not finite")
            errs.append(float((a - b).abs().max()) / float(b.abs().max()))
            return b

        both(rng.integers(0, cfg.vocab_size, (3, 300)), [0, 0, 0], np.array([1, 1, 0], bool),
             fresh_prefill=True, out_idx=[299, 199, 0])
        pos = np.array([300, 200, 0])
        lp = both(rng.integers(0, cfg.vocab_size, (3, 32)), pos, np.array([1, 1, 0], bool))
        pos = pos + [32, 32, 0]
        for _ in range(3):
            tok = np.concatenate([lp.argmax(-1).numpy(), [0]])[:, None]
            lp = both(tok, pos, np.array([1, 0, 0], bool))
            pos = pos + [1, 0, 0]
        n = cfg.n_layers
        need(made.get("paged_window_partials") == n and made.get("paged_decode") == 3 * n
             and made.get("causal_prefill_attention") == n, f"paged parity launched {made}")
        need(all(math.isfinite(e) and e <= tol_rel for e in errs), f"card vs CPU paged {pool_dtype}: {errs}")
        emit({"phase": "parity", "run": f"paged {'int8' if pool_dtype == 'int8' else 'bf16'}", "layers": n, "width": cfg.dim,
              "windows": [300, 32], "decode_steps": 3, "rel_errs": errs, "tol_rel": tol_rel, "launches": made,
              "seconds": time.perf_counter() - t0})


def parity_long_windows(torch, ctx) -> None:
    """Card against CPU on the 2-layer 8B-width model: a fresh 512-row window
    and a 300-row continuation in fast mode (causal prefill and row-blocked
    kernels on the card), a 256-row exact window (W8A8 kernel), 3 decode
    steps after each."""
    import numpy as np

    from qwen3_rs_tpu_torch import Engine
    from qwen3_rs_tpu_torch.models.qwen3 import weights_to

    cfg, weights = small_model(ctx)
    cpu_weights = weights_to(weights, "cpu")
    rng = np.random.default_rng(SEED + 2)
    # Fast: an f32 sum in another order can flip a bf16 rounding of the residual
    # stream; exact: it can flip an activation's int8 code.
    tol_rel = 2e-2
    for mode, windows in (("fast", (512, 300)), ("exact", (256,))):
        t0 = time.perf_counter()
        card = Engine(config=cfg, weights=weights, mode=mode, device=DEV)
        cpu = Engine(config=cfg, weights=cpu_weights, mode=mode, device="cpu")
        caches = [card.new_cache(1), cpu.new_cache(1)]
        pos, errs = 0, []
        for rows in windows:
            prompt = rng.integers(0, cfg.vocab_size, (1, rows))
            lc, caches[0] = card.prefill(caches[0], prompt, [pos])
            lp, caches[1] = cpu.prefill(caches[1], prompt, [pos])
            pos += rows
            errs.append(float((lc.float().cpu() - lp).abs().max()) / float(lp.abs().max()))
        for step in range(3):
            nxt = int(lp.argmax())
            lc, caches[0] = card.decode_step(caches[0], [nxt], [pos + step])
            lp, caches[1] = cpu.decode_step(caches[1], [nxt], [pos + step])
            errs.append(float((lc.float().cpu() - lp).abs().max()) / float(lp.abs().max()))
        need(all(math.isfinite(e) and e <= tol_rel for e in errs), f"card vs CPU {mode} long windows: {errs}")
        emit({"phase": "parity", "mode": mode, "layers": cfg.n_layers, "width": cfg.dim,
              "windows": list(windows), "decode_steps": 3, "rel_errs": errs, "tol_rel": tol_rel,
              "seconds": time.perf_counter() - t0})


def parity_eval(torch, ctx) -> None:
    """eval-ppl on the card against the CPU: a 2-layer 0.6B-width model,
    two 512-row windows, fast and exact."""
    import numpy as np

    from qwen3_rs_tpu_torch.evaluation import compute_perplexity
    from qwen3_rs_tpu_torch.models.qwen3 import weights_to
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

    cfg = qwen3_config("0.6b", seq_len=512, n_layers=2)
    weights = random_weights(cfg, seed=SEED + 3, device=DEV)
    cpu_weights = weights_to(weights, "cpu")
    tokens = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, 900).tolist()
    # Rounding flips of single logits average out over 899 tokens.  Random
    # weights give large logits and NLLs; the NLL is compared, which the
    # perplexity exponentiates.
    tol_rel = 2e-3
    for mode in ("fast", "exact"):
        t0 = time.perf_counter()
        a = compute_perplexity(cfg, weights, tokens, mode=mode)
        b = compute_perplexity(cfg, cpu_weights, tokens, mode=mode)
        rel = abs(a.avg_nll - b.avg_nll) / abs(b.avg_nll)
        need(math.isfinite(a.avg_nll) and a.n_tokens == b.n_tokens and rel <= tol_rel,
             f"eval-ppl {mode} card {a} vs CPU {b}")
        emit({"phase": "parity", "run": f"eval-ppl {mode}", "width": cfg.dim, "layers": cfg.n_layers,
              "window": 512, "tokens": a.n_tokens, "card_avg_nll": a.avg_nll, "cpu_avg_nll": b.avg_nll,
              "rel_err": rel, "tol_rel": tol_rel, "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES + OPTIONAL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import qwen3_rs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions compare in full f32
    torch.backends.cudnn.allow_tf32 = False

    tmp = ROOT / ".smoke_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    ctx = {"tmp": tmp, "copy_gbps": float("nan"), "path_launches": {}}
    t_all = time.perf_counter()
    try:
        if "build" not in phases:
            from qwen3_rs_tpu_torch.ops.kernels import build

            build.build()
        for name in PHASES + OPTIONAL_PHASES:
            if name not in phases:
                continue
            t0 = time.perf_counter()
            if name == "build":
                phase_build(torch, ctx)
            elif name == "kernels":
                phase_kernels(torch, ctx)
            elif name == "probes":
                phase_probes(torch, ctx)
            else:
                {"e2e": phase_e2e, "serve": phase_serve, "spec": phase_spec, "cli": phase_cli, "tp": phase_tp,
                 "replicas": phase_replicas, "gateway": phase_gateway, "pp": phase_pp, "sp": phase_sp,
                 "scaling": phase_scaling, "native": phase_native, "parity": phase_parity, "exact": phase_exact,
                 "decode": phase_decode, "window": phase_window, "heads": phase_heads}[name](torch, ctx)
            emit({"phase": name, "done": True, "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    paths = ctx.get("path_launches", {})
    launches = {name: sum(p.get(name, 0) for p in paths.values()) for name in
                {r["name"] for r in ctx.get("kernel_rows", [])}}
    if {"kernels", "e2e", "serve"} <= set(phases):
        # #6's column window runs on the tensor-parallel path alone, the probe kernels on the probes'.
        idle = sorted(name for name, n in launches.items()
                      if n == 0 and (name != "qmatmul_w8a16_rows_cols" or "tp" in phases)
                      and (name not in PROBE_KERNELS or "probes" in phases))
        need(not idle, f"no path launched {idle}")
    rows = [dict(r, launches=launches[r["name"]]) for r in ctx.get("kernel_rows", [])]
    emit({"kernels": rows, "e2e": ctx.get("e2e"), "serve": ctx.get("serve"), "spec": ctx.get("spec"),
          "tp": ctx.get("tp"), "replicas": ctx.get("replicas"), "gateway": ctx.get("gateway"), "pp": ctx.get("pp"),
          "sp": ctx.get("sp"), "scaling": ctx.get("scaling"), "native": ctx.get("native"), "probes": ctx.get("probes"),
          "decode": ctx.get("decode"), "window": ctx.get("window"),
          "total_seconds": time.perf_counter() - t_all})
    print(ctx.get("smi") or subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
