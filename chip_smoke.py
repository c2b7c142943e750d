#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``qwen3_rs_tpu_torch``).

    python3 chip_smoke.py                  # every phase, one NVIDIA GPU
    python3 chip_smoke.py --phases build,kernels

Phases, in order; any failure exits non-zero before the final line:

1. ``build``   the card's name and power limit, the CUDA version, the kernel
               build (one ``nvcc`` per source, all in parallel) and the
               device-to-device copy bandwidth on a 1 GiB buffer.
2. ``kernels`` each hand-written kernel against its plain PyTorch version on
               the same inputs at Qwen3-8B shapes (INT8-g64, bf16 scales),
               with its time, the plain version's time, one PyTorch library
               call's time and the least time the card could take.
3. ``e2e``     Qwen3-8B at full width and depth with random weights made on
               the card from a seed, driven through ``Engine``, ``generate()``
               and ``chat()``; every decode step must launch each kernel of
               the path (4·L+1 W8A16 matmuls, L flash-decode attentions), and
               two greedy runs must give the same tokens.
4. ``cli``     a 2-layer 8B-width ``.qtpu`` checkpoint written with numpy,
               run through ``qwen3_rs_tpu_torch.cli.main(["inference", ...])``
               in generate and chat mode; its output must equal the API's.
5. ``parity``  the same 2-layer model on the CPU (plain versions) and on the
               card (kernels): prefill logits and 8 teacher-forced decode
               steps must agree.

Output: one JSON object per line.  The second-to-last lines hold the kernel
table (``{"kernels": [...]}``) and the card's ``name, power.limit``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PHASES = ("build", "kernels", "e2e", "cli", "parity")

# Published peaks of one H100 SXM (dense): the denominators of bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time: keeps the host ahead of the card
SEED = 0
DECODE_TOKENS = 64  # per greedy generate run


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
        ("wqkv+rms b=256", dim, ah + 2 * kvd, "rms", False, 256, True, bf16),
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
            "name": "qmatmul_w8a16", "case": case, "route": "cuda",
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


def flash_cases(torch, ctx) -> list[dict]:
    import torch.nn.functional as F

    from qwen3_rs_tpu_torch.ops.kernels.flash_attention import flash_decode, flash_decode_plain
    from qwen3_rs_tpu_torch.testing import qwen3_config

    c = qwen3_config("8b")
    t_max, n_kv, h, hd = 4096, c.n_kv_heads, c.n_heads, c.head_dim
    kv_mul = h // n_kv
    specs = [("f32", 0), ("f32", 1), ("f32", 257), ("f32", t_max - 1), ("bf16", 2049), ("int8", 2049)]
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

        ms = device_ms(torch, lambda i: flash_decode(q, kn, vn, k_all, v_all, pos, i % nl, **sc))
        plain_ms = device_ms(
            torch, lambda i: flash_decode_plain(q, kn, vn, k_all, v_all, pos, i % nl, **sc),
            reps=10, warmup=1,
        )

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
            "source": "qwen3_rs_tpu_torch/csrc/flash_decode.cu",
            "replaces": "qwen3_rs_tpu/ops/pallas/flash_attention.py:212 flash_gqa_decode_stacked",
            "shape": {"B": 1, "heads": h, "kv_heads": n_kv, "hd": hd, "T": t_max, "pos": p},
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_ms_copy_bw": nbytes / (ctx["copy_gbps"] * 1e9) * 1e3,
            "library_ms": lib_ms, "library": "F.scaled_dot_product_attention, K/V prepared beforehand",
        })
        emit({"phase": "kernels", **out[-1]})
        del k_all, v_all, sc, ref, got
        torch.cuda.empty_cache()
    return out


def phase_kernels(torch, ctx) -> None:
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    ctx["kernel_rows"] = qmatmul_cases(torch, ctx) + flash_cases(torch, ctx)
    need(LAUNCHES != before, "the kernel cases launched no kernel")


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


def prompt_text(n_chars: int) -> str:
    words = "the quick brown fox jumps over the lazy dog while a card streams weights "
    return (words * (n_chars // len(words) + 1))[:n_chars]


# ------------------------------------------------------------------------ e2e
def phase_e2e(torch, ctx) -> None:
    from qwen3_rs_tpu_torch import Engine, Tokenizer, TokenSampler, chat, generate
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights, weight_bytes_per_decode_token

    cfg = qwen3_config("8b", seq_len=4096)
    t0 = time.perf_counter()
    weights = random_weights(cfg, seed=SEED, device=DEV)
    engine = Engine(config=cfg, weights=weights, device=DEV)
    del weights
    torch.cuda.synchronize()
    emit({"phase": "e2e", "model": "qwen3-8b INT8-g64", "layers": cfg.n_layers, "dim": cfg.dim,
          "hidden": cfg.hidden_dim, "vocab": cfg.vocab_size, "ctx": cfg.seq_len,
          "setup_seconds": time.perf_counter() - t0,
          "device_memory_gb": torch.cuda.memory_allocated() / 1e9})

    tdir = ctx["tmp"] / "tok"
    tdir.mkdir()
    write_tokenizer(tdir / "tokenizer.bin", cfg.vocab_size)
    write_templates(tdir)
    tok = Tokenizer(tdir, cfg.vocab_size)
    prompt = prompt_text(200)
    per_step = {"qmatmul_w8a16": 4 * cfg.n_layers + 1, "flash_decode": cfg.n_layers}
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
    ctx["launches"] = launches

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
    del engine, engine8
    torch.cuda.empty_cache()


def profile_decode(torch, engine, prompt_ids, steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over ``steps`` greedy
    decode steps after a prefill; device busy time against wall time, and
    the kernels that take the most device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = engine.new_cache(1)
    logits, cache = engine.prefill(cache, np.asarray([prompt_ids]), np.zeros(1, np.int64))
    pos = len(prompt_ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = engine.decode_step(cache, [int(logits.argmax())], [pos + i])
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
                "wall_ms_per_step": wall_ms / steps}
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": sum(r[1] for r in rows) / steps,
        "top": [{"kernel": k[:90], "ms_per_step": us / 1e3 / steps, "calls_per_step": n / steps}
                for us, n, k in rows[:10]],
    }


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

    cfg, weights = small_model(ctx)
    root = ctx["tmp"] / "m.qtpu"
    t0 = time.perf_counter()
    write_qtpu(root, cfg, weights)
    write_tokenizer(root / "tokenizer.bin", cfg.vocab_size)
    write_templates(root)
    emit({"phase": "cli", "checkpoint_write_seconds": time.perf_counter() - t0})
    ctx_len = 128
    cases = [
        ("generate", prompt_text(40), ["-m", "generate", "-t", "0", "-s", "5"]),
        ("chat", prompt_text(20), ["-m", "chat", "-y", "sys", "-t", "0.8", "-s", "3"]),
    ]
    for mode, prompt, flags in cases:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["inference", str(root), "-c", str(ctx_len), "-i", prompt, *flags])
        need(rc == 0, f"cli {mode} exited {rc}")
        cli_out = buf.getvalue()
        # The same run through the API on the same weights.
        eng = Engine(config=cfg, weights=weights, ctx_length=ctx_len, device=DEV)
        tok = Tokenizer(root, cfg.vocab_size)
        api = io.StringIO()
        if mode == "generate":
            generate(eng, tok, TokenSampler(0.0, 0.9, 5), prompt, out=api)
        else:
            chat(eng, tok, TokenSampler(0.8, 0.9, 3), prompt, "sys", out=api)
        need(cli_out == api.getvalue(), f"cli {mode} output differs from the API's")
        emit({"phase": "cli", "mode": mode, "chars_out": len(cli_out),
              "equal_to_api": True, "seconds": time.perf_counter() - t0})


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
    emit({"phase": "parity", "layers": cfg.n_layers, "width": cfg.dim, "steps": 1 + 8,
          "max_rel_err": max(errs), "tol_rel": tol_rel, "argmax_agree": agree,
          "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
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
    ctx = {"tmp": tmp, "copy_gbps": float("nan")}
    t_all = time.perf_counter()
    try:
        if "build" not in phases:
            from qwen3_rs_tpu_torch.ops.kernels import build

            build.build()
        for name in PHASES:
            if name not in phases:
                continue
            t0 = time.perf_counter()
            if name == "build":
                phase_build(torch, ctx)
            elif name == "kernels":
                phase_kernels(torch, ctx)
            else:
                {"e2e": phase_e2e, "cli": phase_cli, "parity": phase_parity}[name](torch, ctx)
            emit({"phase": name, "done": True, "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = ctx.get("launches", {})
    rows = [dict(r, launches=launches.get(r["name"], 0)) for r in ctx.get("kernel_rows", [])]
    emit({"kernels": rows, "e2e": ctx.get("e2e"), "total_seconds": time.perf_counter() - t_all})
    print(ctx.get("smi") or subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
