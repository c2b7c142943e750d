"""The W8A8-g64 question on the card: can int8 dots that must be flushed every
64 rows of depth beat one full-depth bf16 product on Hopper's tensor cores?

    python -m qwen3_rs_tpu_torch.scripts.a8_depth_probe [rows] [n] [d]

The port's counterpart of ``scripts/a8_depth_probe.py`` (defaults 2048 4096
24576, the w13 prefill shape).  x [rows, n] and w [n, d] are N(0, 9) draws
from a seeded generator, cast to bf16 or int8 (|v| <= ~16, so every int8
partial sum is exact in f32); ``a8_depth`` takes w transposed, [d, n].  No
scale work, as the reference probe:

  bf16-full   one f32 accumulator over the whole depth (the W8A16 floor)
  i8-seg64    a fresh int32 accumulator each 64 rows of depth, flushed into f32
  i8-full     int32 over each 512-deep k-tile, then flushed (the int8 ceiling)

Beside them, as yardsticks only, ``torch.matmul`` on the bf16 operands and
``torch._int_mm`` on the int8 ones.  Timing: the slope between 8 calls and 2,
each timed by the median of CUDA events after warm-up, as the reference
probe's 8 and 2 reps; printed as ms per call and TF/s, then the answer:
bf16-full's time over i8-seg64's (above 1, the flushed int8 product wins).
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernels.probes import A8_DEPTH_RTOL, A8_DEPTH_VARIANTS, a8_depth, a8_depth_plain
from . import card, card_line, generator, slope_ms


def inputs(rows: int, n: int, d: int, dev, seed: int = 0) -> dict:
    """x [rows, n] and the weight transposed, [d, n], in bf16 and int8."""
    gen = generator(dev, seed)
    x = torch.randn(rows, n, generator=gen, device=dev) * 3
    wt = torch.randn(d, n, generator=gen, device=dev) * 3
    return {"bf16": (x.to(torch.bfloat16), wt.to(torch.bfloat16)), "int8": (x.to(torch.int8), wt.to(torch.int8))}


def run(rows: int = 2048, n: int = 4096, d: int = 24576, repeat: int = 3, device="cuda", seed: int = 0) -> dict:
    dev = card(device)
    ops = inputs(rows, n, d, dev, seed)
    flops = 2.0 * rows * n * d
    variants = {}
    for v in A8_DEPTH_VARIANTS:
        x, wt = ops["bf16" if v == "bf16-full" else "int8"]
        got = a8_depth(v, x, wt)
        ref = a8_depth_plain(v, x, wt)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = A8_DEPTH_RTOL[v] * float(ref.abs().max())
        if not err <= tol:
            raise RuntimeError(f"a8_depth {v}: max_abs_err {err} > {tol}")
        del got, ref
        ms = slope_ms(lambda k: [a8_depth(v, x, wt) for _ in range(k)], 2, 8, repeat)
        variants[v] = {"ms": ms, "tf_per_s": flops / (ms * 1e-3) / 1e12, "max_abs_err": err, "tol": tol}
    library = {}
    for name, fn in (("torch.matmul bf16", lambda: torch.matmul(ops["bf16"][0], ops["bf16"][1].T)),
                     ("torch._int_mm int8", lambda: torch._int_mm(ops["int8"][0], ops["int8"][1].T))):
        ms = slope_ms(lambda k, fn=fn: [fn() for _ in range(k)], 2, 8, repeat)
        library[name] = {"ms": ms, "tf_per_s": flops / (ms * 1e-3) / 1e12}
    return {"probe": "a8_depth_probe", "card": card_line(), "rows": rows, "N": n, "D": d, "flops": flops,
            "timing": "slope between 8 calls and 2 of CUDA-event medians", "variants": variants,
            "library": library, "seg64_speedup_over_bf16": variants["bf16-full"]["ms"] / variants["i8-seg64"]["ms"]}


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    rows, n, d = (int(args[i]) if len(args) > i else dflt for i, dflt in enumerate((2048, 4096, 24576)))
    out = run(rows, n, d)
    print(out["card"], flush=True)
    print(f"rows={rows} n={n} d={d} flops/call={out['flops'] / 1e9:.1f} GF", flush=True)
    for v, r in {**out["variants"], **out["library"]}.items():
        print(f"  {v:>18}: {r['ms']:7.3f} ms/call  {r['tf_per_s']:6.1f} TF/s", flush=True)
    print(f"i8-seg64 against bf16-full: {out['seg64_speedup_over_bf16']:.3f}x", flush=True)


if __name__ == "__main__":
    main()
