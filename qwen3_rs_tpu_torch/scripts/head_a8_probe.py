"""The decode classifier's compute path on the card: do int8 group dots beat
dequant + bf16 dot once the weights sit in fast memory?

    python -m qwen3_rs_tpu_torch.scripts.head_a8_probe [B] [tn] [td]

The port's counterpart of ``scripts/head_a8_probe.py`` (defaults 8 4096 1536;
two tiles, groups of 64).  ``head_a8`` cuts the tiles into units of 16
columns by one 64-row group, spreads them over every SM, keeps each block's
units resident in shared memory and sweeps them, three ways:

  deq-dot   bf16(code · bf16(scale)) then a bf16 product (the head phase today)
  i8-seg    an int8 dot per 64-row group, then an f32 fixup: × w-scale row × x-scale column
  i8-seg2   the same with the x-scale folded beforehand: × w-scale row only

Timing: the slope between launches of 128 and 32 tile sweeps (CUDA-event
medians, each launch queued behind a device sleep so that the host's issue
of a short launch is not what the events time), so loading the tiles into
shared memory cancels: µs per tile and the weight bytes per second it
would take to feed that rate from device memory.  Beside them, the time to stream one [tn, td] int8 tile at the read
rate ``hbm_stream`` measured (``stream_gb_per_s``; measured here on 1 GB when
not given): whether the compute path or the bytes bound the head.
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernels.probes import HEAD_A8_GROUP, HEAD_A8_RTOL, HEAD_A8_VARIANTS, head_a8, head_a8_plain
from . import card, card_line, generator, slope_ms

N_TILES = 2  # two resident tiles, as the reference probe


def inputs(b: int, tn: int, td: int, dev, seed: int = 0) -> dict:
    """The probe's operands, drawn from a seeded generator on ``dev``."""
    gen = generator(dev, seed)
    tg = tn // HEAD_A8_GROUP

    def codes(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-127, 128, generator=gen)

    return {"x": torch.randn(b, tn, generator=gen, device=dev).to(torch.bfloat16), "xq": codes(b, tn),
            "xs": torch.rand(b, tg, generator=gen, device=dev) * 0.01 + 0.001, "w": codes(N_TILES, tn, td),
            "s": torch.rand(N_TILES, tg, td, generator=gen, device=dev) * 0.01 + 0.001}


def run(b: int = 8, tn: int = 4096, td: int = 1536, stream_gb_per_s: float | None = None, repeat: int = 5,
        device="cuda", seed: int = 0) -> dict:
    dev = card(device)
    ops = inputs(b, tn, td, dev, seed)
    lo = N_TILES * 16
    variants = {}
    for v in HEAD_A8_VARIANTS:
        got = head_a8(v, **ops)
        ref = head_a8_plain(v, **ops)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), HEAD_A8_RTOL[v] * float(ref.abs().max())
        if not err <= tol:
            raise RuntimeError(f"head_a8 {v}: max_abs_err {err} > {tol}")
        ms = slope_ms(lambda sweeps, v=v: head_a8(v, **ops, sweeps=sweeps), lo, 4 * lo, repeat, queued=True)
        variants[v] = {"us_per_tile": ms * 1e3, "weight_stream_gb_per_s": tn * td / (ms * 1e-3) / 1e9,
                       "max_abs_err": err, "tol": tol}
    if stream_gb_per_s is None:
        from .hbm_stream_bench import run as stream_run

        stream_gb_per_s = stream_run(1.0, (2.0,), repeat, dev)["best_gb_per_s"]
    return {"probe": "head_a8_probe", "card": card_line(), "B": b, "TN": tn, "TD": td, "n_tiles": N_TILES,
            "g": HEAD_A8_GROUP, "timing": f"slope between {4 * lo} and {lo} sweeps of CUDA-event medians, each launch queued behind a device sleep",
            "variants": variants, "stream_gb_per_s": stream_gb_per_s,
            "hbm_us_per_tile": tn * td / (stream_gb_per_s * 1e9) * 1e6}


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    b, tn, td = (int(args[i]) if len(args) > i else dflt for i, dflt in enumerate((8, 4096, 1536)))
    out = run(b, tn, td)
    print(out["card"], flush=True)
    print(f"B={b} TN={tn} TD={td} tiles={N_TILES} (compute path only)", flush=True)
    for v, r in out["variants"].items():
        print(f"{v:10} {r['us_per_tile']:9.2f} us/tile  (weight-stream equiv {r['weight_stream_gb_per_s']:7.1f} GB/s)",
              flush=True)
    print(f"one tile from device memory at {out['stream_gb_per_s']:.1f} GB/s: {out['hbm_us_per_tile']:.2f} us",
          flush=True)


if __name__ == "__main__":
    main()
