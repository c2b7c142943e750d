"""The device-memory read rate a kernel can reach on the card.

    python -m qwen3_rs_tpu_torch.scripts.hbm_stream_bench [GB] [block_mb ...]

The port's counterpart of ``scripts/hbm_stream_bench.py`` (defaults 4.0 GB;
blocks of 0.5 1 2 4 MB).  An int8 array of about ``GB`` gigabytes, rows of
8192 bytes, whole blocks of ``block_mb`` megabytes (the reference probe's
sizes), is summed byte by byte by ``hbm_stream``, each block of the launch
streaming one such block; the sum must equal ``torch.sum(x, dtype=int64)``,
which is also timed on the same array as the library's yardstick.

Timing: the slope between three launches and one, each timed by the median
of CUDA events after warm-up, as the reference probe takes the slope between
three passes and one: the host's cost of issuing the first launch cancels.
Printed: GB/s per block size and its share of the data sheet's 3.35 TB/s, then
the best.
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernels.probes import hbm_stream
from . import HBM_BYTES_PER_S, card, card_line, generator, slope_ms

LANES = 8192  # bytes of a row


def geometry(total_gb: float, block_mb: float) -> tuple[int, int, int]:
    """(rows per block, blocks, array rows) as the reference probe sizes them."""
    rows = int(block_mb * 1e6) // LANES
    rows = max(8, rows - rows % 8)
    n_blocks = int(total_gb * 1e9 / (rows * LANES))
    return rows, n_blocks, n_blocks * rows


def run(total_gb: float = 4.0, block_mbs=(0.5, 1.0, 2.0, 4.0), repeat: int = 5, device="cuda",
        seed: int = 0) -> dict:
    dev = card(device)
    shapes = {mb: geometry(total_gb, mb) for mb in block_mbs}
    n_max = max(arr_rows for _, _, arr_rows in shapes.values()) * LANES
    x = torch.empty(n_max, dtype=torch.int8, device=dev).random_(-128, 128, generator=generator(dev, seed))
    blocks = []
    for mb, (rows, n_blocks, arr_rows) in shapes.items():
        view = x[: arr_rows * LANES]
        span = rows * LANES
        got = hbm_stream(view, span)
        want = view.sum(dtype=torch.int64)
        if not torch.equal(got, want):
            raise RuntimeError(f"hbm_stream block={mb} MB: sum {int(got)} != {int(want)}")
        ms = slope_ms(lambda k: [hbm_stream(view, span) for _ in range(k)], 1, 3, repeat)
        gbs = view.numel() / (ms * 1e-3) / 1e9
        blocks.append({"block_mb": mb, "rows": rows, "n_blocks": n_blocks, "bytes": view.numel(), "ms": ms,
                       "gb_per_s": gbs, "share_of_peak": gbs * 1e9 / HBM_BYTES_PER_S, "sum": int(got)})
    lib_ms = slope_ms(lambda k: [x.sum(dtype=torch.int64) for _ in range(k)], 1, 3, repeat)
    best = max(blocks, key=lambda b: b["gb_per_s"])
    return {"probe": "hbm_stream_bench", "card": card_line(), "total_gb": total_gb,
            "timing": "slope between 3 launches and 1 of CUDA-event medians", "blocks": blocks,
            "best_gb_per_s": best["gb_per_s"], "best_share_of_peak": best["share_of_peak"],
            "library": "torch.sum(x, dtype=torch.int64)", "library_bytes": x.numel(), "library_ms": lib_ms,
            "library_gb_per_s": x.numel() / (lib_ms * 1e-3) / 1e9}


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    total_gb = float(args[0]) if len(args) > 0 else 4.0
    block_mbs = [float(a) for a in args[1:]] or [0.5, 1.0, 2.0, 4.0]
    out = run(total_gb, block_mbs)
    print(out["card"], flush=True)
    for b in out["blocks"]:
        print(f"block={b['block_mb']:4.1f} MB rows={b['rows']:5d} n_blocks={b['n_blocks']:5d}: "
              f"{b['gb_per_s']:7.1f} GB/s  ({b['share_of_peak']:.3f} of the data sheet's 3.35 TB/s)", flush=True)
    print(f"best {out['best_gb_per_s']:.1f} GB/s ({out['best_share_of_peak']:.3f}); "
          f"{out['library']} {out['library_gb_per_s']:.1f} GB/s", flush=True)


if __name__ == "__main__":
    main()
