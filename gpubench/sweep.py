"""The knee of an open-loop cell: its driver at each of a few rates.

    python3 -m gpubench.sweep --workload qwen3-8b.rag-prefill --rates 3,4,5 --seconds 40 --seed 7

One process, one run a rate (the cell's mix with ``loop.rate_per_s``
replaced).  For each rate one JSON line: the requests due in the window and
finished by its close, the queue's length at the window's open and close, the
time to first token's median over the first and the second half of the
window and its 90th percentile.  The knee is the highest rate at which the
queue and the time to first token do not grow across the window.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from gpubench import harness, readers, traffic  # noqa: E402
from gpubench import weights as weight_draw  # noqa: E402
from gpubench.run import CHECKOUT, _cache_dirs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from qwen3_rs_tpu_torch.utils import enable_compile_cache

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    enable_compile_cache(str(_cache_dirs() / "kernels"))
    cell = harness.load_cell(args.workload, CHECKOUT)
    w = weight_draw.draw(cell.shapes, traffic.derive_seed(args.seed, 1), "cuda:0", cell.shapes.tied)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.mix["loop"]["rate_per_s"] = rate
        ctx = harness.Context(cell, w, args.seed, args.seconds, False, "cuda:0", T0)
        rec = cell.driver.run(ctx)
        ctx.release()
        reqs = rec["requests"]
        mid = rec["t_open"] + args.seconds / 2
        ttft = [r.first - r.due for r in reqs if r.first is not None]
        halves = [[r.first - r.due for r in reqs if r.first is not None and (r.due < mid) == h] for h in (True, False)]
        done = sum(1 for r in reqs if r.finished and r.last <= rec["t_close"])
        run = harness.Run(cell=cell, peak=None, setup_s=0.0, window_s=rec["window_s"], tokens=rec["tokens"],
                          requests=reqs, stats0=rec["stats0"], stats1=rec["stats1"], n_slots=rec["n_slots"],
                          calls=[], trace=None, lateness_s=rec["lateness_s"])
        print(json.dumps({
            "rate_per_s": rate, "due": len(reqs), "finished_by_close": done, "queue": rec["queue"],
            "ttft_p50_ms_halves": [1e3 * statistics.median(h) if h else None for h in halves],
            "ttft_p90_ms": readers.ttft_ms(run, 0.9), "tpot_p90_ms": readers.tpot_ms(run, 0.9),
            "output_tok_s": rec["tokens"] / rec["window_s"], "ttft_max_ms": 1e3 * max(ttft) if ttft else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
