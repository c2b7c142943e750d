"""Readings for a cell's limits: the program's widest gaps and the control's.

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,3 --seconds 20

For each seed, in one process (the kernels build once): a run of the cell's
driver at its load for ``--seconds``, then the reference over the samples of
its greedy and its sampled requests, in float32 (the program's gaps) and in
float8 (the control's: the gaps of the tokens the float8 reference puts
first).  One JSON line a seed.  The benchmark's own runs do not run this; ``PERF.md`` keeps the
readings each limit was set from.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gpubench import check, harness, traffic  # noqa: E402
from gpubench import weights as weight_draw  # noqa: E402
from gpubench.run import CHECKOUT, _cache_dirs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from qwen3_rs_tpu_torch.utils import enable_compile_cache

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    enable_compile_cache(str(_cache_dirs() / "kernels"))
    cell = harness.load_cell(args.workload, CHECKOUT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        w = weight_draw.draw(cell.shapes, traffic.derive_seed(seed, 1), "cuda:0", cell.shapes.tied)
        ctx = harness.Context(cell, w, seed, args.seconds, False, "cuda:0", T0)
        rec = cell.driver.run(ctx)
        ctx.release()
        picked = check.sample(rec["requests"], cell.check["sample_tokens"], seed)
        t_ref = time.perf_counter()
        g = check.gaps(w, cell.shapes, picked, control=True)
        g.update(seed=seed, workload=args.workload, counted=len(rec["requests"]),
                 reference_s=time.perf_counter() - t_ref, seed_s=time.perf_counter() - t)
        print(json.dumps(g), flush=True)
        del w, ctx, rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
