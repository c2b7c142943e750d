"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks for.
The last line of standard output is the contract's JSON object; the last
lines of standard error are the numbers the comparison read, each beside its
limit.  ``setup_s`` runs from the process's start and holds the kernel
build in a run that compiles (the first of a checkout); the line's
``build_s`` gives the build's own seconds.  Exits nonzero, with no result,
when there is no card, when the run cannot give every end-to-end metric or a
per-layer metric that lists its cell, or when JAX or the JAX package was
loaded into this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets to it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> Path:
    """Kernel and compiler caches at fixed paths inside the checkout, so that
    only the first run of a checkout builds."""
    cache = CHECKOUT / ".gpubench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    return cache


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = _cache_dirs()

    try:
        from gpubench import harness

        cell = harness.load_cell(args.workload, CHECKOUT)
        import torch

        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            _log(f"needs {chips} CUDA device(s); torch.cuda.is_available() is {torch.cuda.is_available()}, "
                 f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        from qwen3_rs_tpu_torch.ops.kernels import build
        from qwen3_rs_tpu_torch.utils import enable_compile_cache

        if enable_compile_cache(str(cache / "kernels")) is None:
            raise harness.RunError(f"cannot create {cache / 'kernels'}")
        # warmup() builds the same sources; building them first times the
        # build apart (0 once the checkout's cache holds them).
        build_s = build.build()
        _log(f"kernel build: {build_s:.3f} s of set-up")
        res = harness.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0, log=_log)
    except harness.RunError as e:
        _log(f"error: {e}")
        return 4
    bad = harness.forbidden_modules()
    if bad:
        _log(f"error: this process loaded {', '.join(bad)}: the benchmark runs the PyTorch port alone")
        return 5
    device = {"platform": "gpu", "kind": res["kind"], "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["build_s"] = build_s  # inside setup_s; 0 where the cache held every kernel
    line["checks"] = {k: {kk: (vv if not isinstance(vv, float) or math.isfinite(vv) else str(vv))
                          for kk, vv in c.items()} for k, c in res["checks"].items()}
    for name, c in res["checks"].items():
        _log(f"check {name}: {c['value']} ({'limit' if 'limit' in c else 'at least'} "
             f"{c.get('limit', c.get('min'))})")
    if any(isinstance(v["value"], float) and not math.isfinite(v["value"]) for v in res["metrics"].values()):
        _log("error: a metric is not finite (requests failed or did not finish)")
        return 6
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
