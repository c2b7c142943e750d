"""Measurement probes of the card: the port's counterparts of the reference
package's ``scripts/`` probes, each on a hand-written kernel of
``ops/kernels/probes.py`` whose result is checked by its plain version.

    python -m qwen3_rs_tpu_torch.scripts.boundary_probe [model] [mat]
    python -m qwen3_rs_tpu_torch.scripts.hbm_stream_bench [GB] [block_mb ...]
    python -m qwen3_rs_tpu_torch.scripts.head_a8_probe [B] [tn] [td]
    python -m qwen3_rs_tpu_torch.scripts.a8_depth_probe [rows] [n] [d]

Each module's ``run(..., device="cuda")`` returns its numbers as a dict
(``chip_smoke.py`` calls it); importing one runs nothing.  A probe measures
the card and raises without one.  Every printed number stands beside the
card's ``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from ..device import resolve_device

# The data sheet's device-memory rate of one H100 SXM, the denominator of a share of the peak.
HBM_BYTES_PER_S = 3.35e12


def card(device="cuda") -> torch.device:
    """The CUDA device a probe measures; raises for the CPU or without CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"a probe measures the card; {dev} is not a CUDA device")
    return dev


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# Device cycles of the sleep that queued timing puts before a call (~1 ms): the host issues the
# call while the card sleeps.
QUEUE_CYCLES = 2_000_000


def event_ms(fn, repeat: int = 5, warmup: int = 2, queued: bool = False) -> float:
    """Median device time (ms) of ``fn()``: CUDA events around each call,
    recorded as the host issues them, so a call whose launches the host
    issues slower than the card runs them is timed at the host's pace; with
    ``queued`` the start event waits behind a device sleep, so that the
    events bracket the card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeat):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slope_ms(fn_of, lo: int, hi: int, repeat: int = 5, queued: bool = False) -> float:
    """Device time (ms) of one unit of work: the slope between ``fn_of(hi)``
    and ``fn_of(lo)`` units, each timed by ``event_ms`` (the fixed cost of a
    call cancels)."""
    return (event_ms(lambda: fn_of(hi), repeat, queued=queued)
            - event_ms(lambda: fn_of(lo), repeat, queued=queued)) / (hi - lo)


def generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen
