"""Profiling helpers: a ``torch.profiler`` trace around a region, and step
timing.

The port of the reference package's ``utils/profiling.py``, whose
``profile_trace`` wraps ``jax.profiler``.  Here the trace is PyTorch's: the
host's operators and, where CUDA is present, the card's kernels, written as
one Chrome trace (``trace_<pid>_<n>.json``, readable in Perfetto or
``chrome://tracing``) under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)

_TRACES = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around a region when ``log_dir``
    is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{next(_TRACES)}.json"
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)


class StepTimer:
    """Rolling per-step wall-clock stats for engine loops."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.samples.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> dict:
        if not self.samples:
            return {"steps": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "steps": n,
            "mean_ms": sum(s) / n * 1000,
            "p50_ms": s[n // 2] * 1000,
            "p99_ms": s[min(n - 1, int(n * 0.99))] * 1000,
        }
